"""The port's OpenAI-compatible HTTP server (ggml_tpu_torch.cli.server) on
the CPU, over a tiny f32 GPT-2 GGUF with a byte-level vocabulary and a chat
template, written by the port's writer: health and models, greedy
completions equal to the JAX server's text on the same file, concurrent
requests interleaved, a stream equal to the plain response, stop
sequences, the chat endpoint and its template, sampled requests, n forks
from one prefill, and the endpoints not ported yet."""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.cli import server as jserver
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu_torch.cli import server
from ggml_tpu_torch.gguf import GGUFWriter
from ggml_tpu_torch.tokenizer import bytes_to_unicode
from tests.test_torch_rules import one_thread  # noqa: F401  (the autouse fixture)

SHAPE = dict(n_vocab=256, n_ctx=128, n_embd=32, n_head=4, n_layer=2)
TEMPLATE = ("{% for m in messages %}<{{ m.role }}>{{ m.content }}{% endfor %}"
            "{% if add_generation_prompt %}<assistant>{% endif %}")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _start(state, mod):
    httpd = mod.serve(state, "127.0.0.1", _free_port())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server and the JAX server on the same file."""
    path = tmp_path_factory.mktemp("server") / "srv.gguf"
    w = GGUFWriter()
    w.add_string("general.architecture", "gpt2")
    for key, field in (("vocab_size", "n_vocab"), ("context_length", "n_ctx"), ("embedding_length", "n_embd"),
                       ("attention.head_count", "n_head"), ("block_count", "n_layer")):
        w.add_u32(f"gpt2.{key}", SHAPE[field])
    b2u = bytes_to_unicode()  # id i <-> byte i (BPE with no merges)
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_array("tokenizer.ggml.tokens", [b2u[b] for b in range(256)])
    w.add_array("tokenizer.ggml.merges", [])
    w.add_u32("tokenizer.ggml.eos_token_id", 254)
    w.add_string("tokenizer.chat_template", TEMPLATE)
    rng = np.random.default_rng(11)
    for name, p in jgpt2.init_random_params(jgpt2.GPT2Config(**SHAPE), seed=11).items():
        p = np.asarray(p)  # wider draws than the init's 0.02: fewer near-tied logits
        w.add_tensor(name, p * 5 if p.ndim == 2 else p + 0.1 * rng.standard_normal(p.shape).astype(np.float32))
    w.write(path)
    state = server.ServerState(str(path), max_batch=2, max_seq=96, cache_dtype=torch.float32, device="cpu")
    jstate = jserver.ServerState(str(path), max_batch=2, max_seq=96, cache_dtype=jnp.float32)
    (httpd, base), (jhttpd, jbase) = _start(state, server), _start(jstate, jserver)
    yield state, base, jbase, path
    for h, s in ((httpd, state), (jhttpd, jstate)):
        h.shutdown()
        s.shutdown()


def _post(base, path, body):
    req = urllib.request.Request(base + path, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_health_and_models(servers):
    _, base, _, _ = servers
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "srv.gguf"


@pytest.mark.parametrize("prompt", [[10, 20, 30, 40], "hello there"])
def test_greedy_completions_match_the_jax_server(servers, prompt):
    state, base, jbase, _ = servers
    body = {"prompt": prompt, "max_tokens": 8, "temperature": 0}
    got, want = _post(base, "/v1/completions", body), _post(jbase, "/v1/completions", body)
    assert got["choices"] == want["choices"] and got["usage"] == want["usage"]
    ids = state.model.generate(np.asarray([state.encode(prompt)]), 8)
    assert got["choices"][0]["text"] == state.decode(ids)


def test_concurrent_requests_interleave(servers):
    state, base, _, _ = servers
    prompts = [[1, 2, 3], [9, 9, 1, 7], [4, 5]]
    results = {}

    def go(i, p):
        results[i] = _post(base, "/v1/completions", {"prompt": p, "max_tokens": 6, "temperature": 0})

    ts = [threading.Thread(target=go, args=(i, p)) for i, p in enumerate(prompts)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    for i, p in enumerate(prompts):
        want = state.decode(state.model.generate(np.asarray([p]), 6))
        assert results[i]["choices"][0]["text"] == want, (p, results[i])


def _stream(base, path, body):
    req = urllib.request.Request(base + path, json.dumps(dict(body, stream=True)).encode(),
                                 {"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                if line[6:] == "[DONE]":
                    break
                chunks.append(json.loads(line[6:])["choices"][0])
    return chunks


def test_streaming_matches_nonstream(servers):
    _, base, _, _ = servers
    body = {"prompt": [5, 6, 7], "max_tokens": 6, "temperature": 0}
    chunks = _stream(base, "/v1/completions", body)
    plain = _post(base, "/v1/completions", body)["choices"][0]
    assert "".join(c["text"] for c in chunks) == plain["text"]
    assert [c["finish_reason"] for c in chunks if c["finish_reason"]] == [plain["finish_reason"]]
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 5, "temperature": 0}
    deltas = _stream(base, "/v1/chat/completions", chat)
    full = _post(base, "/v1/chat/completions", chat)["choices"][0]["message"]
    assert "".join(c["delta"].get("content", "") for c in deltas) == full["content"]


def test_stop_sequence_truncates(servers):
    _, base, _, _ = servers
    body = {"prompt": [10, 20, 30, 40], "max_tokens": 8, "temperature": 0}
    text = _post(base, "/v1/completions", body)["choices"][0]["text"]
    assert len(text) >= 2
    stop = text[1]
    res = _post(base, "/v1/completions", dict(body, stop=stop))
    assert res["choices"][0]["text"] == text[: text.index(stop)]
    assert res["choices"][0]["finish_reason"] == "stop"


def test_chat_endpoint_and_template(servers):
    state, base, jbase, _ = servers
    msgs = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "yo"}]
    assert state.chat_prompt(msgs) == "<user>hi<assistant>yo<assistant>"
    body = {"messages": msgs[:1], "max_tokens": 4, "temperature": 0}
    res = _post(base, "/v1/chat/completions", body)
    msg = res["choices"][0]["message"]
    assert msg["role"] == "assistant" and msg == _post(jbase, "/v1/chat/completions", body)["choices"][0]["message"]


def test_sampled_requests_and_forks(servers):
    """A sampled request, and n = 3 forks sharing ONE prefill
    (Engine.submit_many), each its own continuation."""
    state, base, _, _ = servers
    res = _post(base, "/v1/completions", {"prompt": [3, 4], "max_tokens": 5, "temperature": 0.8, "top_p": 0.9})
    assert isinstance(res["choices"][0]["text"], str) and res["usage"]["completion_tokens"] >= 1
    before = state.engine.prefill_count
    res = _post(base, "/v1/completions", {"prompt": [11, 22, 33, 44], "max_tokens": 5, "temperature": 0.9,
                                          "top_p": 0.95, "n": 3})
    assert [c["index"] for c in res["choices"]] == [0, 1, 2]
    assert all(isinstance(c["text"], str) for c in res["choices"])
    assert state.engine.prefill_count == before + 1
    assert res["usage"]["completion_tokens"] >= 3


def test_a_failed_engine_thread_answers_500(servers, monkeypatch):
    """A fault on the engine thread (a failed capture, a kernel error) ends
    the waiting requests with a 500 naming it, instead of hanging them."""
    state = servers[0]
    other = server.ServerState(str(servers[3]), max_batch=2, max_seq=96,
                               cache_dtype=torch.float32, device="cpu", model=state.model)

    def broken():
        raise RuntimeError("capture failed")

    monkeypatch.setattr(other.engine, "_tick", broken)
    httpd, base = _start(other, server)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/v1/completions", {"prompt": [1, 2], "max_tokens": 2, "temperature": 0})
        assert e.value.code == 500 and "capture failed" in json.loads(e.value.read())["error"]["message"]
    finally:
        httpd.shutdown()
        other.shutdown()
    assert isinstance(other.error, RuntimeError)


def test_what_is_not_ported(servers, tmp_path):
    _, base, _, _ = servers
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/embeddings", {"input": "hi"})
    assert e.value.code == 501
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/completions", {"prompt": [1] * 96, "max_tokens": 2})
    assert e.value.code == 400
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        server.ServerState("unused.gguf", embed_model="bert.gguf", device="cpu")
    assert server.parser().parse_args(["m.gguf"]).device == "cuda"
    assert server.paged_config(server.parser().parse_args(["m.gguf"])) is None
    pcfg = server.paged_config(server.parser().parse_args(["m.gguf", "--prefix-cache", "--max-seq", "100"]))
    assert (pcfg.page_size, pcfg.max_pages_per_seq, pcfg.n_pages, pcfg.prefix_cache) == (16, 7, 4 * 7 + 7, True)


def test_paged_prefix_cache_over_http_matches_jax(servers):
    """--paged --prefix-cache (tests/test_prefix_cache.py's server test): a
    prompt of two full pages and two tokens asked twice of the port's paged
    server and of JAX's paged server on the same file: the same text each
    time, the second answer from the published pages."""
    from ggml_tpu import paged_kv as jpaged
    from ggml_tpu_torch import paged_kv

    path = str(servers[3])
    args = server.parser().parse_args([path, "--prefix-cache", "--page-size", "4", "--max-seq", "64"])
    state = server.ServerState(path, max_batch=2, max_seq=64, cache_dtype=torch.float32, device="cpu",
                               paged=server.paged_config(args))
    assert isinstance(state.engine.mgr, paged_kv.PagedKVManager)
    jstate = jserver.ServerState(path, max_batch=2, max_seq=64, cache_dtype=jnp.float32, paged=jpaged.PagedConfig(
        page_size=4, n_pages=2 * 16 + 16, max_pages_per_seq=16, prefix_cache=True))
    (httpd, base), (jhttpd, jbase) = _start(state, server), _start(jstate, jserver)
    body = {"prompt": [3, 14, 15, 92, 65, 35, 89, 79, 32, 38], "max_tokens": 5, "temperature": 0}
    try:
        texts = []
        for b in (base, jbase, base, jbase):
            texts.append(_post(b, "/v1/completions", body)["choices"][0]["text"])
    finally:
        for h, s in ((httpd, state), (jhttpd, jstate)):
            h.shutdown()
            s.shutdown()
    assert texts == [texts[1]] * 4
    assert state.engine.cached_prefix_tokens == jstate.engine.cached_prefix_tokens == 8
    assert state.engine.mgr.free_pages() == state.engine.paged.n_pages == 4 * 16 + 16
