"""OpenAI-compatible HTTP front end over serve.Engine (port of
ggml_tpu/cli/server.py; the llama.cpp `llama-server` analog), stdlib-only
(ThreadingHTTPServer + SSE).

    python -m ggml_tpu_torch.cli.server model.gguf --port 8080 --max-batch 8 [--quantized] [--device cpu]
        [--paged [--page-size 16] [--n-pages N]] [--prefix-cache]

Endpoints:
  GET  /health               -> {"status": "ok"}
  GET  /v1/models            -> model listing
  POST /v1/completions       -> text or token-array prompt; stream via SSE; stop; n forks
  POST /v1/chat/completions  -> messages through the GGUF chat template (jinja2)
  POST /v1/embeddings        -> 501: the BERT family is not ported yet

Per-request temperature and top_p ride the engine's slot-vector sampler
(Engine.submit(sampling=...)); temperature 0 is greedy.  Every engine call
happens on ONE worker thread, which sets the model's CUDA device itself, so
every graph capture and replay happens there; HTTP handler threads hand
requests over through queue.Queue, so continuous batching interleaves
concurrent requests into shared ticks.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

_EMBED = "the BERT family behind /v1/embeddings (--embed-model) is not ported yet (ROADMAP.md, section 1)"


class ServerState:
    """Model + engine + the single engine worker thread.  model: an already
    loaded wrapper of model_path's weights (the file still gives the
    tokenizer, the EOS id and the chat template); by default the file is
    loaded onto `device`."""

    def __init__(self, model_path: str, max_batch: int = 4, max_seq: int = 512, arch: str | None = None,
                 quantized: bool = False, cache_dtype=None, embed_model: str | None = None, paged=None,
                 device="cuda", model=None):
        from ..gguf import GGUFFile
        from ..models.registry import load_model, load_tokenizer
        from ..serve import Engine

        if embed_model:
            raise NotImplementedError(_EMBED)
        self.model_id = str(model_path).rsplit("/", 1)[-1]
        if model is None:
            model = load_model(model_path, arch=arch, max_seq=max_seq, batch=1, keep_quantized=quantized,
                               device=device)
        self.model = model
        with GGUFFile(model_path) as g:
            md = g.metadata
            self.tok = load_tokenizer(g)
            first = lambda v: v[0] if isinstance(v, (list, tuple)) else v
            self.eos_id = int(first(md.get("tokenizer.ggml.eos_token_id", -1)))
            self.chat_template = first(md.get("tokenizer.chat_template", ""))
            toks_meta = md.get("tokenizer.ggml.tokens")

            def _tok_str(key):
                tid = md.get(key)
                if tid is None or toks_meta is None:
                    return ""
                tid = int(first(tid))
                return str(toks_meta[tid]) if 0 <= tid < len(toks_meta) else ""

            self.bos_token = _tok_str("tokenizer.ggml.bos_token_id")
            self.eos_token = _tok_str("tokenizer.ggml.eos_token_id")
        self.engine = Engine(model, max_batch=max_batch, max_seq=max_seq, eos_id=self.eos_id, paged=paged,
                             cache_dtype=cache_dtype or torch.bfloat16)
        self.max_seq = max_seq
        self.error: BaseException | None = None  # what stopped the engine thread, if anything did
        self._lock = threading.Lock()  # serializes submit/cancel against the loop
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        # one tick at a time; submissions interleave between ticks
        eng = self.engine
        try:
            if eng.device.type == "cuda":  # the device the cache lives on ("cuda" names no index)
                torch.cuda.set_device((eng.cache or eng.mgr.pools)[0][0].device)
            while not self._stop.is_set():
                with self._lock:
                    busy = bool(eng.queue) or any(s is not None for s in eng.slots)
                    if busy:
                        eng._admit(32)
                        eng._tick()
                        for i, s in enumerate(eng.slots):
                            if s is not None and s.done:
                                eng.slots[i] = None
                                if eng.paged is not None:
                                    eng.mgr.release(i)
                if not busy:
                    time.sleep(0.005)
        except BaseException as e:  # the handlers waiting on this thread answer 500 with it
            self.error = e
            traceback.print_exc()

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def submit(self, prompt_ids, max_new, sampling, on_token):
        with self._lock:
            return self.engine.submit(prompt_ids, max_new, on_token=on_token, sampling=sampling)

    def submit_many(self, prompt_ids, n, max_new, sampling, on_token):
        with self._lock:
            return self.engine.submit_many(prompt_ids, n, max_new, on_token=on_token, sampling=sampling)

    def cancel(self, rid):
        with self._lock:
            return self.engine.cancel(rid)

    # -- text helpers -----------------------------------------------------------

    def encode(self, prompt):
        if isinstance(prompt, list):  # OpenAI token-array prompts
            return [int(t) for t in prompt]
        if self.tok is None:
            raise ValueError("model GGUF has no tokenizer; pass token-id lists")
        return self.tok.encode(prompt)

    def decode(self, ids):
        if self.tok is None:
            return " ".join(str(i) for i in ids)
        return self.tok.decode(list(ids))

    def chat_prompt(self, messages) -> str:
        """Render tokenizer.chat_template from the GGUF when present (jinja2,
        add_generation_prompt=True, the llama.cpp chat-template path);
        otherwise a plain "role: content" fallback."""
        if self.chat_template:
            import jinja2

            env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
            env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(ValueError(msg))
            return env.from_string(self.chat_template).render(
                messages=messages, add_generation_prompt=True, bos_token=self.bos_token, eos_token=self.eos_token)
        lines = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
        return "\n".join(lines) + "\nassistant:"

    def embed(self, inputs):
        raise NotImplementedError(_EMBED)


def _sampling_from(body) -> dict | None:
    temp = float(body.get("temperature", 1.0))
    top_p = float(body.get("top_p", 1.0))
    if temp == 0.0:
        return {"temperature": 0.0}
    return {"temperature": temp, "top_p": top_p}


class _Generation:
    """Bridges the engine's on_token callback to an HTTP handler thread,
    applying stop-sequence scanning on the decoded text."""

    def __init__(self, state: ServerState, prompt_ids, max_new, sampling, stops, _fork=None):
        self.state = state
        self.ids: list[int] = []
        self.stops = stops or []
        if _fork is None:
            self.q: queue.Queue = queue.Queue()
            self.rid = state.submit(prompt_ids, max_new, sampling, lambda rid, tok, done: self.q.put((tok, done)))
        else:
            self.rid, self.q = _fork

    @staticmethod
    def fork(state: ServerState, prompt_ids, n: int, max_new, sampling, stops):
        """n shared-prefix continuations (Engine.submit_many): the prompt
        prefills once; each choice gets its own event stream."""
        qs: dict = {}

        def cb(rid, tok, done):
            qs.setdefault(rid, queue.Queue()).put((tok, done))

        rids = state.submit_many(prompt_ids, n, max_new, sampling, cb)
        return [_Generation(state, prompt_ids, max_new, sampling, stops, _fork=(rid, qs.setdefault(rid, queue.Queue())))
                for rid in rids]

    def _next(self):
        while True:
            try:
                return self.q.get(timeout=1.0)
            except queue.Empty:
                if self.state.error is not None:
                    raise RuntimeError(f"the engine thread stopped: {self.state.error!r}") from self.state.error

    def events(self):
        """Yields (delta_text, finish_reason|None); finish_reason arrives
        exactly once, on the final event.  Stop strings use holdback: text
        that could still be the prefix of a stop sequence is withheld until
        disambiguated, so streamed output never needs retraction."""
        emitted = 0
        holdback = max((len(s) - 1 for s in self.stops), default=0)
        eos = self.state.eos_id
        while True:
            tok, done = self._next()
            if tok == eos and eos >= 0:
                yield "", "stop"
                return
            self.ids.append(tok)
            text = self.state.decode(self.ids)
            hit_at = min((text.index(s) for s in self.stops if s in text), default=-1)
            if hit_at >= 0:
                self.state.cancel(self.rid)
                yield text[emitted:hit_at] if hit_at > emitted else "", "stop"
                return
            if done:
                yield text[emitted:], "length"
                return
            safe = max(emitted, len(text) - holdback)
            if safe > emitted:
                yield text[emitted:safe], None
                emitted = safe


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"status": "ok"})
            if self.path == "/v1/models":
                data = [{"id": state.model_id, "object": "model", "owned_by": "ggml_tpu_torch"}]
                return self._json(200, {"object": "list", "data": data})
            return self._json(404, {"error": "not found"})

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            try:
                if self.path == "/v1/completions":
                    return self._completions(chat=False)
                if self.path == "/v1/chat/completions":
                    return self._completions(chat=True)
                if self.path == "/v1/embeddings":
                    self._read_body()
                    state.embed(None)
                return self._json(404, {"error": "not found"})
            except ValueError as e:
                return self._json(400, {"error": {"message": str(e)}})
            except NotImplementedError as e:
                return self._json(501, {"error": {"message": str(e)}})
            except RuntimeError as e:
                return self._json(500, {"error": {"message": str(e)}})

        def _completions(self, chat: bool):
            body = self._read_body()
            if chat:
                prompt_ids = state.encode(state.chat_prompt(body.get("messages", [])))
            else:
                prompt_ids = state.encode(body.get("prompt", ""))
            if len(prompt_ids) >= state.max_seq:
                raise ValueError(f"prompt of {len(prompt_ids)} tokens exceeds max_seq {state.max_seq}")
            max_new = int(body.get("max_tokens", 16))
            max_new = min(max_new, state.max_seq - len(prompt_ids) - 1)
            stops = body.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            n = int(body.get("n", 1))
            if n > 1 and body.get("stream"):
                raise ValueError("stream with n > 1 is not supported")
            if n > 1:
                gens = _Generation.fork(state, prompt_ids, n, max_new, _sampling_from(body), stops)
            else:
                gens = [_Generation(state, prompt_ids, max_new, _sampling_from(body), stops)]
            gen = gens[0]
            rid = f"cmpl-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            kind = "chat.completion" if chat else "text_completion"

            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def raw_chunk(data: bytes):
                    self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")

                for delta, fin in gen.events():
                    if chat:
                        d = {"delta": ({"content": delta} if delta else {}), "index": 0, "finish_reason": fin}
                    else:
                        d = {"text": delta, "index": 0, "finish_reason": fin}
                    raw_chunk(b"data: " + json.dumps({"id": rid, "object": kind + ".chunk", "created": created,
                                                      "model": state.model_id, "choices": [d]}).encode() + b"\n\n")
                raw_chunk(b"data: [DONE]\n\n")
                self.wfile.write(b"0\r\n\r\n")
                return

            choices, n_out = [], 0
            for idx, g in enumerate(gens):
                parts, fin = [], "length"
                for delta, f in g.events():
                    parts.append(delta)
                    if f:
                        fin = f
                text = "".join(parts)
                n_out += len(g.ids)
                if chat:
                    choices.append({"index": idx, "finish_reason": fin,
                                    "message": {"role": "assistant", "content": text}})
                else:
                    choices.append({"index": idx, "finish_reason": fin, "text": text})
            usage = {"prompt_tokens": len(prompt_ids), "completion_tokens": n_out,
                     "total_tokens": len(prompt_ids) + n_out}
            return self._json(200, {"id": rid, "object": kind, "created": created, "model": state.model_id,
                                    "choices": choices, "usage": usage})

    return Handler


def serve(state: ServerState, host: str = "127.0.0.1", port: int = 8080):
    return ThreadingHTTPServer((host, port), make_handler(state))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--quantized", action="store_true", help="keep weights packed (the CUDA kernels)")
    ap.add_argument("--embed-model", default=None, help="BERT-family GGUF served at /v1/embeddings (not ported)")
    ap.add_argument("--paged", action="store_true", help="paged KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=0, help="page pool size (default: max_batch x max_seq worth)")
    ap.add_argument("--prefix-cache", action="store_true", help="automatic prefix caching (implies --paged)")
    ap.add_argument("--device", default="cuda")
    return ap


def paged_config(args):
    """The PagedConfig of --paged / --prefix-cache (None without them): pages
    of --page-size tokens, max_seq worth a sequence, --n-pages or max_batch
    sequences plus one in the pool."""
    if not (args.paged or args.prefix_cache):
        return None
    from ..paged_kv import PagedConfig

    per_seq = -(-args.max_seq // args.page_size)
    return PagedConfig(page_size=args.page_size, n_pages=args.n_pages or args.max_batch * per_seq + per_seq,
                       max_pages_per_seq=per_seq, prefix_cache=args.prefix_cache)


def main(argv=None):
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the card (--device cpu runs the plain versions)")
    # dense products sum as the JAX package's do under XLA (as cli.generate sets them)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    state = ServerState(args.model, max_batch=args.max_batch, max_seq=args.max_seq, arch=args.arch,
                        quantized=args.quantized, embed_model=args.embed_model, paged=paged_config(args),
                        device=args.device)
    httpd = serve(state, args.host, args.port)
    print(f"listening on http://{args.host}:{args.port} (model {state.model_id}, batch {args.max_batch})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        state.shutdown()


if __name__ == "__main__":
    main()
