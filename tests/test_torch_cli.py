"""The port's text front end on the CPU: the generate CLI
(ggml_tpu_torch.cli.generate), the model registry, GPT-J's dense load and
gguf_dump, against the JAX package's.

- A tiny f32 GPT-2 GGUF (init_random_params, a byte-level vocabulary of 300
  learned merges): the port CLI prints the JAX CLI's text, greedy (--top-k 1)
  and under a grammar.
- A tiny GPT-J GGUF of Q4_K blocks (ggml_tpu_torch.models.gptj.write_random_gguf):
  the port CLI's --quantized text equals the port's own GPTJ.from_gguf(...).generate
  (that path is held against JAX op by op in test_torch_gguf.py), and its
  --verbose report names select_kernel's wrapper for every matmul site;
  keep_quantized=False gives JAX's dense parameters bit for bit.
"""

import dataclasses
import json
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.cli import generate as jcli
from ggml_tpu.cli import gguf_dump as jdump
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.models.registry import ARCHS as JAX_ARCHS
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.cli import gguf_dump
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gpt2, gptj, registry
from ggml_tpu_torch.quant.planar import PlanarWeight
from ggml_tpu_torch.tokenizer import BPETokenizer
from tests.test_torch_rules import one_thread, tiny_gpt2_gguf  # noqa: F401  (one_thread: the autouse fixture)
from tests.test_torch_tokenizer import bpe_vocab

PROMPT = "the quick brown fox jumps over the lazy dog, don't it? 42 cafés and 3.14 über-tions"
GPT2_SHAPE = dict(n_ctx=128, n_embd=32, n_head=4, n_layer=2)
GPTJ_CFG = gptj.GPTJConfig(n_vocab=640, n_ctx=128, n_embd=512, n_head=4, n_layer=2, n_rot=32)


@pytest.fixture(scope="module")
def vocab():
    return bpe_vocab()


@pytest.fixture(scope="module")
def gpt2_path(tmp_path_factory, vocab):
    tokens, merges = vocab
    return tiny_gpt2_gguf(tmp_path_factory.mktemp("cli") / "gpt2.gguf", dict(n_vocab=len(tokens), **GPT2_SHAPE),
                          tokens, merges, seed=3, eos_token_id=len(tokens) - 1)


@pytest.fixture(scope="module")
def gptj_path(tmp_path_factory, vocab):
    tokens, merges = vocab
    tokens = tokens + [f"<|extra_{i}|>" for i in range(GPTJ_CFG.n_vocab - len(tokens))]
    path = tmp_path_factory.mktemp("cli") / "gptj-q4k.gguf"
    gptj.write_random_gguf(path, GPTJ_CFG, seed=1,
                           tokenizer=dict(model="gpt2", tokens=tokens, merges=merges, eos_token_id=300))
    return path


def _run_jax_cli(monkeypatch, capsys, argv) -> str:
    monkeypatch.setattr(sys, "argv", ["generate"] + argv)
    jcli.main()
    return capsys.readouterr().out


def _run_cli(capsys, argv) -> tuple[str, str]:
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    return got.out, got.err


@pytest.mark.parametrize("mode", ["greedy", "grammar"])
def test_gpt2_text_matches_the_jax_cli(gpt2_path, tmp_path, monkeypatch, capsys, mode):
    argv = [str(gpt2_path), "-p", PROMPT, "-n", "16", "--seed", "0"]
    if mode == "greedy":
        argv += ["--top-k", "1"]
    else:
        grammar = tmp_path / "words.gbnf"
        grammar.write_text('root ::= [a-z] [a-z ]*\n')
        argv += ["--grammar", str(grammar)]
    want = _run_jax_cli(monkeypatch, capsys, argv)
    got, err = _run_cli(capsys, argv)
    assert got == want and got.startswith(PROMPT) and len(got) > len(PROMPT) + 4
    if mode == "grammar":
        assert re.fullmatch(r"[a-z][a-z ]*", got[len(PROMPT):].rstrip("\n"))
    assert "load time" in err and "ms per token" in err


def _report(err: str) -> dict:
    sites = {}
    for line in err.splitlines():
        m = re.match(r"\s+(\w+) K=(\d+)\s+N=(\d+)\s+(\S+) -> (.+)$", line)
        if m:
            sites[(m[1], int(m[2]), int(m[3]), m[4])] = m[5].split(", ")
    return sites


def test_gptj_quantized_text_and_kernel_report(gptj_path, capsys):
    qmatmul._selection_log.clear()
    out, err = _run_cli(capsys, [str(gptj_path), "-p", PROMPT, "-n", "12", "--quantized", "--top-k", "1",
                                 "--verbose"])
    m = gptj.GPTJ.from_gguf(gptj_path, max_seq=512, device="cpu")
    with GGUFFile(gptj_path) as g:
        tok = BPETokenizer.from_gguf(g)
    ids = np.asarray([tok.encode(PROMPT)], np.int32)
    assert ids.shape[1] > qmatmul.GEMV_MAX_M  # the prompt takes the matmul, decode the M=1 GEMV
    assert out == PROMPT + tok.decode(m.generate(ids, 12)) + "\n"
    want = {}
    for name, pw in m.params.items():
        if isinstance(pw, PlanarWeight) and name != "token_embd.weight":
            want[(pw.kind, pw.k, pw.n, "matmul-M")] = [qmatmul.select_kernel(pw, ids.shape[1])]
            want[(pw.kind, pw.k, pw.n, "gemv-M")] = [qmatmul.select_kernel(pw, 1)]
    assert _report(err) == want
    assert {w[0] for w in want.values()} == {"q4k_matmul", "q4k_gemv_qact"}


def test_sampled_decode_repeats_from_a_seed(gptj_path, capsys):
    """Sampled decoding (top_k 40): the first token from the prefill logits,
    the rest through decode_sampled; a seed gives the same ids twice."""
    m = gptj.GPTJ.from_gguf(gptj_path, max_seq=64, device="cpu")
    ids = np.arange(3, 10)[None]
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(cli.decode(m, ids, 6, gen, temperature=0.8, top_k=40, top_p=0.95))
    assert runs[0] == runs[1] and len(runs[0]) == 6 and all(0 <= t < GPTJ_CFG.n_vocab for t in runs[0])
    argv = [str(gptj_path), "-p", PROMPT, "-n", "4", "--seed", "11", "--top-k", "40"]
    assert _run_cli(capsys, argv)[0] == _run_cli(capsys, argv)[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_gptj_params_match_jax_bit_for_bit(gptj_path, dtype):
    jm = jgptj.GPTJ.from_gguf(gptj_path, dtype=getattr(jnp, dtype), keep_quantized=False)
    tm = gptj.GPTJ.from_gguf(gptj_path, dtype=getattr(torch, dtype), keep_quantized=False, device="cpu")
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg) and list(tm.params) == list(jm.params)
    bits = {"bfloat16": np.uint16, "float32": np.uint32}[dtype]
    for name, p in tm.params.items():
        assert isinstance(p, torch.Tensor) and p.dtype == getattr(torch, dtype), name
        want = np.asarray(jm.params[name])
        got = p.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
        np.testing.assert_array_equal(got.view(bits), want.view(bits), err_msg=name)


def test_registry_loads_the_ported_families(gpt2_path, gptj_path):
    m = registry.load_model(gpt2_path, device="cpu")
    assert isinstance(m, gpt2.GPT2) and m.max_seq == 512 and m.params["blk.0.ffn_up.weight"].dtype == torch.float32
    m = registry.load_model(gptj_path, device="cpu", keep_quantized=True, max_seq=64)
    assert isinstance(m, gptj.GPTJ) and m.max_seq == 64 and isinstance(m.params["output.weight"], PlanarWeight)
    m = registry.load_model(gptj_path, arch="gptj", device="cpu")
    assert isinstance(m.params["output.weight"], torch.Tensor) and m.params["output.weight"].dtype == torch.bfloat16
    assert registry.model_class("gpt2") is gpt2.GPT2 and registry.model_class("gptj") is gptj.GPTJ


def test_registry_refuses_what_it_has_not(gpt2_path):
    assert set(registry.ARCHS) == {"gpt2", "gptj", "llama", "qwen2", "qwen3", "qwen2moe", "qwen3moe", "granite",
                                   "granitemoe", "smollm3", "ernie4_5", "helium", "seed_oss", "deepseek2", "glm4moe",
                                   "dots1", "olmoe", "dbrx", "phimoe", "gpt-oss", "gemma", "gemma2", "gemma3", "phi2",
                                   "phi3", "gptneox", "falcon"}
    assert set(registry.ARCHS) | set(registry._NOT_PORTED) == set(JAX_ARCHS)
    for arch in sorted(set(JAX_ARCHS) - set(registry.ARCHS)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            registry.model_class(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.load_model(gpt2_path, arch="jetmoe", device="cpu")
    with pytest.raises(KeyError):
        registry.model_class("no-such-arch")


def test_cli_refuses_lora_and_a_missing_card(gpt2_path, monkeypatch):
    with pytest.raises(SystemExit, match="quantized"):  # --lora merges into dense weights (test_torch_lora.py)
        cli.main([str(gpt2_path), "--lora", "adapter.gguf", "--quantized", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main([str(gpt2_path), "-n", "2"])  # no --device: the card, never a quiet CPU run


@pytest.mark.parametrize("flags", [[], ["--no-tensors"], ["--json"]])
def test_gguf_dump_prints_the_jax_dump(gptj_path, capsys, flags):
    jdump.dump(str(gptj_path), show_tensors="--no-tensors" not in flags, as_json="--json" in flags)
    want = capsys.readouterr().out
    gguf_dump.main([str(gptj_path)] + flags)
    got = capsys.readouterr().out
    assert got == want and "tokenizer.ggml.merges" in got
    assert ("Q4_K" in got) == ("--no-tensors" not in flags)
    if "--json" in flags:
        assert json.loads(got)["n_tensors"] == 5 + 10 * GPTJ_CFG.n_layer
