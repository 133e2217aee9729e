"""A tiny Llama GGUF file through the port's front end, on the CPU: the
generate CLI with an SPM vocabulary, the registry, and the same file split
into shards by tools/gguf_split.py (the gguf-split convention), read by the
port's reader as one file.

The file (llama.write_random_gguf): E 256, 4 heads over 2 kv heads, 2
layers, n_ff 512, Q4_K weights (multiplied-out nibble planes at K = 256),
the SPM toy vocabulary of tests/test_tokenizer_spm.py (269 pieces with byte
fallback).  The CLI (--device cpu --quantized --top-k 1) prints the greedy
text the in-process model generates; load_tokenizer gives JAX's ids.  The
split's first shard gives the whole file's tensor table and bytes (and the
JAX reader's table), the same gguf_dump, and a model whose logits equal the
whole file's bit for bit.  Loaded with llamacpp_permuted, q and k are the
JAX loader's dense unpermuted rows bit for bit.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from ggml_tpu.cli import gguf_dump as jdump
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import llama as jllama
from ggml_tpu.models.registry import load_tokenizer as jax_load_tokenizer
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.cli import gguf_dump
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.models import llama, registry
from ggml_tpu_torch.quant.planar import PlanarWeight
from ggml_tpu_torch.tokenizer import SPMTokenizer
from tests import test_tokenizer_spm as spm_tests
from tools.gguf_split import split

PROMPT = "hello hello hé"


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    toy = spm_tests._toy()
    cfg = llama.LlamaConfig(n_vocab=len(toy.tokens), n_ctx=128, n_embd=256, n_head=4, n_head_kv=2, n_layer=2,
                            n_ff=512)
    path = tmp_path_factory.mktemp("llama_cli") / "tiny-llama.gguf"
    llama.write_random_gguf(path, cfg, seed=5, tokenizer=dict(
        model="llama", tokens=toy.tokens, scores=[float(s) for s in toy.scores], bos_token_id=1, eos_token_id=2))
    return path


@pytest.fixture(scope="module")
def shards(gguf_path):
    return split(str(gguf_path), str(gguf_path.with_name("split")), n_split=3)


def _run_cli(capsys, argv):
    cli.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def test_cli_text_is_the_greedy_text_and_the_tokenizer_jax_s(gguf_path, capsys):
    out = _run_cli(capsys, [str(gguf_path), "-p", PROMPT, "-n", "10", "--quantized", "--top-k", "1"])
    with GGUFFile(gguf_path) as g:
        tok = registry.load_tokenizer(g)
    jg = JGGUFFile(gguf_path)
    jtok = jax_load_tokenizer(jg)
    jg.close()
    assert isinstance(tok, SPMTokenizer) and type(jtok).__name__ == "SPMTokenizer"
    ids = tok.encode(PROMPT)
    assert ids == jtok.encode(PROMPT) and ids[0] == 1 and len(ids) > 3
    m = registry.load_model(gguf_path, keep_quantized=True, device="cpu")
    assert isinstance(m, llama.Llama) and isinstance(m.params["output.weight"], PlanarWeight)
    gen = m.generate(np.asarray([ids], np.int32), 10)
    assert out == PROMPT + tok.decode(gen) + "\n" and len(gen) == 10


def test_registry_and_cli_flags_on_a_llama_file(gguf_path, tmp_path, capsys):
    m = registry.load_model(gguf_path, arch="qwen2", device="cpu", max_seq=32)
    assert isinstance(m, llama.Llama) and m.max_seq == 32 and m.params["blk.0.attn_q.weight"].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.load_model(gguf_path, arch="qwen3moe", device="cpu")
    # --lora merges into the dense weights (its text against JAX's: tests/test_torch_llama_train.py)
    from ggml_tpu_torch.opt import lora

    adapter = tmp_path / "adapter.gguf"
    ab = {"a": torch.ones((2, 256)) * 0.1, "b": torch.ones((256, 2)) * 0.1}
    lora.save_lora_gguf(adapter, {"blk.0.attn_q.weight": ab, "blk.1.ffn_down.weight": {
        "a": torch.ones((2, 512)) * 0.1, "b": ab["b"]}}, alpha=2.0, base_arch="llama")
    text = _run_cli(capsys, [str(gguf_path), "-p", PROMPT, "-n", "4", "--top-k", "1", "--lora", str(adapter)])
    assert text.startswith(PROMPT)
    with pytest.raises(SystemExit, match="quantized"):
        cli.main([str(gguf_path), "--lora", str(adapter), "--quantized", "--device", "cpu"])
    seeded = [str(gguf_path), "-p", PROMPT, "-n", "4", "--quantized", "--seed", "3", "--top-k", "40"]
    assert _run_cli(capsys, seeded) == _run_cli(capsys, seeded)


def test_split_file_reads_as_the_whole_file(gguf_path, shards):
    assert len(shards) == 3 and all(pathlib.Path(p).exists() for p in shards)
    with GGUFFile(gguf_path) as whole, GGUFFile(shards[0]) as first:
        assert list(first.tensors) == list(whole.tensors) and len(first.tensors) == 3 + 9 * 2
        jfirst = JGGUFFile(shards[0])
        try:
            for name, t in whole.tensors.items():
                got, want = first.tensors[name], jfirst.tensors[name]
                assert ((got.shape, int(got.ggml_type)) == (t.shape, int(t.ggml_type))
                        == (want.shape, int(want.ggml_type)))
                np.testing.assert_array_equal(first.tensor_bytes(name), whole.tensor_bytes(name))
                np.testing.assert_array_equal(first.tensor_bytes(name), jfirst.tensor_bytes(name))
            np.testing.assert_array_equal(first.to_float32("blk.1.ffn_down.weight"),
                                          whole.to_float32("blk.1.ffn_down.weight"))
        finally:
            jfirst.close()
        assert {k: v for k, v in first.metadata.items() if not k.startswith("split.")}.keys() == whole.metadata.keys()
    got, want = gguf_dump.dump(shards[0], as_json=True), jdump.dump(shards[0], as_json=True)
    assert got["tensors"] == want["tensors"] and got["n_tensors"] == want["n_tensors"] == 21


def test_split_file_model_gives_the_whole_file_logits(gguf_path, shards, capsys):
    prompt = np.arange(3, 9)[None]
    logits = []
    for path in (gguf_path, shards[0]):
        m = llama.Llama.from_gguf(path, dtype=torch.float32, device="cpu", max_seq=32)
        logits.append(m.prefill(m.new_cache(torch.float32), prompt)[0])
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)
    argv = ["-p", PROMPT, "-n", "3", "--quantized", "--top-k", "1"]
    assert _run_cli(capsys, [str(shards[0])] + argv) == _run_cli(capsys, [str(gguf_path)] + argv)


def test_llamacpp_permuted_load_matches_jax(gguf_path):
    """llamacpp_permuted=True: q and k are dequantized and their rows
    unpermuted, bit for bit as the JAX loader does; the other weights stay
    planes."""
    jm = jllama.Llama.from_gguf(gguf_path, dtype=jnp.float32, keep_quantized=True, llamacpp_permuted=True)
    tm = llama.Llama.from_gguf(gguf_path, dtype=torch.float32, llamacpp_permuted=True, device="cpu")
    for name in ("blk.0.attn_q.weight", "blk.1.attn_k.weight"):
        assert isinstance(tm.params[name], torch.Tensor) and tm.params[name].shape == jm.params[name].shape
        np.testing.assert_array_equal(tm.params[name].numpy(), np.asarray(jm.params[name]))
    assert isinstance(tm.params["blk.0.attn_v.weight"], PlanarWeight)


def test_load_params_in_row_chunks_is_the_whole_tensor(gguf_path, monkeypatch):
    """A tensor of more than _CHUNK_ROWS rows is dequantized in chunks of
    rows (jobs of their own): the result is the whole tensor's, bit for
    bit, dense and as the embedding's dense copy beside its planes."""
    from ggml_tpu_torch.models import gpt2

    monkeypatch.setattr(gpt2, "_CHUNK_ROWS", 100)  # the embedding (269 rows) in 3 chunks, ffn_gate/up in 6
    with GGUFFile(gguf_path) as g:
        dense = gpt2.load_params(g, torch.float32, device="cpu")
        planar = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cpu")
        assert list(dense) == list(g.tensors)
        for name in g.tensors:
            np.testing.assert_array_equal(dense[name].numpy(), g.to_float32(name), err_msg=name)
        np.testing.assert_array_equal(planar["token_embd.weight@dense"].numpy(), g.to_float32("token_embd.weight"))
    assert list(planar)[:2] == ["token_embd.weight", "token_embd.weight@dense"]
