"""Training the Llama family in the port (ggml_tpu_torch.opt finetune,
finetune_lora, the finetune CLI, generate --lora) against the JAX package,
on the CPU.

- Full-weight finetune of tiny f32 llama, qwen2 (q/k/v biases) and qwen3
  (per-head q/k RMSNorm) files (E 64, 4 heads over 2 kv heads, 2 layers),
  3 AdamW steps at lr 3e-3 through the cache-window attention: per-step
  losses within 1e-5 of JAX's, the trained weights within NMSE 1e-8 of
  JAX's (f32 sums in another order; AdamW's first steps move an element by
  about lr whatever its gradient's size), the qwen2 key bias left out (a
  shift shared by a row's scores leaves the softmax alone, so its gradient
  is rounding noise that AdamW turns into +-lr steps of either sign).  The
  output GGUF loads in both packages, bit for bit, and both greedy-decode
  the same ids from it.
- LoRA on a tiny Q4_K llama file (E 256, 2 layers, as the JAX package's
  tests/test_qlora.py), 3 AdamW steps at lr 1e-3, with at most one element
  of b in 1000 farther than 1e-4 from JAX's.  b starts at zero, so AdamW's
  first step moves each of its elements by lr times the sign of its
  gradient, and a gradient near zero can take the other sign; `a` gets no
  gradient until b moves, then follows b.
  - dense (the base dequantized to f32, merge_lora): losses within 1e-5,
    every `a` within NMSE 1e-9, every `b` within 1e-3 (they read 4e-16,
    1e-12 and no element farther than 1e-4);
  - QLoRA (keep_quantized=True: kernel C's plain version at batch * seq =
    64 rows, x rounded to bf16 before every planar product): the first
    loss within 3e-5, the others within 5e-4, every `a` within NMSE 1e-6,
    every `b` within 1e-2 (they read 1.3e-5, 1.2e-4, 6.9e-8, 1.3e-3 and 9
    of 18432 elements of b).  Last-bit differences of the RMSNorm and RoPE
    flip bf16 roundings of the activations, and SwiGLU spreads them
    (tests/test_torch_llama_q4.py gates the Q4_K prefill at 1e-5 where
    GPT-J's reads 1e-6), so more of b's first steps take the other sign
    than on GPT-J (tests/test_torch_qlora.py); the gradients themselves
    are held against JAX's in tests/test_torch_remat.py.
  The adapter and merged outputs load.
- The finetune CLI on a llama file: full weights, --lora-rank and
  --lora-quantized; --dp still raises.
- generate --lora on the tiny llama file: Llama.from_gguf keeps the file's
  q/k rows, so the adapter merges on the rows it was trained on, with no
  permutation, and the CLI's text is the JAX CLI's.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.gguf import GGUFFile as JaxGGUFFile
from ggml_tpu.models import llama as jllama
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import finetune as jax_finetune
from ggml_tpu.opt import finetune_lora as jax_finetune_lora
from ggml_tpu.cli import generate as jcli
from ggml_tpu_torch.cli import finetune as ft_cli
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.gguf import GGUFFile, GGUFWriter
from ggml_tpu_torch.models import llama
from ggml_tpu_torch.opt import AdamWConfig, finetune, finetune_lora, lora
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

TINY = llama.LlamaConfig(n_vocab=96, n_ctx=64, n_embd=64, n_head=4, n_head_kv=2, n_layer=2, n_ff=128)
Q4K = llama.LlamaConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_head_kv=4, n_layer=2, n_ff=512)
SEQ, BATCH, STEPS = 32, 2, 3


def _pattern(n):
    return np.asarray(([7, 11, 23, 42, 5] * (n // 5 + 1))[:n], np.int32)


def llama_family_gguf(path, arch: str, cfg: llama.LlamaConfig, seed: int):
    """An f32 GGUF file of a llama-family architecture (keys under its own
    prefix) with random weights: qwen2 adds q/k/v biases, qwen3 per-head
    q/k norm weights; norms near 1."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    w = GGUFWriter()
    w.add_string("general.architecture", arch)
    for key, val in (("context_length", cfg.n_ctx), ("embedding_length", cfg.n_embd),
                     ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
                     ("block_count", cfg.n_layer), ("feed_forward_length", cfg.n_ff), ("vocab_size", cfg.n_vocab)):
        w.add_u32(f"{arch}.{key}", val)
    w.add_f32(f"{arch}.rope.freq_base", cfg.rope_base)
    w.add_f32(f"{arch}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    E, hd = cfg.n_embd, cfg.head_dim
    mat = lambda name, n, k, s=0.05: w.add_tensor(name, f32(rng.standard_normal((n, k)) * s))
    near_one = lambda name, n: w.add_tensor(name, f32(1 + 0.1 * rng.standard_normal(n)))
    mat("token_embd.weight", cfg.n_vocab, E, s=0.5)
    near_one("output_norm.weight", E)
    mat("output.weight", cfg.n_vocab, E)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        near_one(pre + "attn_norm.weight", E)
        for name, n in (("attn_q", cfg.n_head * hd), ("attn_k", cfg.n_head_kv * hd), ("attn_v", cfg.n_head_kv * hd)):
            mat(pre + name + ".weight", n, E)
            if arch == "qwen2":
                w.add_tensor(pre + name + ".bias", f32(rng.standard_normal(n) * 0.1))
        if arch == "qwen3":
            near_one(pre + "attn_q_norm.weight", hd)
            near_one(pre + "attn_k_norm.weight", hd)
        mat(pre + "attn_output.weight", E, cfg.n_head * hd)
        near_one(pre + "ffn_norm.weight", E)
        mat(pre + "ffn_gate.weight", cfg.n_ff, E)
        mat(pre + "ffn_up.weight", cfg.n_ff, E)
        mat(pre + "ffn_down.weight", E, cfg.n_ff)
    w.write(path)
    return path


@pytest.fixture(scope="module")
def q4k_llama(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama_train") / "llama-q4k.gguf"
    llama.write_random_gguf(path, Q4K, seed=5)
    return path


@pytest.mark.parametrize("arch", ["llama", "qwen2", "qwen3"])
def test_full_finetune_matches_jax_and_the_output_loads_in_both(arch, tmp_path):
    path = llama_family_gguf(tmp_path / f"{arch}.gguf", arch, TINY, seed=3)
    toks = _pattern(400)
    kw = dict(seq_len=16, batch=4, steps=STEPS)
    want, jopt = jax_finetune(str(path), toks, adamw=JaxAdamWConfig(alpha=3e-3), **kw)
    out = tmp_path / "trained.gguf"
    got, opt = finetune(str(path), toks, adamw=AdamWConfig(alpha=3e-3), out_path=out, device="cpu", **kw)
    assert np.abs(np.array(want) - np.array(got)).max() <= 1e-5, (want, got)
    assert got[-1] < got[0]
    assert set(opt.params) == set(jopt.params)
    for name, p in opt.params.items():
        if name.endswith("attn_k.bias"):
            continue
        assert nmse(np.asarray(jopt.params[name]), p.numpy()) <= 1e-8, name

    jf, tf = JaxGGUFFile(str(out)), GGUFFile(out)
    assert tf.metadata["general.architecture"] == arch
    for name, p in opt.params.items():
        np.testing.assert_array_equal(tf.to_float32(name), p.numpy(), err_msg=name)
        np.testing.assert_array_equal(jf.to_float32(name), p.numpy(), err_msg=name)
    tf.close()
    prompt = np.array([[7, 11, 23]], np.int32)
    jm = jllama.Llama.from_gguf(str(out), dtype=jnp.float32, keep_quantized=False, max_seq=16)
    m = llama.Llama.from_gguf(out, dtype=torch.float32, keep_quantized=False, max_seq=16, device="cpu")
    assert m.generate(prompt, 6) == [int(t) for t in jm.generate(prompt, 6)]


def _assert_adapters_follow_jax(jlora, tlora, a_gate: float, b_gate: float):
    assert set(tlora) == set(jlora)  # JAX returns its pytree sorted
    far = total = 0
    for name, ab in tlora.items():
        assert nmse(np.asarray(jlora[name]["a"]), ab["a"].numpy()) <= a_gate, name
        assert nmse(np.asarray(jlora[name]["b"]), ab["b"].numpy()) <= b_gate, name
        d = np.abs(np.asarray(jlora[name]["b"]) - ab["b"].numpy())
        far, total = far + int((d > 1e-4).sum()), total + d.size
    assert far <= total // 1000, (far, total)


@pytest.mark.parametrize("keep_quantized", [False, True], ids=["dense", "qlora"])
def test_lora_finetune_matches_jax(q4k_llama, keep_quantized, tmp_path):
    toks = np.resize(np.random.default_rng(0).integers(0, Q4K.n_vocab, 13), BATCH * SEQ * 4 + 1).astype(np.int32)
    kw = dict(rank=4, keep_quantized=keep_quantized, seq_len=SEQ, batch=BATCH, steps=STEPS)
    jl, jlora = jax_finetune_lora(str(q4k_llama), toks, adamw=JaxAdamWConfig(alpha=1e-3), **kw)
    adapter, merged = tmp_path / "adapter.gguf", tmp_path / "merged.gguf"
    tl, tlora = finetune_lora(str(q4k_llama), toks, adamw=AdamWConfig(alpha=1e-3), adapter_out=adapter,
                              merged_out=merged, device="cpu", **kw)
    assert abs(jl[0] - tl[0]) <= (1e-6 if not keep_quantized else 3e-5), (jl, tl)
    assert np.abs(np.array(jl) - np.array(tl)).max() <= (1e-5 if not keep_quantized else 5e-4), (jl, tl)
    assert tl[-1] < tl[0] and len(tlora) == 7 * Q4K.n_layer
    _assert_adapters_follow_jax(jlora, tlora, *((1e-9, 1e-3) if not keep_quantized else (1e-6, 1e-2)))
    got, alpha = lora.load_lora_gguf(adapter)
    assert alpha == 4.0 and all(torch.equal(got[k]["b"], tlora[k]["b"]) for k in tlora)
    with GGUFFile(merged) as g:
        want = g.to_float32("blk.1.ffn_down.weight")
    with GGUFFile(q4k_llama) as g:
        base = torch.from_numpy(g.to_float32("blk.1.ffn_down.weight").copy())
    ab = tlora["blk.1.ffn_down.weight"]
    np.testing.assert_allclose(want, (base + ab["b"] @ ab["a"]).numpy(), rtol=1e-6, atol=1e-6)


def test_finetune_cli_on_a_llama_file(q4k_llama, tmp_path, capsys):
    np.save(tmp_path / "t.npy", _pattern(300))
    args = [str(q4k_llama), str(tmp_path / "out.gguf"), "--tokens", str(tmp_path / "t.npy"), "--seq", "16",
            "--batch", "2", "--steps", "2", "--device", "cpu"]
    ft_cli.main(args + ["--arch", "llama"])
    assert "final loss" in capsys.readouterr().out
    with GGUFFile(tmp_path / "out.gguf") as g:
        assert g.metadata["general.architecture"] == "llama" and len(g.tensors) == 3 + 9 * Q4K.n_layer
    for extra in (["--lora-rank", "4"], ["--lora-rank", "4", "--lora-quantized"]):
        ft_cli.main(args + extra + ["--lora-out", str(tmp_path / "a.gguf")])
        assert "+ adapter" in capsys.readouterr().out
        assert len(lora.load_lora_gguf(tmp_path / "a.gguf")[0]) == 7 * Q4K.n_layer
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ft_cli.main(args + ["--dp", "2"])


def test_generate_lora_on_a_llama_file_is_the_jax_cli_text(q4k_llama, tmp_path, monkeypatch, capsys):
    """An adapter with nonzero b on every q, k, v and ffn_down weight (the
    q/k rows matter: they are merged in file order); the dense bf16 model
    the CLI loads, greedy, as JAX's CLI runs it."""
    rng = np.random.default_rng(4)
    E = Q4K.n_embd
    ab = {}
    for i in range(Q4K.n_layer):
        for name, (n, k) in (("attn_q.weight", (E, E)), ("attn_k.weight", (E, E)), ("attn_v.weight", (E, E)),
                             ("ffn_down.weight", (E, Q4K.n_ff))):
            ab[f"blk.{i}.{name}"] = {"a": torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32) * 0.5),
                                     "b": torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32) * 0.5)}
    adapter = tmp_path / "a.gguf"
    lora.save_lora_gguf(adapter, ab, alpha=4.0, base_arch="llama")
    argv = [str(q4k_llama), "-p", "5 17 200 3 9", "-n", "8", "--top-k", "1", "--seed", "0", "--lora", str(adapter)]
    monkeypatch.setattr(sys, "argv", ["generate"] + argv)
    jcli.main()
    want = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.startswith(argv[2]) and len(got[len(argv[2]):].split()) == 8, (got, want)
    cli.main(argv[:-2] + ["--device", "cpu"])  # the adapter moves the text
    assert capsys.readouterr().out != got
    # the merge, with no permutation of q and k: W + scale * B @ A on the file's rows
    m = llama.Llama.from_gguf(q4k_llama, dtype=torch.float32, keep_quantized=False, device="cpu")
    merged = lora.apply_lora_to_params(m.params, adapter, cfg=m.cfg)
    w = m.params["blk.0.attn_q.weight"] + ab["blk.0.attn_q.weight"]["b"] @ ab["blk.0.attn_q.weight"]["a"]
    torch.testing.assert_close(merged["blk.0.attn_q.weight"], w, rtol=0, atol=0)
    with pytest.raises(SystemExit, match="quantized"):
        cli.main(argv + ["--quantized", "--device", "cpu"])
