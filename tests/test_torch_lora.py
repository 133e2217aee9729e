"""LoRA in the port (ggml_tpu_torch.opt.lora, models.common.LoRAWeight, the
adapter GGUF, generate --lora) against the JAX package.

- init_lora: `a` equals JAX's bit for bit (the same numpy draws in the same
  order), b is zero, and the adapted model is the base (merged or wrapped).
- LoRAWeight's linear() against JAX's over a dense f32 base and a planar
  base: NMSE <= 1e-10 (f32 products in another order; the planar base
  rounds the same x to bf16 in both).
- An adapter GGUF written by either package is read by the other bit for
  bit, and the two writers write the same bytes.
- merge_lora and apply_lora_to_params: W + scale * B @ A in f32, within
  rtol 1e-6 of JAX's (numpy's and torch's f32 products may round apart).
- Dense-base finetune_lora of a tiny f32 GPT-2 and a tiny f32 GPT-J (its q/k
  rows in file order), 10 AdamW steps at lr 3e-3: losses within 1e-4 of
  JAX's, as test_torch_finetune.py holds full-weight finetuning.
- generate --lora on GPT-J: the port loads q and k with their rows permuted
  for RoPE and gives the adapter's b rows the same permutation.  The CLI's
  text is the port model's; in f32 that model generates JAX's ids from a
  model loaded in file order (rope_deinterleaved=False), where JAX's merge
  is right, with logits within NMSE 1e-10; JAX's default load merges the
  file-order adapter into permuted rows and its logits leave the port's
  (NMSE > 1e-4).  The text is compared in f32: in bf16 two of JAX's logits
  tie exactly at the 12th token (16 and 158 here), where the port's do not.
- The finetune CLI's QLoRA run on a tiny GPT-J Q4_K file, then generate
  --lora with the adapter it wrote.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.gguf import GGUFFile as JaxGGUFFile
from ggml_tpu.kernels import qmatmul as jqmatmul
from ggml_tpu.models import common as jcommon
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import finetune_lora as jax_finetune_lora
from ggml_tpu.opt import lora as jlora
from ggml_tpu.quant import planar as jplanar
from ggml_tpu_torch.cli import finetune as ft_cli
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.models import common, gpt2, gptj
from ggml_tpu_torch.opt import AdamWConfig, finetune_lora, lora
from ggml_tpu_torch.quant.planar import repack
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    nmse, one_thread, random_raw, tiny_gpt2_gguf, tiny_gptj_f32_gguf)

GPT2_SHAPE = dict(n_vocab=64, n_ctx=32, n_embd=32, n_head=4, n_layer=2)
GPTJ_CFG = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_layer=2, n_rot=32)


def _pattern(n):
    return np.asarray(([7, 11, 23, 42, 5] * (n // 5 + 1))[:n], np.int32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    gpt2_path = tiny_gpt2_gguf(d / "gpt2.gguf", GPT2_SHAPE, [f"t{i}" for i in range(GPT2_SHAPE["n_vocab"])], [])
    gptj_q4k = d / "gptj-q4k.gguf"
    gptj.write_random_gguf(gptj_q4k, GPTJ_CFG, seed=5)
    return dict(gpt2=gpt2_path, gptj=tiny_gptj_f32_gguf(d / "gptj-f32.gguf", GPTJ_CFG, seed=6), gptj_q4k=gptj_q4k)


def _both_params(path, keep_quantized=False):
    with GGUFFile(path) as g:
        tp = gpt2.load_params(g, torch.float32, keep_quantized=keep_quantized, device="cpu")
    jp = jgpt2.load_params(JaxGGUFFile(str(path)), jnp.float32, keep_quantized=keep_quantized)
    return tp, jp


@pytest.mark.parametrize("which", ["gpt2", "gptj_q4k"])
def test_init_lora_is_the_identity_and_a_is_jax_bits(files, which):
    tp, jp = _both_params(files[which], keep_quantized=which == "gptj_q4k")
    want = jlora.init_lora(jp, 4, seed=3)
    got = lora.init_lora(tp, 4, seed=3)
    assert list(got) == list(want) and len(got) == 4 * 2 + (4 if which == "gptj_q4k" else 0)
    for name, ab in got.items():
        assert ab["a"].dtype == ab["b"].dtype == torch.float32
        np.testing.assert_array_equal(ab["a"].numpy().view(np.uint32), np.asarray(want[name]["a"]).view(np.uint32))
        assert ab["b"].shape == want[name]["b"].shape and not ab["b"].any()
    zero = torch.zeros((), dtype=torch.int32)
    fam = gpt2 if which == "gpt2" else gptj
    with GGUFFile(files[which]) as g:
        cfg = fam.config_from_gguf(g)
    toks = torch.from_numpy(_pattern(16)[None]).long()
    run = lambda p: fam.forward(p, cfg, toks, zero.expand(1), fam.init_cache(cfg, 1, 16, torch.float32, "cpu"),
                                zero)[0]
    base = run(tp)
    assert torch.equal(run(lora.wrap_lora(tp, got, 1.0)), base)
    if which == "gpt2":
        assert torch.equal(run(lora.merge_lora(tp, got, 1.0)), base)
    with pytest.raises(ValueError):
        lora.init_lora(tp, 4, targets=("no_such.weight",))


@pytest.mark.parametrize("base", ["dense", "planar-q4k"])
def test_lora_weight_linear_matches_jax(base):
    rng = np.random.default_rng(2)
    n, k, r = 96, 512, 4
    if base == "dense":
        w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
        tw, jw = torch.from_numpy(w), jnp.asarray(w)
    else:
        raw = random_raw(GGMLType.Q4_K, n, k, seed=4)
        tw, jw = repack(raw, GGMLType.Q4_K, (n, k)), jplanar.repack(raw, 12, (n, k), backend="numpy")
    a = rng.standard_normal((r, k)).astype(np.float32)
    b = rng.standard_normal((n, r)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 20, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    tl = common.LoRAWeight(tw, torch.from_numpy(a), torch.from_numpy(b), 0.5)
    jl = jcommon.LoRAWeight(jw, jnp.asarray(a), jnp.asarray(b), 0.5)
    assert tl.shape == jl.shape == (n, k) and tl.ndim == 2
    want = np.asarray(jcommon.linear(jnp.asarray(x), jl, jnp.asarray(bias)))
    got = common.linear(torch.from_numpy(x), tl, torch.from_numpy(bias))
    assert got.shape == (2, 20, n) and nmse(want, got.numpy()) <= 1e-10
    jqmatmul._selection_log.clear()


def _random_lora(names_shapes: dict, rank: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {name: {"a": rng.standard_normal((rank, k)).astype(np.float32),
                   "b": rng.standard_normal((n, rank)).astype(np.float32) * 0.05}
            for name, (n, k) in names_shapes.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_adapter_gguf_is_read_bit_for_bit_by_the_other(tmp_path, writer):
    ab = _random_lora({"blk.0.attn_qkv.weight": (96, 32), "blk.1.ffn_down.weight": (32, 128)}, 4, seed=7)
    paths = {"port": tmp_path / "port.gguf", "jax": tmp_path / "jax.gguf"}
    lora.save_lora_gguf(paths["port"], {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in ab.items()},
                        alpha=6.0, base_arch="gpt2")
    jlora.save_lora_gguf(paths["jax"], {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in ab.items()},
                         alpha=6.0, base_arch="gpt2")
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    path = paths[writer]
    got, alpha = lora.load_lora_gguf(path)
    want, jalpha = jlora.load_lora_gguf(path)
    assert alpha == jalpha == 6.0 and list(got) == list(want) == list(ab)
    for name in ab:
        for key in ("a", "b"):
            np.testing.assert_array_equal(got[name][key].numpy(), np.asarray(want[name][key]))
            np.testing.assert_array_equal(got[name][key].numpy(), ab[name][key])
    with pytest.raises(ValueError):  # a model file is not an adapter
        lora.load_lora_gguf(_model_file(tmp_path))


def _model_file(tmp_path):
    from ggml_tpu_torch.gguf import GGUFWriter

    w = GGUFWriter()
    w.add_string("general.architecture", "gpt2")
    w.add_tensor("x", np.ones(4, np.float32))
    w.write(tmp_path / "model.gguf")
    return tmp_path / "model.gguf"


def test_merge_and_apply_match_jax(files, tmp_path):
    tp, jp = _both_params(files["gpt2"])
    names = {n: tuple(tp[n].shape) for n in ("blk.0.attn_qkv.weight", "blk.1.ffn_down.weight")}
    ab = _random_lora(names, 4, seed=8)
    want = jlora.merge_lora(jp, {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in ab.items()}, 0.75)
    got = lora.merge_lora(tp, {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in ab.items()}, 0.75)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-7, err_msg=name)
    path = tmp_path / "adapter.gguf"
    lora.save_lora_gguf(path, {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in ab.items()}, alpha=8.0)
    want = jlora.apply_lora_to_params(jp, path)
    got = lora.apply_lora_to_params(tp, path)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-7, err_msg=name)
    assert not np.array_equal(got[next(iter(names))].numpy(), tp[next(iter(names))].numpy())


@pytest.mark.parametrize("which", ["gpt2", "gptj"])
def test_dense_finetune_lora_matches_jax(files, which, tmp_path):
    toks = _pattern(400)
    seq = 16 if which == "gpt2" else 32
    kw = dict(rank=4, seq_len=seq, batch=4, steps=10)
    want, jtrained = jax_finetune_lora(str(files[which]), toks, adamw=JaxAdamWConfig(alpha=3e-3), **kw)
    merged = tmp_path / "merged.gguf"
    got, trained = finetune_lora(str(files[which]), toks, adamw=AdamWConfig(alpha=3e-3), merged_out=merged,
                                 device="cpu", **kw)
    assert len(got) == 10 and np.abs(np.array(want) - np.array(got)).max() <= 1e-4, (want, got)
    assert got[-1] < got[0] and set(trained) == set(jtrained)
    with GGUFFile(merged) as g, GGUFFile(files[which]) as base:
        assert set(g.tensors) == set(base.tensors) and g.metadata["general.architecture"] == which
        name = next(iter(trained))
        np.testing.assert_array_equal(g.to_float32(name), lora.merge_lora(
            {name: torch.from_numpy(base.to_float32(name))}, {name: trained[name]})[name].numpy())


def _qk_adapter(path, cfg, seed: int):
    """An adapter with random, nonzero b on every q and k weight."""
    E = cfg.n_embd
    names = {f"blk.{i}.{w}": (E, E) for i in range(cfg.n_layer) for w in ("attn_q.weight", "attn_k.weight")}
    ab = _random_lora(names, 4, seed)
    lora.save_lora_gguf(path, {k: {kk: torch.from_numpy(v * 4) for kk, v in d.items()} for k, d in ab.items()},
                        alpha=4.0, base_arch="gptj")
    return path


def test_generate_lora_merges_qk_on_the_rows_it_was_trained_for(files, tmp_path, capsys):
    adapter = _qk_adapter(tmp_path / "qk.gguf", GPTJ_CFG, seed=9)
    prompt = "5 17 200 3 9 44"
    ids = np.asarray([[int(t) for t in prompt.split()]], np.int32)
    cli.main([str(files["gptj"]), "-p", prompt, "-n", "12", "--top-k", "1", "--lora", str(adapter), "--device", "cpu"])
    got = capsys.readouterr().out
    tm = gptj.GPTJ.from_gguf(files["gptj"], keep_quantized=False, max_seq=512, device="cpu")  # the CLI's load
    tm.params = lora.apply_lora_to_params(tm.params, adapter, cfg=tm.cfg)
    assert tm.cfg.rope_deinterleaved and got == prompt + " ".join(map(str, tm.generate(ids, 12))) + "\n"

    # against JAX in f32 (in bf16 two of JAX's logits tie exactly at the 12th token)
    jm = jgptj.GPTJ.from_gguf(str(files["gptj"]), dtype=jnp.float32, keep_quantized=False, rope_deinterleaved=False,
                              max_seq=512)
    jm.params = jlora.apply_lora_to_params(jm.params, adapter)
    tm = gptj.GPTJ.from_gguf(files["gptj"], dtype=torch.float32, keep_quantized=False, max_seq=512, device="cpu")
    tm.params = lora.apply_lora_to_params(tm.params, adapter, cfg=tm.cfg)
    want = [int(t) for t in jm.generate(ids, 12)]
    assert tm.generate(ids, 12) == want
    full = np.asarray([list(ids[0]) + want], np.int32)
    zero = torch.zeros((), dtype=torch.int32)
    port = gptj.forward(tm.params, tm.cfg, torch.from_numpy(full).long(), zero.expand(1),
                        tm.new_cache(torch.float32), zero, prefill=True)[0].numpy()

    def jax_logits(m):
        return np.asarray(jgptj.forward(m.params, m.cfg, jnp.asarray(full), jnp.zeros((1,), jnp.int32),
                                        m.new_cache(dtype=jnp.float32), jnp.int32(0), prefill=True)[0])

    # JAX's default load permutes q and k and merges the file-order adapter into them
    jd = jgptj.GPTJ.from_gguf(str(files["gptj"]), dtype=jnp.float32, keep_quantized=False, max_seq=512)
    jd.params = jlora.apply_lora_to_params(jd.params, adapter)
    assert nmse(jax_logits(jm), port) <= 1e-10 and nmse(jax_logits(jd), port) > 1e-4
    with pytest.raises(SystemExit, match="quantized"):
        cli.main([str(files["gptj"]), "--lora", str(adapter), "--quantized", "--device", "cpu"])


def test_qlora_cli_then_generate_with_its_adapter(files, tmp_path, capsys):
    np.save(tmp_path / "t.npy", _pattern(400))
    out, adapter = tmp_path / "merged.gguf", tmp_path / "a.gguf"
    ft_cli.main([str(files["gptj_q4k"]), str(out), "--tokens", str(tmp_path / "t.npy"), "--lora-rank", "4",
                 "--lora-quantized", "--lora-out", str(adapter), "--seq", "32", "--batch", "2", "--steps", "3",
                 "--lr", "1e-2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "final loss" in printed and f"adapter {adapter}" in printed
    got, alpha = lora.load_lora_gguf(adapter)
    assert alpha == 4.0 and len(got) == 6 * GPTJ_CFG.n_layer and any(ab["b"].any() for ab in got.values())
    with GGUFFile(out) as g:
        assert g.tensors["blk.0.attn_q.weight"].ggml_type == GGMLType.F32
    cli.main([str(files["gptj_q4k"]), "-p", "5 17 200", "-n", "4", "--top-k", "1", "--lora", str(adapter),
              "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("5 17 200") and len(text[len("5 17 200"):].split()) == 4
