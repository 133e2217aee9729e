"""The port's Llama family (ggml_tpu_torch.models.llama) against the JAX
Llama on the same parameters, on the CPU.

Dense f32 parameters drawn with numpy (norm weights near 1, biases and
q/k-norm weights where the variant has them) go through both packages
(convert.params_from_numpy).  Each forward variant runs a 6-token prefill
and 3 decode steps, the port fed the JAX run's greedy tokens, against the
JAX forward run op by op: 2 layers, widths 64-128, GQA 4/2.  The two sides
differ in last bits only (XLA's and PyTorch's sums, rsqrt, sin, cos and
silu): logits NMSE <= 1e-10 at every step (1e-13 measured).  The flash
prefill (kernel J's plain version against the JAX Pallas kernel in
interpret mode) and greedy generation are held the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.models import llama as jllama
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.gguf import GGUFFile, GGUFWriter
from ggml_tpu_torch.kernels import flash_attn
from ggml_tpu_torch.models import gptj, llama, registry
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (one_thread: the autouse fixture)

BASE = dict(n_vocab=96, n_ctx=128, n_embd=128, n_head=4, n_head_kv=2, n_layer=2, n_ff=192, rope_base=500000.0)
# variant -> (config changes, parameter options)
VARIANTS = {
    "gqa": ({}, {}),
    "qwen2-biases-tied": ({}, dict(biases=True, tied=True)),
    "qwen3-qk-norm-head-dim": (dict(n_embd=96, qk_norm=True, head_dim_override=48), {}),
    "granite-scales": (dict(embd_scale=12.0, resid_scale=0.22, attn_scale=0.0078125, logit_scale=8.0), {}),
    "smollm3-nope": (dict(nope_interval=2), {}),
    "ernie4_5-interleaved": (dict(rope_interleaved=True), {}),
    "yarn": (dict(rope_scaling="yarn", rope_scale=4.0, n_ctx_orig=32), {}),
}
MAX_SEQ = 16


def random_params(cfg, seed: int = 0, biases: bool = False, tied: bool = False) -> dict:
    """numpy f32 parameters of a llama-family model in the GGUF naming."""
    rng = np.random.default_rng(seed)
    w = lambda *shape, s=0.05: (rng.standard_normal(shape) * s).astype(np.float32)
    near_one = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    E, hd = cfg.n_embd, cfg.head_dim
    p = {"token_embd.weight": w(cfg.n_vocab, E, s=0.5), "output_norm.weight": near_one(E)}
    if not tied:
        p["output.weight"] = w(cfg.n_vocab, E)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        p[pre + "attn_norm.weight"] = near_one(E)
        for name, n in (("attn_q", cfg.n_head * hd), ("attn_k", cfg.n_head_kv * hd), ("attn_v", cfg.n_head_kv * hd)):
            p[pre + name + ".weight"] = w(n, E)
            if biases:
                p[pre + name + ".bias"] = w(n, s=0.1)
        if cfg.qk_norm:
            p[pre + "attn_q_norm.weight"] = near_one(hd)
            p[pre + "attn_k_norm.weight"] = near_one(hd)
        p[pre + "attn_output.weight"] = w(E, cfg.n_head * hd)
        p[pre + "ffn_norm.weight"] = near_one(E)
        p[pre + "ffn_gate.weight"] = w(cfg.n_ff, E)
        p[pre + "ffn_up.weight"] = w(cfg.n_ff, E)
        p[pre + "ffn_down.weight"] = w(E, cfg.n_ff)
    return p


def models(variant: str, **changes):
    over, opts = VARIANTS[variant]
    kw = dict(BASE, **over, **changes)
    p = random_params(jllama.LlamaConfig(**kw), **opts)
    jm = jllama.Llama({k: jnp.asarray(v) for k, v in p.items()}, jllama.LlamaConfig(**kw), max_seq=MAX_SEQ)
    tm = llama.Llama(params_from_numpy(p, device="cpu"), llama.LlamaConfig(**kw), max_seq=MAX_SEQ, device="cpu")
    return jm, tm


def _prompt(t: int, vocab: int = BASE["n_vocab"]):
    return np.random.default_rng(100 + t).integers(0, vocab, (1, t)).astype(np.int32)


def jax_prefill(jm, prompt):
    cache = jm.new_cache(dtype=jnp.float32)
    return jllama.forward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32), cache, jnp.int32(0),
                          prefill=True)


def port_prefill(tm, prompt, cfg=None):
    zero = torch.zeros((), dtype=torch.int32)
    logits, cache = llama.forward(tm.params, cfg or tm.cfg, torch.from_numpy(prompt).long(), zero.expand(1),
                                  tm.new_cache(torch.float32), zero, prefill=True)
    return logits.numpy(), cache


def teacher_forced(jm, tm, prompt, n_steps: int):
    """Prefill both sides, then n_steps decode steps both fed the JAX side's
    greedy token; yields (jax logits, port logits), the prefill first."""
    jl, jcache = jax_prefill(jm, prompt)
    tl, tcache = port_prefill(tm, prompt)
    yield np.asarray(jl), tl
    for n_past in range(prompt.shape[1], prompt.shape[1] + n_steps):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        jl, jcache = jllama.forward(jm.params, jm.cfg, jnp.asarray([[tok]], jnp.int32),
                                    jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
        pos = torch.tensor(n_past, dtype=torch.int32)
        tl = llama.forward(tm.params, tm.cfg, torch.tensor([[tok]]), pos.expand(1), tcache, pos)[0].numpy()
        yield np.asarray(jl), tl


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jm, tm = models(variant)
    steps = list(teacher_forced(jm, tm, _prompt(6), 3))
    assert len(steps) == 4 and steps[0][1].shape == (1, 6, BASE["n_vocab"])
    for step, (jl, tl) in enumerate(steps):
        assert nmse(jl, tl) <= 1e-10, (variant, step, nmse(jl, tl))


def _meta_gguf(path, arch: str):
    """A GGUF of llama-family metadata under arch's key prefix (no tensors)."""
    w = GGUFWriter()
    w.add_string("general.architecture", arch)
    for key, val in (("context_length", 4096), ("embedding_length", 2048), ("attention.head_count", 16),
                     ("attention.head_count_kv", 4), ("block_count", 24), ("feed_forward_length", 5632),
                     ("vocab_size", 49152), ("attention.key_length", 256), ("no_rope_layer_interval", 4),
                     ("rope.scaling.original_context_length", 2048)):
        w.add_u32(f"{arch}.{key}", val)
    for key, val in (("rope.freq_base", 1e6), ("attention.layer_norm_rms_epsilon", 1e-6), ("embedding_scale", 12.0),
                     ("residual_scale", 0.22), ("attention.scale", 0.0078125), ("logit_scale", 8.0),
                     ("rope.scaling.factor", 4.0)):
        w.add_f32(f"{arch}.{key}", val)
    w.add_string(f"{arch}.rope.scaling.type", "yarn")
    if arch.endswith("moe"):
        w.add_u32(f"{arch}.expert_count", 8)
        w.add_u32(f"{arch}.expert_used_count", 2)
    w.write(path)
    return path


@pytest.mark.parametrize("arch", ["llama", "qwen2", "qwen3", "granite", "smollm3", "ernie4_5", "helium", "seed_oss",
                                  "qwen2moe", "qwen3moe", "granitemoe"])
def test_config_from_gguf_matches_jax(tmp_path, arch):
    path = _meta_gguf(tmp_path / f"{arch}.gguf", arch)
    with GGUFFile(path) as g:
        got = llama.config_from_gguf(g)
    jg = JGGUFFile(path)
    want = jllama.config_from_gguf(jg)
    jg.close()
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.head_dim == want.head_dim
    assert registry.model_class(arch) is llama.Llama
    if arch.endswith("moe"):  # the experts are read and served (tests/test_torch_moe.py); jetmoe's block is not ported
        assert (got.n_expert, got.n_expert_used) == (8, 2) and llama.Llama({}, got, device="cpu").cfg is got
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            registry.model_class("jetmoe")


@pytest.mark.parametrize("kind", ["none", "linear", "yarn", "interleaved"])
def test_rope_matches_jax(kind):
    """The rotate-half RoPE unscaled, with linear interpolation and with
    YaRN, and the interleaved RoPE of ernie4_5, at positions up to the end of
    an 8192 context (angles of up to 8191 rad, whose sin and cos differ
    between XLA and PyTorch in the last bits): NMSE <= 1e-12."""
    x = np.random.default_rng(7).standard_normal((2, 5, 3, 64)).astype(np.float32)
    positions = np.array([[0, 1, 30, 31, 32], [4000, 6000, 8189, 8190, 8191]], np.int32)
    cfg = dict(n_embd=192, n_head=3, n_ctx=8192, rope_base=500000.0)
    cfg.update({"linear": dict(rope_scaling="linear", rope_scale=2.0),
                "yarn": dict(rope_scaling="yarn", rope_scale=4.0, n_ctx_orig=2048)}.get(kind, {}))
    jcfg, tcfg = jllama.LlamaConfig(**cfg), llama.LlamaConfig(**cfg)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(positions)
    if kind == "interleaved":
        want = jgptj._rope_interleaved(jnp.asarray(x), jnp.asarray(positions), 64, 500000.0)
        got = gptj._rope_interleaved(tx, *gptj.rope_angles(tpos, 64, 500000.0), 64)
    else:
        want = jllama._rope_half_scaled(jnp.asarray(x), jnp.asarray(positions), jcfg)
        got = llama._rope_half(tx, *llama._rope_half_angles(tpos, tcfg))
    assert nmse(np.asarray(want), got.numpy()) <= 1e-12


def test_llamacpp_permutation_and_its_inverse_match_jax():
    w = np.random.default_rng(3).standard_normal((4 * 16, 24)).astype(np.float32)
    for n_head in (4, 2):
        permuted = llama.permute_llamacpp_qk(torch.from_numpy(w), n_head)
        np.testing.assert_array_equal(permuted.numpy(), np.asarray(jllama.permute_llamacpp_qk(jnp.asarray(w), n_head)))
        back = llama.unpermute_llamacpp_qk(permuted, n_head)
        np.testing.assert_array_equal(back.numpy(), w)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jllama.unpermute_llamacpp_qk(
            jllama.permute_llamacpp_qk(jnp.asarray(w), n_head), n_head)))


def test_flash_prefill_matches_jax_and_the_plain_attention(monkeypatch):
    """use_flash_prefill on both sides, GQA 4/2: the current tokens through
    J's plain version here and the Pallas kernel (interpret mode) there,
    the mask ranges computed once per forward; against the port's own
    plain-attention prefill too, and the cache written all the same."""
    jm, tm = models("gqa", use_flash_prefill=True)
    prompt = _prompt(12)
    calls = {"ranges": 0}
    real = flash_attn.mask_ranges
    monkeypatch.setattr(flash_attn, "mask_ranges",
                        lambda m: calls.__setitem__("ranges", calls["ranges"] + 1) or real(m))
    jl, jcache = jax_prefill(jm, prompt)
    tl, tcache = port_prefill(tm, prompt)
    assert calls["ranges"] == 1
    assert nmse(np.asarray(jl), tl) <= 1e-10
    plain, plain_cache = port_prefill(tm, prompt, dataclasses.replace(tm.cfg, use_flash_prefill=False))
    assert nmse(plain, tl) <= 1e-10
    for (k, v), (pk, pv), (jk, jv) in zip(tcache, plain_cache, jcache):
        assert nmse(np.asarray(jk)[:, :, :12], k[:, :, :12].numpy()) <= 1e-12
        assert nmse(np.asarray(jv)[:, :, :12], v[:, :, :12].numpy()) <= 1e-12
        assert nmse(pk.numpy(), k.numpy()) <= 1e-12 and not k[:, :, 12:].any()


def test_generate_matches_jax_and_sampled_decode_repeats():
    """Greedy generate (the port's decode loop, eager on the CPU) gives the
    JAX generate's ids; the on-device sampled loop gives the same ids twice
    from one seed, and the greedy ids at top_k = 1."""
    jm, tm = models("gqa")
    prompt = _prompt(5)
    want = jm.generate(prompt, 8)
    assert tm.generate(prompt, 8) == want
    logits, cache, n_past = tm.prefill(tm.new_cache(torch.float32), prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    _, ids = tm.decode_greedy(cache, first, n_past, 7)
    assert [int(first[0, 0])] + ids[:, 0].tolist() == want
    runs = []
    for top_k in (40, 40, 1):
        logits, cache, n_past = tm.prefill(tm.new_cache(torch.float32), prompt)
        gen = torch.Generator().manual_seed(5)
        _, ids = tm.decode_sampled(cache, first, n_past, 7, gen, temperature=0.8, top_k=top_k, top_p=0.95)
        runs.append(ids[:, 0].tolist())
    assert runs[0] == runs[1] and runs[2] == want[1:]
    with pytest.raises(ValueError, match="exceed"):
        tm.decode_greedy(cache, first, n_past, MAX_SEQ)
    with pytest.raises(ValueError, match="CUDA graph"):
        tm.decode_greedy(cache, first, n_past, 2, graph=True)
