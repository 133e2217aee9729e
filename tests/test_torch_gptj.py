"""The port's GPT-J slice (ggml_tpu_torch.models.gptj) against the JAX GPTJ
on the same parameters, on the CPU.

A tiny GPT-J at E=512 (K=512 is the smallest width whose Q4_K weights take
the compact planes in both packages), with synthesized Q4_K planes from the
JAX package carried over as numpy.  Prefill of 40 tokens runs the M>32
matmul (kernel C), of 5 tokens the 2..32-row GEMV (kernel B); the 16 decode
steps run the M=1 GEMV (kernel A) and the decode attention (kernel D).
The JAX side is its forward (Pallas kernels in interpret mode), run op by
op at prefill and jitted at decode (jax_decode_step).
Gates: logits NMSE <= 1e-6 at prefill and at every decode step, and the 16
greedy tokens of both sides equal, each side decoding its own tokens.
"""

import dataclasses
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.models import gptj as jgptj
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.kernels import flash_attn
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.sampling import sample_top_k_top_p
from tests.test_torch_rules import nmse, one_thread, params_to_numpy  # noqa: F401  (the autouse fixture)

CFG = dict(n_vocab=512, n_ctx=256, n_embd=512, n_head=4, n_layer=2, n_rot=32,
           rope_deinterleaved=True)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    jcfg = jgptj.GPTJConfig(**CFG)
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType.Q4_K, seed=0, dtype=jnp.float32)
    tparams = params_from_numpy(params_to_numpy(jparams), device="cpu")
    jm = jgptj.GPTJ(jparams, jcfg, max_seq=MAX_SEQ, batch=1)
    tm = gptj.GPTJ(tparams, gptj.GPTJConfig(**CFG), max_seq=MAX_SEQ, batch=1, device="cpu")
    return jm, tm


def _prompt(t: int):
    return np.random.default_rng(t).integers(0, CFG["n_vocab"], (1, t)).astype(np.int32)


_JAX_PREFILLS = weakref.WeakKeyDictionary()  # JAX model -> {prompt: (logits, cache)}


def _jax_prefill(jm, prompt):
    """JAX prefill through its forward run op by op.  Kept per model and
    prompt, so that a prefill test and a decode test of one prompt share one
    JAX run (its arrays are immutable, and forward donates no buffer)."""
    runs = _JAX_PREFILLS.setdefault(jm, {})
    key = (prompt.shape, prompt.tobytes())
    if key not in runs:
        cache = jm.new_cache(dtype=jnp.float32)
        runs[key] = jgptj.forward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32), cache,
                                  jnp.int32(0), prefill=True)
    return runs[key]


def _port_prefill(tm, prompt):
    cache = tm.new_cache(dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.int32)
    logits, cache = gptj.forward(tm.params, tm.cfg, torch.from_numpy(prompt).long(), zero.expand(1), cache,
                                 zero, prefill=True)
    return logits.numpy(), cache


@pytest.mark.parametrize("t", [40, 5], ids=["prefill40-matmul", "prefill5-gemv"])
def test_prefill_logits_match_jax(models, t):
    jm, tm = models
    prompt = _prompt(t)
    want, _ = _jax_prefill(jm, prompt)
    got, _ = _port_prefill(tm, prompt)
    assert got.shape == want.shape == (1, t, CFG["n_vocab"])
    assert nmse(np.asarray(want), got) <= 1e-6


@pytest.mark.parametrize("layout", ["interleaved", "deinterleaved"])
def test_rope_matches_jax(layout):
    """Both RoPE layouts: ggml mode 0 on interleaved pairs, and the layout of
    q/k weights whose output columns were permuted at load."""
    x = np.random.default_rng(7).standard_normal((1, 6, 4, 128)).astype(np.float32)
    positions = np.arange(30, 36, dtype=np.int32)[None]
    want = getattr(jgptj, f"_rope_{layout}")(jnp.asarray(x), jnp.asarray(positions), 32)
    cos, sin = gptj.rope_angles(torch.from_numpy(positions), 32)
    got = getattr(gptj, f"_rope_{layout}")(torch.from_numpy(x), cos, sin, 32)
    assert nmse(np.asarray(want), got.numpy()) <= 1e-12
    np.testing.assert_array_equal(gptj.rope_permutation(128, 4, 32), jgptj.rope_permutation(128, 4, 32))


_PORT_STEPS = weakref.WeakKeyDictionary()  # port model -> {(prompt, n_steps): [(logits, token)]}


def port_greedy_steps(tm, prompt, n_steps: int) -> list:
    """The port's prefill (f32 cache), then n_steps greedy forward() steps
    by hand, each feeding back its own token: [(logits, token)] a step.  Kept
    per model, prompt and length, so that the decode test against JAX and
    the decode loop's test share one run."""
    runs = _PORT_STEPS.setdefault(tm, {})
    key = (prompt.shape, prompt.tobytes(), n_steps)
    if key not in runs:
        tl, tcache = _port_prefill(tm, prompt)
        tok, steps = int(np.argmax(tl[0, -1])), []
        pos = torch.tensor(prompt.shape[1], dtype=torch.int32)
        for _ in range(n_steps):
            tl = gptj.forward(tm.params, tm.cfg, torch.tensor([[tok]]), pos.expand(1), tcache, pos)[0].numpy()
            pos += 1
            tok = int(np.argmax(tl[0, -1]))
            steps.append((tl, tok))
        runs[key] = steps
    return runs[key]


# the JAX forward's decode step, jitted: one compile a model replaces 10-20 s
# a step of op-by-op interpret-mode kernels.  Over Q4_K planes (this file's
# model and test_torch_gguf.py's) a step's logits under jit equal op by op's
# bit for bit; a prefill's do not, nor a step's over int8 planes, so
# _jax_prefill and test_torch_gptj_q8.teacher_forced_decode stay op by op
_jax_decode = jax.jit(jgptj.forward, static_argnums=(1,))


def jax_decode_step(jm, tok: int, n_past: int, jcache):
    """One JAX decode step of token tok at n_past: (logits, cache)."""
    return _jax_decode(jm.params, jm.cfg, jnp.asarray([[tok]], jnp.int32), jnp.full((1,), n_past, jnp.int32),
                       jcache, jnp.int32(n_past))


def greedy_decode_both(jm, tm, prompt, n_steps: int):
    """Prefill both sides, then greedy-decode n_steps on each, each side
    feeding back its own token; yields (jax logits, port logits, jax token,
    port token) per step."""
    jl, jcache = _jax_prefill(jm, prompt)
    jtok = int(np.argmax(np.asarray(jl)[0, -1]))
    t = prompt.shape[1]
    for n_past, (tl, ttok) in zip(range(t, t + n_steps), port_greedy_steps(tm, prompt, n_steps)):
        jl, jcache = jax_decode_step(jm, jtok, n_past, jcache)
        jl = np.asarray(jl)
        jtok = int(np.argmax(jl[0, -1]))
        yield jl, tl, jtok, ttok


def test_greedy_decode_matches_jax(models):
    jm, tm = models
    steps = list(greedy_decode_both(jm, tm, _prompt(5), 16))
    assert len(steps) == 16
    for step, (jl, tl, jtok, ttok) in enumerate(steps):
        assert nmse(jl, tl) <= 1e-6, (step, nmse(jl, tl))
        assert jtok == ttok, step


def test_decode_loop_matches_stepwise(models):
    """The wrapper's on-device loop (position, tokens, step index and ids
    kept on the device: the step a CUDA graph captures, run eagerly on the
    CPU) gives the ids of stepping forward() by hand."""
    _, tm = models
    prompt = _prompt(5)
    cache = tm.new_cache(dtype=torch.float32)
    logits, cache, n_past = tm.prefill(cache, prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    _, ids = tm.decode_greedy(cache, first, n_past, 16)
    want = [tok for _, tok in port_greedy_steps(tm, prompt, 16)]  # the run test_greedy_decode_matches_jax holds
    assert ids.shape == (16, 1) and ids[:, 0].tolist() == want
    with pytest.raises(ValueError):  # a CUDA graph needs the card
        tm.decode_greedy(tm.new_cache(torch.float32), first, n_past, 2, graph=True)

    # generate: prefill + the same loop over the model's default (bf16) cache
    logits, cache, n_past = tm.prefill(tm.new_cache(), prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    _, ids = tm.decode_greedy(cache, first, n_past, 16)
    assert tm.generate(prompt, 17) == [int(first)] + ids[:, 0].tolist()


def test_flash_prefill_computes_the_mask_ranges_once(models, monkeypatch):
    """The flash prefill computes the mask's tile ranges once per forward and
    hands the same tensor to every layer; its logits are those of the old
    forward, whose flash calls were handed none."""
    _, tm = models
    cfg = dataclasses.replace(tm.cfg, use_flash_prefill=True)
    toks = torch.from_numpy(_prompt(40)).long()
    zero = torch.zeros((), dtype=torch.int32)
    run = lambda: gptj.forward(tm.params, cfg, toks, zero.expand(1), tm.new_cache(torch.float32), zero,
                               prefill=True)[0]
    want = run()
    handed, masks = [], []
    attention, ranges_of = flash_attn.flash_attention, flash_attn.mask_ranges

    def old_attention(*args, ranges=None, **kw):
        handed.append(ranges)
        return attention(*args, **kw)

    monkeypatch.setattr(flash_attn, "flash_attention", old_attention)
    monkeypatch.setattr(flash_attn, "mask_ranges", lambda mask: masks.append(mask) or ranges_of(mask))
    assert torch.equal(run(), want)
    assert len(masks) == 1 and len(handed) == CFG["n_layer"] and all(r is handed[0] for r in handed)
    assert torch.equal(handed[0], ranges_of(masks[0]))


def test_generate_and_limits(models):
    _, tm = models
    out = tm.generate(_prompt(3), 6)
    assert len(out) == 6 and all(0 <= t < CFG["n_vocab"] for t in out)
    sampled = tm.generate(_prompt(3), 4, sampler=lambda logits, gen: sample_top_k_top_p(logits, gen, top_k=8),
                          key=torch.Generator().manual_seed(0))
    assert len(sampled) == 4 and all(0 <= t < CFG["n_vocab"] for t in sampled)
    with pytest.raises(ValueError):
        tm.decode_greedy(tm.new_cache(torch.float32), torch.zeros((1, 1), dtype=torch.long),
                         MAX_SEQ - 2, 3)
    zero = torch.zeros((), dtype=torch.int32)
    toks = torch.zeros((1, 4), dtype=torch.long)
    flash = dataclasses.replace(tm.cfg, use_flash_prefill=True)
    logits, _ = gptj.forward(tm.params, flash, toks, zero.expand(1), tm.new_cache(torch.float32), zero,
                             prefill=True)
    assert logits.shape == (1, 4, CFG["n_vocab"]) and bool(torch.isfinite(logits).all())
    # per-slot cache positions (batched serving): a (b,) cache_len gives the 0-d position's logits bit for bit
    per_row, _ = gptj.forward(tm.params, tm.cfg, toks, zero.expand(1), tm.new_cache(torch.float32), zero.expand(1))
    shared, _ = gptj.forward(tm.params, tm.cfg, toks, zero.expand(1), tm.new_cache(torch.float32), zero)
    assert torch.equal(per_row, shared)


def test_gelu_fp16_logits_match_jax(models):
    """GPT-J with the reference CPU's fp16-table gelu (gelu_fp16=True) against
    the JAX forward run op by op, a 5-token prefill, at the tolerance of
    test_torch_gpt2.py test_gelu_fp16_matches_jax: logits NMSE <= 1e-10 (XLA's
    tanh differs from torch's by f32 ulps, which may move an fp16 rounding of
    gelu; on this model none moves); the logits differ from the model's
    without it."""
    jm, tm = models
    prompt = _prompt(5)
    jcfg, cfg = dataclasses.replace(jm.cfg, gelu_fp16=True), dataclasses.replace(tm.cfg, gelu_fp16=True)
    want, _ = jgptj.forward(jm.params, jcfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32),
                            jm.new_cache(dtype=jnp.float32), jnp.int32(0), prefill=True)
    zero = torch.zeros((), dtype=torch.int32)
    got = gptj.forward(tm.params, cfg, torch.from_numpy(prompt).long(), zero.expand(1),
                       tm.new_cache(dtype=torch.float32), zero, prefill=True)[0].numpy()
    assert nmse(np.asarray(want), got) <= 1e-10
    plain, _ = _port_prefill(tm, prompt)
    assert nmse(plain, got) > 0
