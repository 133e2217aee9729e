"""The port's sampling (ggml_tpu_torch.sampling) and sampled decode against
the JAX package on the CPU, with data from numpy seeds.

JAX's and torch's random streams differ, so the filter (warp_logits) is held
against JAX's on the same logits, and the draws against the distribution it
defines: top_k = 1 is greedy, and the frequencies of many draws match
softmax(warp_logits) by a chi-square test.  A tiny GPT-J (E=512, synthesized
Q4_K planes) sampling with top_k = 1 gives the ids of the JAX greedy decode
loop (its jitted scan), and a seeded sampled generate repeats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.sampling import warp_logits as jax_warp_logits
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.sampling import greedy, sample_top_k_top_p, warp_logits
from tests.test_torch_rules import one_thread, params_to_numpy  # noqa: F401  (one_thread: the autouse fixture)

V = 512
CFG = dict(n_vocab=V, n_ctx=256, n_embd=512, n_head=4, n_layer=2, n_rot=32, rope_deinterleaved=True)


def _logits(seed: int, rows: int = 3, vocab: int = V) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((rows, vocab)) * 3).astype(np.float32)


# (temperature, top_k, top_p, repeat_penalty): the defaults, a sharper and a
# flatter temperature, every token in the top k with top_p = 0.99 and with a
# top_p no cumulative probability reaches (the cut-off index runs past the
# end: JAX's gather fills NaN and cuts nothing), the temperature's floor, and
# the repeat penalty over recent tokens.  (At top_p = 1 the cumulative sum
# reaches 1 a few tokens early or late with the order of its f32 sums.)
CASES = [(1.0, 40, 0.9, 1.0), (0.7, 10, 0.95, 1.0), (1.3, V, 0.99, 1.0), (1.3, V, 1.5, 1.0), (0.9, 30, 1.5, 1.0),
         (0.0, 5, 0.9, 1.0), (0.8, 40, 0.5, 1.3), (1.1, 100, 0.8, 0.7)]


@pytest.mark.parametrize("temperature,top_k,top_p,repeat_penalty", CASES)
def test_warp_logits_matches_jax(temperature, top_k, top_p, repeat_penalty):
    x = _logits(int(top_k + 100 * top_p + 10 * temperature))
    recent = np.random.default_rng(3).integers(0, V, (3, 16)).astype(np.int32) if repeat_penalty != 1.0 else None
    # op by op: jitted, the JAX filter cannot test a traced repeat_penalty
    want = np.asarray(jax_warp_logits.__wrapped__(jnp.asarray(x), temperature, top_k, top_p, repeat_penalty,
                                                  None if recent is None else jnp.asarray(recent)))
    got = warp_logits(torch.from_numpy(x), temperature, top_k, top_p, repeat_penalty,
                      None if recent is None else torch.from_numpy(recent)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    kept = ~np.isneginf(want)
    assert kept.any(axis=-1).all()
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)


def test_top_k_1_is_greedy():
    x = torch.from_numpy(_logits(7, rows=16))
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        tok, gen = sample_top_k_top_p(x, gen, temperature=0.8, top_k=1, top_p=0.95)
        assert tok.dtype == torch.long and torch.equal(tok, greedy(x))


def test_sampled_frequencies_match_the_warped_softmax():
    """20k draws from one fixed logit vector: the counts over the kept set
    against softmax(warp_logits) by a chi-square test (p > 1e-3, fixed
    seed), and no draw outside the kept set."""
    n, vocab = 20000, 64
    x = torch.from_numpy(_logits(11, rows=1, vocab=vocab))
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)
    probs = torch.softmax(warp_logits(x, **kw), dim=-1)[0].double().numpy()
    tok, _ = sample_top_k_top_p(x.expand(n, vocab), torch.Generator().manual_seed(1), **kw)
    counts = np.bincount(tok.numpy(), minlength=vocab)
    kept = probs > 0
    assert 2 <= kept.sum() < 20 and counts[~kept].sum() == 0
    assert scipy.stats.chisquare(counts[kept], probs[kept] * n).pvalue > 1e-3


@pytest.fixture(scope="module")
def models():
    jcfg = jgptj.GPTJConfig(**CFG)
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType.Q4_K, seed=0, dtype=jnp.float32)
    tparams = params_from_numpy(params_to_numpy(jparams), device="cpu")
    return (jgptj.GPTJ(jparams, jcfg, max_seq=64, batch=1),
            gptj.GPTJ(tparams, gptj.GPTJConfig(**CFG), max_seq=64, batch=1, device="cpu"))


def test_decode_sampled_top_k_1_gives_the_jax_greedy_ids(models):
    jm, tm = models
    prompt = np.random.default_rng(5).integers(0, V, (1, 5)).astype(np.int32)
    jl, jcache, n = jm.prefill(jm.new_cache(dtype=jnp.float32), prompt)
    jfirst = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
    _, want = jm.decode_greedy(jcache, jfirst, n, 6)
    logits, cache, n_past = tm.prefill(tm.new_cache(torch.float32), prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    assert int(first) == int(jfirst[0, 0])
    _, got = tm.decode_sampled(cache, first, n_past, 6, torch.Generator().manual_seed(2), temperature=0.8,
                               top_k=1, top_p=0.95)
    assert got.shape == (6, 1) and got[:, 0].tolist() == np.asarray(want)[:, 0].tolist()
    with pytest.raises(ValueError):  # a CUDA graph needs the card
        tm.decode_sampled(tm.new_cache(torch.float32), first, n_past, 2, torch.Generator(), graph=True)


def test_seeded_sampled_generate_repeats(models):
    _, tm = models
    prompt = np.random.default_rng(6).integers(0, V, (1, 4))
    sampler = lambda logits, gen: sample_top_k_top_p(logits, gen, temperature=1.5, top_k=50, top_p=0.98)
    runs = [tm.generate(prompt, 6, sampler=sampler, key=torch.Generator().manual_seed(9)) for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 6 and all(0 <= t < V for t in runs[0])
    # the on-device loop draws the same way from the same seed
    logits, cache, n_past = tm.prefill(tm.new_cache(), prompt)
    gen = torch.Generator().manual_seed(9)
    first, gen = sampler(logits, gen)
    _, ids = tm.decode_sampled(cache, first.reshape(-1, 1), n_past, 5, gen, temperature=1.5, top_k=50,
                               top_p=0.98)
    assert [int(first[0])] + ids[:, 0].tolist() == runs[0]
