"""The port's GPT-2 (ggml_tpu_torch.models.gpt2) against the JAX GPT-2 on a
tiny f32 model (E=64, 4 heads, 2 layers) made from the same numpy draws.

The forward's two branches (attention over the cache window; the flash
training kernels' plain versions against JAX's interpret-mode Pallas), the
loss and every gradient through make_lm_model_fn with and without
train_flash, and greedy generation.  f32 throughout: the two packages differ
in the last bits of sums, exp and tanh, NMSE <= 1e-10 on logits, loss and
gradients; greedy tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.models import gpt2 as jax_gpt2
from ggml_tpu.models.common import causal_mask as jax_causal_mask
from ggml_tpu.opt.finetune import make_lm_model_fn as jax_make_lm_model_fn
from ggml_tpu.opt.optimizer import LOSS_TYPES as JAX_LOSS_TYPES
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.kernels import flash_attn
from ggml_tpu_torch.models import gpt2
from ggml_tpu_torch.opt.finetune import make_lm_model_fn
from ggml_tpu_torch.opt.optimizer import LOSS_TYPES
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (one_thread: the autouse fixture)

SHAPE = dict(n_vocab=96, n_ctx=32, n_embd=64, n_head=4, n_layer=2)
B, T = 2, 16


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_gpt2.GPT2Config(**SHAPE), gpt2.GPT2Config(**SHAPE)
    jparams = jax_gpt2.init_random_params(jcfg, seed=4)
    # non-trivial norms and biases, the same on both sides
    rng = np.random.default_rng(9)
    jparams = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)) if v.ndim == 1 else v
               for k, v in jparams.items()}
    jparams = {k: jnp.asarray(v) for k, v in jparams.items()}
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    # the JAX causal_mask caches its first result, a tracer where that call
    # ran under jit (the JAX optimizer's step, in another test): made anew
    # here, outside any trace
    jax_causal_mask.cache_clear()
    jax_causal_mask(T)
    return jcfg, jparams, cfg, params


def test_init_random_params_are_the_jax_draws():
    cfg = gpt2.GPT2Config(**SHAPE)
    got = gpt2.init_random_params(cfg, seed=2, device="cpu")
    want = jax_gpt2.init_random_params(jax_gpt2.GPT2Config(**SHAPE), seed=2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("train_flash", [False, True], ids=["cache-window", "flash"])
def test_forward_matches_jax(models, train_flash):
    jcfg, jparams, cfg, params = models
    tokens = np.random.default_rng(1).integers(0, SHAPE["n_vocab"], (B, T)).astype(np.int32)
    jcache = jax_gpt2.init_cache(jcfg, B, 24)
    want, _ = jax_gpt2.forward(jparams, jcfg, jnp.asarray(tokens), jnp.zeros((B,), jnp.int32), jcache,
                               jnp.int32(0), train_flash=train_flash)
    zero = torch.zeros((), dtype=torch.int32)
    cache = gpt2.init_cache(cfg, B, 24, device="cpu")
    got, cache = gpt2.forward(params, cfg, torch.from_numpy(tokens), zero.expand(B), cache, zero,
                              train_flash=train_flash)
    assert got.shape == (B, T, SHAPE["n_vocab"])
    assert nmse(np.asarray(want), got.numpy()) <= 1e-10
    assert bool(cache[0][0].any()) != train_flash  # the flash branch writes no cache


@pytest.mark.parametrize("train_flash,loss_type", [(False, "cross_entropy_sparse"),
                                                   (True, "cross_entropy_sparse_fused")],
                         ids=["cache-window", "flash"])
def test_loss_and_every_gradient_match_jax(models, train_flash, loss_type):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(2)
    x = rng.integers(0, SHAPE["n_vocab"], (B, T)).astype(np.int32)
    y = rng.integers(0, SHAPE["n_vocab"], (B, T)).astype(np.int32)
    jfn = jax_make_lm_model_fn(jax_gpt2, jcfg, T, B, train_flash=train_flash)
    want_loss, want_g = jax.value_and_grad(
        lambda p: JAX_LOSS_TYPES[loss_type](jfn(p, jnp.asarray(x)), jnp.asarray(y)))(jparams)
    fn = make_lm_model_fn(gpt2, cfg, T, B, train_flash=train_flash)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = LOSS_TYPES[loss_type](fn(leaves, torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert nmse(float(want_loss), float(loss.detach())) <= 1e-10
    for k in want_g:
        assert nmse(np.asarray(want_g[k]), leaves[k].grad.numpy()) <= 1e-10, (k, nmse(want_g[k], leaves[k].grad))


def test_generate_gives_the_jax_greedy_tokens(models):
    """Greedy tokens equal; prefill and one decode_step give JAX's logits."""
    jcfg, jparams, cfg, params = models
    prompt = np.array([[5, 17, 3, 60, 22]], np.int32)
    jm, m = jax_gpt2.GPT2(jparams, jcfg, max_seq=24), gpt2.GPT2(params, cfg, max_seq=24, device="cpu")
    assert m.generate(prompt, 10) == [int(t) for t in jm.generate(prompt, 10)]
    want, jcache, n = jm.prefill(jm.new_cache(), prompt)
    got, cache, n_got = m.prefill(m.new_cache(), prompt)
    assert n == n_got and nmse(np.asarray(want), got.numpy()) <= 1e-10
    want, _ = jm.decode_step(jcache, jnp.array([[9]], jnp.int32), n)
    got, _ = m.decode_step(cache, np.array([[9]]), n)
    assert got.shape == (1, SHAPE["n_vocab"]) and nmse(np.asarray(want), got.numpy()) <= 1e-10


def test_decode_loop_matches_stepwise(models):
    """The on-device decode loop (the step a CUDA graph captures, run eagerly
    on the CPU) gives the ids of decode_step by hand; graph=True needs the
    card."""
    _, _, cfg, params = models
    m = gpt2.GPT2(params, cfg, max_seq=24, device="cpu")
    prompt = np.array([[5, 17, 3, 60, 22]])
    logits, cache, n = m.prefill(m.new_cache(), prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    _, ids = m.decode_greedy(cache, first, n, 8, graph=False)
    _, cache, _ = m.prefill(m.new_cache(), prompt)
    tok, want = first, []
    for pos in range(n, n + 8):
        logits, cache = m.decode_step(cache, tok, pos)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        want.append(int(tok))
    assert ids.shape == (8, 1) and ids[:, 0].tolist() == want
    with pytest.raises(ValueError):
        m.decode_greedy(m.new_cache(), first, n, 2, graph=True)


def test_training_forward_computes_the_mask_ranges_once(models, monkeypatch):
    """train_flash computes the mask's tile ranges once per forward and hands
    the same tensor to every layer's K, L and M; logits and gradients are
    those of the old forward, whose layers were handed none."""
    _, _, cfg, params = models
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, SHAPE["n_vocab"], (B, T)))
    zero = torch.zeros((), dtype=torch.int32)

    def run():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        logits, _ = gpt2.forward(leaves, cfg, tokens, zero.expand(B), None, zero, train_flash=True)
        logits.square().mean().backward()
        return [logits.detach()] + [leaves[k].grad for k in sorted(leaves)]

    want = run()
    handed, masks = [], []
    attention, ranges_of = flash_attn.flash_attention_train, flash_attn.mask_ranges

    def old_attention(*args, ranges=None, **kw):
        handed.append(ranges)
        return attention(*args, **kw)

    monkeypatch.setattr(flash_attn, "flash_attention_train", old_attention)
    monkeypatch.setattr(flash_attn, "mask_ranges", lambda mask: masks.append(mask) or ranges_of(mask))
    assert all(torch.equal(g, w) for g, w in zip(run(), want))
    assert len(masks) == 1 and len(handed) == SHAPE["n_layer"] and all(r is handed[0] for r in handed)


def test_gelu_fp16_matches_jax():
    """XLA's CPU tanh differs from torch's near -1 by f32 ulps, which 1 + tanh
    turns into relative differences of a few 1e-3 for large negative inputs,
    where gelu is below 3e-4: max |difference| 1e-4, NMSE <= 1e-10."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 4
    want = np.asarray(jax_gpt2._gelu_fp16(jnp.asarray(x)))
    got = gpt2._gelu_fp16(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4
    assert nmse(want, got) <= 1e-10
