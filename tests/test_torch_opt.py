"""The port's training pieces (ggml_tpu_torch.opt) against the JAX package's:
every loss and the fused cross entropy's backward, the Dataset's shuffle, and
the AdamW Optimizer training a tiny GPT-2 (1 layer, E=32) for 3 steps.

f32: the losses agree to NMSE 1e-10 (sums in another order); after 3 AdamW
steps m and v agree to NMSE 1e-10, params and accumulated gradients to 1e-9
(AdamW divides m by sqrt(v), which turns last-bit differences of small
gradients into relative ones); bf16 moments and what they move to 1e-6 (a
last-bit difference moves a few moments by one bf16 step); t and i_acc are
equal.  A bf16
forward and backward (flash attention, fused cross entropy, bf16 moments)
rounds at other places in the two packages; its losses over 4 steps stay
within 2e-3 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.models import gpt2 as jax_gpt2
from ggml_tpu.models.common import causal_mask as jax_causal_mask
from ggml_tpu.opt import dataset as jax_dataset
from ggml_tpu.opt import optimizer as jax_opt
from ggml_tpu.opt.finetune import make_lm_model_fn as jax_make_lm_model_fn
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.models import gpt2
from ggml_tpu_torch.opt import LOSS_TYPES, AdamWConfig, Dataset, Optimizer, make_lm_model_fn
from tests.test_torch_rules import nmse

SHAPE = dict(n_vocab=64, n_ctx=16, n_embd=32, n_head=4, n_layer=1)
B, T = 4, 16


@pytest.mark.parametrize("name", sorted(LOSS_TYPES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    out = rng.standard_normal((3, 5, 17)).astype(np.float32) * 3 + 1
    if name == "cross_entropy":
        lab = rng.dirichlet(np.ones(17), (3, 5)).astype(np.float32)
    elif name.startswith("cross_entropy_sparse"):
        lab = rng.integers(0, 17, (3, 5)).astype(np.int32)
    else:
        lab = rng.standard_normal((3, 5, 17)).astype(np.float32)
    want = float(jax_opt.LOSS_TYPES[name](jnp.asarray(out), jnp.asarray(lab)))
    got = LOSS_TYPES[name](torch.from_numpy(out), torch.from_numpy(lab))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert nmse(want, float(got)) <= 1e-10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_cross_entropy_backward_matches_jax(dtype):
    """dx in the logits' own type, equal to JAX's up to last bits (bf16: a
    rounding of the f32 value may land on the neighbouring bf16)."""
    rng = np.random.default_rng(1)
    out = rng.standard_normal((2, 6, 40)).astype(np.float32) * 2
    lab = rng.integers(0, 40, (2, 6)).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.grad(lambda x: jax_opt.loss_cross_entropy_sparse_fused(x, jnp.asarray(lab)) * 3.0)(
        jnp.asarray(out).astype(jd))
    x = torch.from_numpy(out).to(td).requires_grad_()
    (LOSS_TYPES["cross_entropy_sparse_fused"](x, torch.from_numpy(lab)) * 3.0).backward()
    assert x.grad.dtype == td
    assert nmse(np.asarray(want.astype(jnp.float32)), x.grad.float().numpy()) <= (1e-12 if dtype == "float32" else 1e-5)


def test_dataset_shuffles_and_batches_as_jax():
    data = np.arange(48 * 3).reshape(48, 3)
    labels = np.arange(48)
    want, got = jax_dataset.Dataset(data, labels, ndata_shard=2), Dataset(data, labels, ndata_shard=2)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        want.shuffle(r1, idata=40)
        got.shuffle(r2, idata=40)
        np.testing.assert_array_equal(got.perm, want.perm)
        for i in range(6):
            for a, b in zip(got.get_batch(i, 8), want.get_batch(i, 8)):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_gpt2.init_random_params(jax_gpt2.GPT2Config(**SHAPE), seed=1)
    rng = np.random.default_rng(2)
    batches = [(rng.integers(0, 64, (B, T)).astype(np.int32), rng.integers(0, 64, (B, T)).astype(np.int32))
               for _ in range(4)]
    # the JAX causal_mask caches its first result: made here, outside the
    # JAX optimizer's jit, so no tracer stays in that cache for later tests
    jax_causal_mask.cache_clear()
    jax_causal_mask(T)
    return jparams, batches


def _train(jparams, batches, steps, adamw, period=1, compute_dtype=None, train_flash=False,
           loss_type="cross_entropy_sparse"):
    """The same steps through both packages: (JAX optimizer, port optimizer, losses of each)."""
    jcfg, cfg = jax_gpt2.GPT2Config(**SHAPE), gpt2.GPT2Config(**SHAPE)
    jfn = jax_make_lm_model_fn(jax_gpt2, jcfg, T, B, compute_dtype=compute_dtype and jnp.bfloat16,
                               cast_logits_f32=compute_dtype is None, train_flash=train_flash)
    jopt = jax_opt.Optimizer(jfn, jparams, loss_type=loss_type, classify=False, opt_period=period,
                             adamw=jax_opt.AdamWConfig(**adamw))
    fn = make_lm_model_fn(gpt2, gpt2.GPT2Config(**SHAPE), T, B, compute_dtype=compute_dtype and torch.bfloat16,
                          cast_logits_f32=compute_dtype is None, train_flash=train_flash)
    opt = Optimizer(fn, params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, device="cpu"),
                    loss_type=loss_type, classify=False, opt_period=period, adamw=AdamWConfig(**adamw))
    losses = [], []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        losses[0].append(float(jopt.step(jnp.asarray(x), jnp.asarray(y))["loss"]))
        losses[1].append(float(opt.step(x, y)["loss"]))
    assert cfg.n_layer == jcfg.n_layer
    return jopt, opt, losses


@pytest.mark.parametrize("period,state_dtype", [(1, "float32"), (2, "float32"), (1, "bfloat16"),
                                                (2, "bfloat16")])
def test_adamw_steps_match_jax(tiny, period, state_dtype):
    """3 AdamW steps with weight decay: one update per step (period 1), or
    one after two accumulated micro-steps and a third pending (period 2).
    The key bias (the middle third of attn_qkv.bias) is left out: softmax
    ignores a shift shared by a row's scores, so its gradient is rounding
    noise, which AdamW's normalization turns into steps of +-alpha whose sign
    the two packages draw differently."""
    jparams, batches = tiny
    adamw = dict(alpha=3e-3, wd=0.01, state_dtype=state_dtype)
    jopt, opt, losses = _train(jparams, batches, 3, adamw, period)
    assert nmse(losses[0], losses[1]) <= 1e-12
    want, got = jopt.state_dict(), opt.state_dict()
    assert int(got["t"]) == int(want["t"]) == 3 // period
    assert int(got["i_acc"]) == int(want["i_acc"]) == 3 % period
    f32 = state_dtype == "float32"
    E = SHAPE["n_embd"]
    for key, gate in (("params", 1e-9 if f32 else 1e-6), ("m", 1e-10 if f32 else 1e-6),
                      ("v", 1e-10 if f32 else 1e-6), ("g_acc", 1e-9 if f32 else 1e-6)):
        for name in want[key]:
            w = np.asarray(want[key][name].astype(jnp.float32))
            g = got[key][name].float().numpy()
            assert got[key][name].dtype == getattr(torch, state_dtype if key in ("m", "v") else "float32")
            if name.endswith("attn_qkv.bias"):
                w, g = np.delete(w, np.s_[E:2 * E]), np.delete(g, np.s_[E:2 * E])
            if not w.any():
                assert not g.any(), (key, name)
                continue
            assert nmse(w, g) <= gate, (key, name, nmse(w, g))


def test_bf16_training_follows_jax(tiny):
    """The main path's configuration: bf16 forward and backward over f32
    masters, flash attention, fused cross entropy on bf16 logits, bf16
    moments."""
    jparams, batches = tiny
    _, opt, losses = _train(jparams, batches, 4, dict(alpha=1e-2, state_dtype="bfloat16"),
                            compute_dtype="bf16", train_flash=True, loss_type="cross_entropy_sparse_fused")
    assert np.abs(np.array(losses[0]) - np.array(losses[1])).max() <= 2e-3, losses
    assert all(p.dtype == torch.float32 for p in opt.params.values())


def test_optimizer_rejects_what_is_not_ported():
    params = {"w": torch.zeros(3)}
    with pytest.raises(NotImplementedError, match="parallel/"):
        Optimizer(lambda p, x: x, params, mesh=object())
    with pytest.raises(ValueError, match="not an argument-free"):  # the policies: tests/test_torch_remat.py
        make_lm_model_fn(gpt2, gpt2.GPT2Config(**SHAPE), T, B, remat_policy="dots_saveable_please")
