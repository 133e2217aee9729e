"""Port kernels K, L and M (ggml_tpu_torch.kernels.flash_attn: the training
forward with its LSE, dq, dk/dv) against the JAX flash_attention_train on the
same inputs.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do on
the CPU; the port runs its plain PyTorch versions (CPU tensors) through its
autograd Function.  f32 inputs differ only in the last bits of dots, exp and
sums: NMSE <= 1e-10.  bf16 inputs have p rounded to bf16 before p @ v against
a running max that depends on the kv tile (the JAX wrapper picks its own, the
port walks 64 rows), and every output rounded to bf16: NMSE <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.kernels.flash_attn import _fa_forward_lse
from ggml_tpu.kernels.flash_attn import flash_attention_train as jax_flash_attention_train
from ggml_tpu_torch.kernels import flash_attn
from ggml_tpu_torch.kernels.flash_attn import flash_attention_fwd_lse, flash_attention_train
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

GATE = {"float32": 1e-10, "bfloat16": 1e-5}


def _make(b, h, h_kv, nq, nkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, nq, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, nkv, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, nkv, d)).astype(np.float32),
            rng.standard_normal((b, nq, h, d)).astype(np.float32))


def _causal(nq, nkv, fill=-1e30):
    i, j = np.arange(nq)[:, None], np.arange(nkv)[None, :]
    return np.where(j <= i + nkv - nq, 0.0, fill).astype(np.float32)


def _mask(kind, nq, nkv):
    """None, "causal", or "rows-63-64:<fill>": causal with rows 63 and 64,
    either side of a 64-row tile edge, masked with fill everywhere."""
    if kind is None:
        return None
    mask = _causal(nq, nkv)
    if kind.startswith("rows-63-64:"):
        mask[63:65] = float(kind.split(":")[1])
    return mask


def _jax_vjp(q, k, v, w, mask, dtype, **kw):
    """JAX output and (dq, dk, dv) for the cotangent w, as f32 numpy."""
    jd = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    m = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, k, v: jax_flash_attention_train(q, k, v, mask=m, interpret=True, **kw), *args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(jnp.asarray(w).astype(jd)))]


def _port_vjp(q, k, v, w, mask, dtype, **kw):
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = flash_attention_train(*args, mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert out.dtype == td
    out.backward(torch.from_numpy(w).to(td))
    return [x.detach().float().numpy() for x in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,h_kv,nq,nkv,d,max_bias,masked",
    [
        (1, 4, 4, 64, 64, 64, 0.0, "causal"),
        (2, 8, 2, 64, 128, 64, 0.0, "causal"),  # GQA: dk/dv summed over the q heads of a kv head
        (1, 4, 4, 64, 64, 64, 8.0, "causal"),  # ALiBi slopes in both passes
        (1, 4, 4, 50, 96, 64, 0.0, "causal"),  # ragged nq and nkv: JAX pads, the port does not
        (1, 4, 4, 64, 64, 64, 0.0, None),  # no mask
        # the edges of the kernels' tile walks: head dims 128 and 72 (zero
        # columns up to 128), a causal offset with neither length a multiple
        # of 64, GQA 16/4, rows masked everywhere on both sides of a tile edge
        (1, 2, 2, 64, 64, 128, 0.0, "causal"),
        (1, 2, 2, 64, 64, 72, 0.0, "causal"),
        (1, 2, 2, 100, 164, 64, 0.0, "causal"),
        (1, 16, 4, 64, 64, 32, 0.0, "causal"),
        (1, 2, 2, 128, 128, 32, 0.0, "rows-63-64:-1e30"),
        (1, 2, 2, 128, 128, 32, 0.0, "rows-63-64:-inf"),
    ],
    ids=["plain", "gqa", "alibi", "ragged", "no-mask", "d128", "d72", "offset-100-164", "gqa-16-4",
         "rows-63-64-1e30", "rows-63-64-inf"])
def test_output_and_grads_match_jax(b, h, h_kv, nq, nkv, d, max_bias, masked, dtype):
    """The parameter sets of tests/test_flash_attn.py's training tests, and
    the edges of the CUDA kernels' tile walks."""
    q, k, v, w = _make(b, h, h_kv, nq, nkv, d, seed=nq + h + int(max_bias))
    mask = _mask(masked, nq, nkv)
    kw = dict(scale=1.0 / np.sqrt(d), max_bias=max_bias)
    want, got = _jax_vjp(q, k, v, w, mask, dtype, **kw), _port_vjp(q, k, v, w, mask, dtype, **kw)
    for name, a, g in zip(("o", "dq", "dk", "dv"), want, got):
        assert a.shape == g.shape, name
        assert np.isfinite(g).all(), name
        assert nmse(a, g) <= GATE[dtype], (name, nmse(a, g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_lse_matches_jax(dtype):
    """Kernel K's plain version: the output and the LSE (JAX broadcasts it
    over 128 lanes; the port keeps one f32 per row)."""
    q, k, v, _ = _make(2, 8, 2, 64, 128, 64, seed=11)
    mask = _causal(64, 128)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    o_want, lse_want = _fa_forward_lse(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), jnp.asarray(mask),
                                       0.125, 8.0, True)
    o, lse = flash_attention_fwd_lse(*(torch.from_numpy(a).to(td) for a in (q, k, v)), torch.from_numpy(mask),
                                     scale=0.125, max_bias=8.0)
    assert lse.shape == (2, 8, 64) and lse.dtype == torch.float32 and o.shape == (2, 64, 8, 64)
    np.testing.assert_array_equal(np.asarray(lse_want)[..., 0], np.asarray(lse_want)[..., 127])
    assert nmse(np.asarray(lse_want)[..., 0], lse.numpy()) <= 1e-12
    o_want = np.asarray(jnp.transpose(o_want, (0, 2, 1, 3)).astype(jnp.float32))
    assert nmse(o_want, o.float().numpy()) <= GATE[dtype]


def test_rows_masked_with_minus_inf_are_dead():
    """Every score -inf: output 0, LSE +1e30, no gradient, no NaN; the other
    rows still match JAX."""
    q, k, v, w = _make(1, 2, 2, 32, 64, 64, seed=5)
    mask = np.zeros((32, 64), np.float32)
    mask[5, :] = -np.inf
    mask[9:12, :] = -np.inf
    want, got = _jax_vjp(q, k, v, w, mask, "float32", scale=0.5), _port_vjp(q, k, v, w, mask, "float32", scale=0.5)
    for name, a, g in zip(("o", "dq", "dk", "dv"), want, got):
        assert np.isfinite(g).all() and nmse(a, g) <= 1e-10, name
    assert (got[0][0, 5] == 0).all() and (got[0][0, 9:12] == 0).all()
    assert (got[1][0, :, 5] == 0).all() and (got[1][0, :, 9:12] == 0).all()
    _, lse = flash_attention_fwd_lse(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), scale=0.5)
    assert (lse[0, :, 5] == 1e30).all() and (lse[0, :, 9:12] == 1e30).all()


def test_row_masked_with_the_finite_sentinel_matches_jax():
    """Every score -1e30 at n_kv = 32 (JAX pads nothing there): every p is 1,
    the output the mean of v, the LSE about -1e30, and the backward takes p = 1
    on every column, as the JAX kernels compute it."""
    q, k, v, w = _make(1, 2, 2, 32, 32, 64, seed=6)
    mask = _causal(32, 32)
    mask[7, :] = -1e30
    want, got = _jax_vjp(q, k, v, w, mask, "float32", scale=0.3), _port_vjp(q, k, v, w, mask, "float32", scale=0.3)
    for name, a, g in zip(("o", "dq", "dk", "dv"), want, got):
        assert nmse(a, g) <= 1e-10, (name, nmse(a, g))
    np.testing.assert_allclose(got[0][0, 7], v[0].mean(axis=1), rtol=1e-5, atol=1e-6)
    _, lse = flash_attention_fwd_lse(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), scale=0.3)
    assert (lse[0, :, 7] <= -1e29).all()


def test_backward_wrappers_and_the_function_agree():
    """L and M called alone, handed the mask's tile ranges as the Function
    hands them, give what the Function's backward gives; the GQA sum over
    the q heads of a kv head is the caller's."""
    q, k, v, w = (torch.from_numpy(a) for a in _make(1, 4, 2, 40, 72, 32, seed=8))
    mask = torch.from_numpy(_causal(40, 72))
    ranges = flash_attn.mask_ranges(mask)
    o, lse = flash_attention_fwd_lse(q, k, v, mask, scale=0.2, ranges=ranges)
    delta = (w * o).sum(-1).transpose(1, 2).contiguous()
    dq = flash_attn.flash_attention_bwd_dq(q, k, v, mask, 0.2, 0.0, w, lse, delta, ranges=ranges)
    dk, dv = flash_attn.flash_attention_bwd_dkv(q, k, v, mask, 0.2, 0.0, w, lse, delta, ranges=ranges)
    assert dk.shape == (1, 4, 72, 32) and dv.shape == (1, 4, 72, 32)
    _, gq, gk, gv = _port_vjp(*(x.numpy() for x in (q, k, v, w)), mask.numpy(), "float32", scale=0.2)
    np.testing.assert_array_equal(dq.numpy(), gq)
    np.testing.assert_array_equal(dk.view(1, 2, 2, 72, 32).sum(2).numpy(), gk)
    np.testing.assert_array_equal(dv.view(1, 2, 2, 72, 32).sum(2).numpy(), gv)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, w = (torch.from_numpy(a) for a in _make(1, 4, 2, 8, 16, 64, seed=7))
    with pytest.raises(TypeError):  # f32 q and k with a bf16 v: J's type set, not K's
        flash_attention_train(q, k, v.bfloat16())
    with pytest.raises(TypeError):
        flash_attention_fwd_lse(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # mask narrower than kv
        flash_attention_train(q, k, v, mask=torch.zeros((8, 15)))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError):  # dO in the (b, h, nq, d) layout instead of the output's
        flash_attn.flash_attention_bwd_dq(q, k, v, None, 1.0, 0.0, w.transpose(1, 2), lse, lse)
    with pytest.raises(ValueError):  # lse of another shape
        flash_attn.flash_attention_bwd_dkv(q, k, v, None, 1.0, 0.0, w, lse[:, :, :4], lse)
    mask = torch.zeros((8, 16))
    with pytest.raises(ValueError):  # tile ranges of another mask
        flash_attn.flash_attention_bwd_dq(q, k, v, mask, 1.0, 0.0, w, lse, lse,
                                          ranges=flash_attn.mask_ranges(torch.zeros((8, 80))))
    before = dict(flash_attn.launches)
    flash_attention_train(q.requires_grad_(), k, v).sum().backward()
    assert flash_attn.launches == before  # CPU tensors: the plain versions, nothing launched


def test_alibi_slopes_are_built_once_per_device():
    a = flash_attn._slopes_on(8, 8.0, torch.device("cpu"))
    assert flash_attn._slopes_on(8, 8.0, torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), flash_attn.alibi_slopes(8, 8.0))


@pytest.mark.parametrize("max_bias", [0.0, 8.0], ids=["no-alibi", "alibi"])
def test_dead_rows_at_padded_lengths_match_jax(max_bias):
    """Where the JAX wrapper pads kv to a multiple of 32 (with zero rows
    masked -1e30 times the slope), its dead rows read the padding: a row
    masked -1e30 everywhere averages v over the padded length (40 -> 64), an
    -inf row gets lse = -1e30 + log(24) instead of +1e30.  K folds those
    columns in: o and lse agree on every row, live or not."""
    q, k, v, _ = _make(1, 2, 2, 8, 40, 64, seed=12)
    mask = np.zeros((8, 40), np.float32)
    mask[2], mask[5] = -1e30, -np.inf
    o_jax, lse_jax = _fa_forward_lse(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), 0.125, max_bias, True)
    o, lse = flash_attention_fwd_lse(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), scale=0.125,
                                     max_bias=max_bias)
    o_jax = np.transpose(np.asarray(o_jax), (0, 2, 1, 3))
    lse_jax = np.asarray(lse_jax)[0, :, :8, 0]
    if max_bias == 0.0:
        np.testing.assert_allclose(o_jax[0, 2, 0], v[0, 0].sum(0) / 64, rtol=1e-5, atol=1e-6)
    assert nmse(o_jax, o.numpy()) <= 1e-10
    live = [0, 1, 3, 4, 6, 7]
    assert nmse(lse_jax[:, live], lse[0][:, live].numpy()) <= 1e-12
    np.testing.assert_array_equal(lse[0][:, [2, 5]].numpy(), lse_jax[:, [2, 5]])
    assert (lse_jax[:, [2, 5]] < -1e27).all()  # about slope * -1e30


def test_gradients_at_padded_lengths_with_dead_rows_match_jax():
    """The backward from K's folded LSE at n_kv = 40: a row masked -1e30
    everywhere takes p = 1 on every real column, an -inf row none; dq, dk and
    dv agree with jax.vjp on every row."""
    q, k, v, w = _make(1, 2, 2, 16, 40, 32, seed=13)
    mask = _causal(16, 40)
    mask[3], mask[9] = -1e30, -np.inf
    kw = dict(scale=0.2)
    want, got = _jax_vjp(q, k, v, w, mask, "float32", **kw), _port_vjp(q, k, v, w, mask, "float32", **kw)
    for name, a, g in zip(("o", "dq", "dk", "dv"), want, got):
        assert np.isfinite(g).all(), name
        assert nmse(a, g) <= 1e-10, (name, nmse(a, g))
    assert (got[1][0, :, 9] == 0).all()


def test_handed_ranges_are_checked():
    """K, L and M on the card read the mask's tile ranges that the autograd
    Function computes once; ranges handed over must be those of the mask's
    (nq, nkv) tiles (L and M check them on any device), and none are
    computed without a mask."""
    mask = torch.from_numpy(_causal(100, 164))
    ranges = flash_attn.mask_ranges(mask)
    assert flash_attn._train_ranges(mask, ranges) is ranges
    np.testing.assert_array_equal(flash_attn._train_ranges(mask, None).numpy(), ranges.numpy())
    assert flash_attn._train_ranges(None, None) is None
    for bad in (ranges[:, :1], ranges.double(), ranges.transpose(1, 2)):
        with pytest.raises(ValueError):
            flash_attn._train_ranges(mask, bad)
    q, k, v, w = (torch.from_numpy(a) for a in _make(1, 2, 2, 100, 164, 16, seed=9))
    lse = torch.zeros((1, 2, 100))
    for bwd in (flash_attn.flash_attention_bwd_dq, flash_attn.flash_attention_bwd_dkv):
        bwd(q, k, v, mask, 1.0, 0.0, w, lse, lse, ranges=ranges)
        with pytest.raises(ValueError):
            bwd(q, k, v, mask, 1.0, 0.0, w, lse, lse, ranges=ranges[:, :1])
