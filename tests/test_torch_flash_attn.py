"""Port kernel J (ggml_tpu_torch.kernels.flash_attn.flash_attention) against
the JAX flash_attention on the same inputs.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do on
the CPU; the port runs its plain PyTorch version (CPU tensors), which walks
kv tiles of 64 rows as its CUDA kernel does (the JAX wrapper picks its own
tile).  f32 inputs differ only in the last bits of dots, exp and sums: NMSE <=
1e-10.  A bf16 v has p rounded to bf16 before p @ v, against a running max that
depends on the tile, and a bf16 q has the output rounded to bf16: NMSE <= 1e-5,
also for f32 q and k with a bf16 v (what a bf16 model's prefill hands over).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.kernels.flash_attn import flash_attention as jax_flash_attention
from ggml_tpu.models.common import causal_mask as jax_causal_mask
from ggml_tpu.ops.core import alibi_slopes as jax_alibi_slopes
from ggml_tpu_torch.kernels import flash_attn
from ggml_tpu_torch.kernels.flash_attn import flash_attention
from ggml_tpu_torch.models.common import causal_mask
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (one_thread: the autouse fixture)

GATE = {"float32": 1e-10, "bfloat16": 1e-5, "mixed": 1e-5}


def _make(b, h, h_kv, nq, nkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, nq, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, nkv, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, nkv, d)).astype(np.float32))


def _offset_causal(nq, nkv, offset, fill=-np.inf):
    i = np.arange(nq)[:, None]
    j = np.arange(nkv)[None, :]
    return np.where(j <= i + offset, 0.0, fill).astype(np.float32)


def _both(q, k, v, mask, dtype, **kw):
    """(JAX result, port result) as f32 numpy, inputs cast to dtype on both
    sides; "mixed" is f32 q and k with a bf16 v."""
    names = ("float32", "float32", "bfloat16") if dtype == "mixed" else (dtype,) * 3
    want = jax_flash_attention(*(jnp.asarray(a).astype(getattr(jnp, n)) for a, n in zip((q, k, v), names)),
                               mask=None if mask is None else jnp.asarray(mask), interpret=True, **kw)
    got = flash_attention(*(torch.from_numpy(a).to(getattr(torch, n)) for a, n in zip((q, k, v), names)),
                          mask=None if mask is None else torch.from_numpy(mask),
                          scale=kw.get("scale", 1.0), max_bias=kw.get("max_bias", 0.0),
                          logit_softcap=kw.get("logit_softcap", 0.0))
    assert got.dtype == getattr(torch, names[0]) and str(want.dtype) == names[0]
    assert tuple(got.shape) == tuple(want.shape)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize(
    "b,h,h_kv,nq,nkv,d,max_bias,softcap",
    [
        (1, 4, 4, 128, 256, 64, 0.0, 0.0),
        (2, 8, 2, 128, 128, 64, 0.0, 0.0),  # GQA
        (1, 4, 4, 128, 256, 64, 8.0, 0.0),  # ALiBi
        (1, 4, 4, 128, 256, 64, 0.0, 30.0),  # softcap
        (1, 4, 4, 100, 256, 64, 0.0, 0.0),  # ragged n_q
    ],
    ids=["plain", "gqa", "alibi", "softcap", "ragged-q"])
def test_flash_attention_matches_jax(b, h, h_kv, nq, nkv, d, max_bias, softcap, dtype):
    """The parameter sets of tests/test_flash_attn.py, -inf above the diagonal."""
    q, k, v = _make(b, h, h_kv, nq, nkv, d, seed=nq + h)
    mask = _offset_causal(nq, nkv, nkv - nq)
    want, got = _both(q, k, v, mask, dtype, scale=1.0 / np.sqrt(d), max_bias=max_bias, logit_softcap=softcap)
    assert got.shape == (b, nq, h, d) and np.isfinite(got).all()
    assert nmse(want, got) <= GATE[dtype], nmse(want, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_no_mask_and_ragged_lengths(dtype):
    q, k, v = _make(1, 4, 4, 128, 128, 64, seed=1)
    want, got = _both(q, k, v, None, dtype, scale=0.3)
    assert nmse(want, got) <= GATE[dtype]
    # odd q and kv lengths, with and without a mask: JAX pads, the port does not
    q, k, v = _make(1, 2, 2, 37, 53, 64, seed=2)
    for mask in (_offset_causal(37, 53, 16), None):
        want, got = _both(q, k, v, mask, dtype, scale=0.2)
        assert got.shape == (1, 37, 2, 64)
        assert nmse(want, got) <= GATE[dtype]


def test_decode_shape_and_extra_mask_rows():
    """nq = 1 against a longer kv; a mask with more rows than q (the KQ pad)."""
    q, k, v = _make(1, 8, 8, 1, 256, 64, seed=3)
    want, got = _both(q, k, v, _offset_causal(1, 256, 200), "float32", scale=0.125)
    assert nmse(want, got) <= 1e-10
    q, k, v = _make(1, 2, 2, 5, 64, 64, seed=4)
    want, got = _both(q, k, v, _offset_causal(8, 64, 59), "float32", scale=0.125)
    assert got.shape == (1, 5, 2, 64) and nmse(want, got) <= 1e-10


@pytest.mark.parametrize("fill", [-np.inf, -1e30], ids=["inf", "finite"])
def test_fully_masked_rows_give_zeros(fill):
    """Rows with every kv masked give exactly 0 and no NaN, whether the mask
    says -inf or the finite sentinel."""
    q, k, v = _make(1, 2, 2, 16, 33, 64, seed=5)
    mask = np.zeros((16, 33), np.float32)
    mask[4:9, :] = fill
    mask[12, :20] = fill
    want, got = _both(q, k, v, mask, "float32", scale=0.2)
    assert np.isfinite(got).all()
    assert (got[0, 4:9] == 0).all() and (want[0, 4:9] == 0).all()
    assert nmse(want, got) <= 1e-10


def test_causal_mask_and_alibi_slopes_match_jax():
    for t in (1, 7, 40):
        np.testing.assert_array_equal(causal_mask(t, "cpu").numpy(), np.asarray(jax_causal_mask(t)))
    assert causal_mask(7, "cpu") is causal_mask(7, "cpu")  # cached per length and device
    for h, bias in ((4, 8.0), (12, 8.0), (8, 0.0)):
        np.testing.assert_array_equal(flash_attn.alibi_slopes(h, bias), np.asarray(jax_alibi_slopes(h, bias)))


def test_kv_tile_of_the_plain_version():
    """The plain version walks the CUDA kernel's kv tiles of 64 rows, several
    of them here with a ragged last one, and agrees with the softmax written
    out in full."""
    q, k, v = (torch.from_numpy(a) for a in _make(1, 2, 2, 40, 200, 64, seed=6))
    mask = torch.from_numpy(_offset_causal(40, 200, 160, fill=-1e30))
    assert flash_attn._BKV == 64
    got = flash_attn._flash_attention_plain(q, k, v, mask, torch.ones(2), 0.125, 0.0).numpy()
    ref = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * 0.125 + mask, dim=-1) @ v
    assert nmse(ref.transpose(1, 2).numpy(), got) <= 1e-10


def test_bf16_model_prefill_types_at_head_dim_256():
    """What a bf16 GPT-J's prefill hands the kernel: f32 q and k out of RoPE,
    bf16 v, head_dim 256, causal, scores of a few units.  The JAX kernel
    multiplies the f32 values; so does the port (NMSE 5e-8 here, from the
    tiles' roundings of p).  Rounding q and k to bf16 first is another
    function: 1.8e-5 here, outside the gate."""
    q, k, v = _make(1, 2, 2, 96, 96, 256, seed=8)
    q *= 4.0
    mask = np.array(jax_causal_mask(96))
    want, got = _both(q, k, v, mask, "mixed", scale=1.0 / 16)
    assert nmse(want, got) <= 1e-6, nmse(want, got)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    rounded = flash_attention(tq.bfloat16().float(), tk.bfloat16().float(), tv.bfloat16(),
                              mask=torch.from_numpy(mask), scale=1.0 / 16).numpy()
    assert nmse(want, rounded) > GATE["mixed"], nmse(want, rounded)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _make(1, 4, 2, 8, 16, 64, seed=7))
    with pytest.raises(TypeError):  # bf16 q and k with an f32 v
        flash_attention(q.bfloat16(), k.bfloat16(), v)
    with pytest.raises(TypeError):  # q and k of two types
        flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # 4 heads over 3 kv heads
        flash_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(ValueError):  # mask narrower than kv
        flash_attention(q, k, v, mask=torch.zeros((8, 15)))
    with pytest.raises(ValueError):  # fewer mask rows than q rows
        flash_attention(q, k, v, mask=torch.zeros((4, 16)))
    before = dict(flash_attn.launches)
    flash_attention(q, k, v)
    assert flash_attn.launches == before  # CPU tensors: the plain version, nothing launched


def test_handed_ranges_are_checked():
    """J on the card reads the mask's tile ranges, which a model computes
    once per forward for all its layers: handed ranges give what the call's
    own ranges give, in every type set, and ranges that are not the mask's
    (nq, nkv) tiles raise on any device."""
    q, k, v = (torch.from_numpy(a) for a in _make(1, 4, 4, 100, 164, 64, seed=12))
    mask = torch.from_numpy(_offset_causal(100, 164, 64, fill=-1e30))
    ranges = flash_attn.mask_ranges(mask)
    for q_, k_, v_ in ((q, k, v), (q, k, v.bfloat16()), (q.bfloat16(), k.bfloat16(), v.bfloat16())):
        want = flash_attention(q_, k_, v_, mask=mask, scale=0.125)
        assert torch.equal(flash_attention(q_, k_, v_, mask=mask, scale=0.125, ranges=ranges), want)
    for bad in (ranges[:, :1], ranges.double(), ranges.transpose(1, 2),
                flash_attn.mask_ranges(torch.zeros((100, 100)))):
        with pytest.raises(ValueError):
            flash_attention(q, k, v, mask=mask, ranges=bad)


def test_split_hi_lo_planes():
    """Helper of J: f32 k as bf16 planes (2, b, h, n, d), hi = bf16(x) and
    lo = bf16(x - hi), bit for bit; hi + lo gives x back to 2^-16 of |x|.
    Head views (strided rows) split as their contiguous copies do."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal((2, 3, 40, 64)) * 10.0 ** rng.integers(-3, 4, (2, 3, 40, 1)).astype(np.float64))
                         .astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 40, 3, 64)).astype(np.float32)).transpose(1, 2)
    for t in (x, y):
        planes = flash_attn.split_hi_lo(t)
        assert planes.dtype == torch.bfloat16 and planes.shape == (2, *t.shape) and planes.is_contiguous()
        hi, lo = planes[0], planes[1]
        np.testing.assert_array_equal(hi.view(torch.int16).numpy(), t.to(torch.bfloat16).view(torch.int16).numpy())
        np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                      (t - hi.float()).to(torch.bfloat16).view(torch.int16).numpy())
        err = (t.double() - hi.double() - lo.double()).abs()
        assert bool((err <= 2.0 ** -16 * t.double().abs()).all())
    assert torch.equal(flash_attn.split_hi_lo(y), flash_attn.split_hi_lo(y.contiguous()))


def _ranges_numpy(mask):
    nq, nkv = mask.shape
    out = np.zeros((2, -(-nq // 64), -(-nkv // 64)), np.float32)
    for i in range(out.shape[1]):
        for j in range(out.shape[2]):
            tile = mask[64 * i:64 * (i + 1), 64 * j:64 * (j + 1)]
            out[0, i, j], out[1, i, j] = tile.min(), tile.max()
    return out


@pytest.mark.parametrize("kind", ["causal", "alibi-ragged", "random", "causal-offset-ragged"])
def test_mask_ranges(kind):
    """Helper of J, K and M: the min and max of each 64 x 64 mask tile,
    exactly, the ragged edge tiles over their own entries only."""
    rng = np.random.default_rng(10)
    if kind == "causal":
        mask = np.array(jax_causal_mask(200))
    elif kind == "causal-offset-ragged":  # the training mask at nq=100, nkv=164: neither a multiple of 64
        mask = _offset_causal(100, 164, 64, fill=-1e30)
    elif kind == "alibi-ragged":  # ggml's KQ mask with ALiBi positions, ragged in both lengths
        i, j = np.arange(100)[:, None], np.arange(150)[None, :]
        mask = np.where(j <= i + 50, -np.abs(i + 50 - j), -np.inf).astype(np.float32)
    else:
        mask = rng.standard_normal((130, 70)).astype(np.float32)
    got = flash_attn.mask_ranges(torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _ranges_numpy(mask))


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("nkv", [40, 64])
def test_rows_masked_everywhere_with_alibi_at_ragged_lengths_match_jax(nkv, softcap):
    """The JAX wrapper pads kv to a multiple of 32 with zero rows masked
    -1e30 times the slope.  With ALiBi (h=16, max_bias=8) most slopes are
    below 0.5, so a row masked -1e30 everywhere keeps a max of slope * -1e30
    above JAX's dead threshold (-5e29) and averages v over the padded length
    (40 -> 64); heads with slope >= 0.5 stay dead (zeros).  The port folds
    the padding in: dead and live rows alike agree with JAX, and at n_kv = 64
    (no padding) nothing changes."""
    q, k, v = _make(1, 16, 16, 8, nkv, 64, seed=nkv + int(softcap))
    mask = _offset_causal(8, nkv, nkv - 8, fill=-1e30)
    mask[3] = -1e30
    want, got = _both(q, k, v, mask, "float32", scale=0.125, max_bias=8.0, logit_softcap=softcap)
    assert np.isfinite(got).all()
    for rows in ([3], [0, 1, 2, 4, 5, 6, 7]):
        assert nmse(want[0, rows], got[0, rows]) <= 1e-10, (rows, nmse(want[0, rows], got[0, rows]))
    slopes = flash_attn.alibi_slopes(16, 8.0)
    dead = slopes >= 0.5
    assert (got[0, 3, dead] == 0).all() and (want[0, 3, dead] == 0).all()
    padded = -(-nkv // 32) * 32
    np.testing.assert_allclose(got[0, 3, ~dead], v[0, ~dead].sum(1) / padded, rtol=1e-5, atol=1e-6)
