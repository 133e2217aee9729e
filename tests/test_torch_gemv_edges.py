"""The plain versions of GEMV kernels A (q4k_gemv_qact), E (q8_gemv) and F
(q8_gemv_sb) against the JAX Pallas wrappers at the edges of the card's
GEMV pipeline (csrc/gemv_sm90.cuh): the tiles of A's per-tile activation
quantization, F's per-row quantization over compact Q6_K and Q5_K planes,
and E at a K that ends in half a 256-row slab.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU; the port runs its plain PyTorch versions (CPU tensors).  The int8
activation codes match exactly, so only the order of the f32 sums differs:
NMSE <= 1e-8 (E's plain version keeps the JAX loop's order: bit for bit).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.kernels import qmatmul as jqmatmul
from ggml_tpu.quant import planar as jplanar
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.quant.planar import repack
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, nmse, one_thread, planar_fields, random_raw)

N = 128


def _weights(t, k: int):
    """The same raw blocks repacked by both packages."""
    raw = random_raw(t, N, k, seed=31 * int(t) + k)
    pw, jpw = repack(raw, t, (N, k)), jplanar.repack(raw, JGGMLType(int(t)), (N, k), backend="numpy")
    assert_planes_equal(pw, jpw)
    return pw, jpw


def _x(m: int, k: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((m, k)) * 0.5).astype(np.float32)


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("edge", ["zero-tile", "last-tile-amax"])
def test_q4k_gemv_qact_tile_edges_match_jax(edge):
    """Kernel A at K = 8192: two tiles of 2048 packed rows per half-plane,
    each with its own scale amax * f32(1/127).  A tile of zeros has scale 1
    and codes 0; an amax that occurs once, in the last tile of the high
    half, sets that tile's scale alone."""
    k = 8192
    pw, jpw = _weights(GGMLType.Q4_K, k)
    kt2 = qmatmul._sb_gemv_k_tile(k // 2, pw.group, pw.sb)
    assert kt2 == 2048 and k // kt2 == 4
    x = np.clip(_x(1, k, seed=7), -1.0, 1.0)
    if edge == "zero-tile":
        x[0, kt2 : 2 * kt2] = 0.0  # the low half's second tile
    else:
        x[0, k - 11] = -6.5
    want = np.asarray(jqmatmul._q4_gemv_sb(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(jpw.codes), jnp.asarray(jpw.scales),
        jnp.asarray(jpw.offsets), jnp.asarray(jpw.supers[0]), jnp.asarray(jpw.supers[1]), jpw.group, jpw.sb, True))
    got = qmatmul.q4k_gemv_qact(_bf16(x), pw)
    assert got.shape == (1, pw.npad) and got.dtype == torch.float32
    assert nmse(want, got.numpy()) <= 1e-8, nmse(want, got.numpy())
    # the scales of the four segments: low tiles, then high tiles
    _, sx = qmatmul.quantize_rows(_bf16(x).reshape(k // kt2, kt2), folded_scale=True)
    if edge == "zero-tile":
        assert float(sx[1]) == 1.0 and float(sx[0]) != 1.0
    else:
        assert float(sx[3]) == np.float32(6.5) * np.float32(1.0 / 127.0)
        assert (sx[:3] < sx[3]).all()


@pytest.mark.parametrize("row", ["zero-row", "late-amax"])
@pytest.mark.parametrize("t", [GGMLType.Q6_K, GGMLType.Q5_K], ids=lambda t: t.name)
def test_q8_gemv_sb_quantizer_edges_match_jax(t, row):
    """Kernel F quantizes x itself on the card, one scale per row: at M = 7,
    a row of zeros (every code 0, y 0) or a row whose amax occurs once, in
    the last 256 values of K (the last slab a block walks), among random
    rows, over compact Q6_K (no offsets) and Q5_K (min codes) planes."""
    k = 2048
    pw, jpw = _weights(t, k)
    x = _x(7, k, seed=int(t))
    if row == "zero-row":
        x[3] = 0.0
    else:
        x[3] = np.clip(x[3], -1.0, 1.0)
        x[3, k - 11] = -6.5
    xq, sx = jqmatmul._quantize_activations_per_row(jnp.asarray(x).astype(jnp.bfloat16))
    m_codes = None if jpw.offsets is None else jnp.asarray(jpw.offsets)
    dmin = None if jpw.supers[1] is None else jnp.asarray(jpw.supers[1])
    want = np.asarray(jqmatmul._q8_gemv_sb(xq, jnp.asarray(jpw.codes), jnp.asarray(jpw.scales),
                                           jnp.asarray(jpw.supers[0]), jpw.group, jpw.sb, True, m_codes=m_codes,
                                           dmin_pl=dmin) * sx)
    assert qmatmul.select_kernel(pw, 7) == "q8_gemv_sb"
    got = qmatmul.q8_gemv_sb(_bf16(x), pw)
    assert got.shape == (7, pw.npad) and got.dtype == torch.float32
    assert nmse(want, got.numpy()) <= 1e-8, nmse(want, got.numpy())
    if row == "zero-row":
        assert not got[3].any()


@pytest.mark.parametrize("m", [1, 7])
def test_q8_gemv_at_half_a_slab_matches_jax(m):
    """Kernel E over groups of 16 at K = 4224: 16 slabs of 256 rows and half
    of one, with bf16 scales and offsets, as the synthesis builds Q5_K-like
    planes."""
    k, g = 4224, 16
    rng = np.random.default_rng(m)
    small = lambda: ((rng.random((k // g, N), dtype=np.float32) + 0.5) * 2.5e-3).astype(ml_dtypes.bfloat16)
    jpw = jplanar.PlanarWeight(kind="q8", codes=rng.integers(-128, 128, (k, N), dtype=np.int8), scales=small(),
                               offsets=(-8 * small().astype(np.float32)).astype(ml_dtypes.bfloat16), group=g, n=N,
                               k=k, orig_type=JGGMLType.Q8_0)
    pw = params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"]
    assert k % 256 == 128 and qmatmul.select_kernel(pw, m) == "q8_gemv"
    x = _x(m, k, seed=k + m)
    xq, sx = jqmatmul._quantize_activations_per_row(jnp.asarray(x).astype(jnp.bfloat16))
    want = np.asarray(jqmatmul._q8_gemv(xq, jnp.asarray(jpw.codes), jnp.asarray(jpw.scales), g, True,
                                        offsets=jnp.asarray(jpw.offsets)) * sx)
    got = qmatmul.q8_gemv(_bf16(x), pw).numpy()
    assert nmse(want, got) <= 1e-8, nmse(want, got)
    np.testing.assert_array_equal(got, want)
