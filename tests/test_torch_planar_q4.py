"""The port's dequantizers and repack of the packed-nibble GGUF types (Q4_0,
Q4_1, Q2_K, Q3_K, and Q4_K at every K) against the JAX package's, on random
blocks that reach every code value: dequantized blocks, planes, expanded
planes and dequantized planes bit for bit.
"""

import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.quant import planar as jplanar
from ggml_tpu.quant import reference as jref
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.quant import planar, reference
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, one_thread, planar_fields, random_raw)

N = 200  # not a multiple of the 128-column pad
TYPES = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K]
GROUP = {GGMLType.Q2_K: 16, GGMLType.Q3_K: 16}
ids = lambda t: t.name if isinstance(t, GGMLType) else None


def _jax_repack(raw, t, shape, **kw):
    return jplanar.repack(raw, JGGMLType(int(t)), shape, backend="numpy", **kw)


@pytest.mark.parametrize("t", TYPES[:4], ids=ids)
def test_dequantize_matches_jax(t):
    raw = random_raw(t, N, 512, seed=int(t))
    got = reference.dequantize(raw, t, N * 512)
    np.testing.assert_array_equal(got, jref.dequantize(raw.reshape(-1), JGGMLType(int(t)), N * 512))
    assert np.isfinite(got).all() and got.dtype == np.float32
    assert np.unique(got).size > 100  # the random blocks are not degenerate


@pytest.mark.parametrize("k", [256, 768])
@pytest.mark.parametrize("t", TYPES, ids=ids)
def test_repack_matches_jax(t, k):
    """K = 256 and 768 are not whole superblocks per half-plane, so Q4_K too
    lands on multiplied-out nibble planes: scales plane-major (2, K/2/G,
    Npad), offsets in natural group rows."""
    raw = random_raw(t, N, k, seed=k + int(t))
    pw, jpw = planar.repack(raw, t, (N, k)), _jax_repack(raw, t, (N, k))
    g = GROUP.get(t, 32)
    assert (pw.kind, pw.group, pw.npad, pw.supers) == ("q4", g, 256, None)
    assert pw.codes.shape == (k // 2, 256) and pw.codes.dtype == torch.uint8
    assert pw.scales.shape == (2, k // 2 // g, 256) and pw.offsets.shape == (k // g, 256)
    assert_planes_equal(pw, jpw)
    np.testing.assert_array_equal(planar.dequant_planar(pw), jplanar.dequant_planar(jpw))
    # and the planes reproduce the block decode up to f32 re-association
    w_ref = reference.dequantize(raw, t, N * k).reshape(N, k)
    np.testing.assert_allclose(planar.dequant_planar(pw), w_ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("t", TYPES, ids=ids)
def test_force_q8_matches_jax(t):
    raw = random_raw(t, N, 768, seed=3)
    pw = planar.repack(raw, t, (N, 768), force_q8=True)
    assert_planes_equal(pw, _jax_repack(raw, t, (N, 768), force_q8=True))
    assert pw.kind == "q8" and pw.supers is None and pw.offsets is not None


@pytest.mark.parametrize("t", [GGMLType.Q4_0, GGMLType.Q4_1], ids=ids)
def test_half_plane_of_broken_groups_takes_int8_planes(t):
    """(K/2) % G != 0: the two half-planes would split a group, so the codes
    stay int8, as in the JAX package."""
    raw = random_raw(t, N, 96, seed=5)
    pw = planar.repack(raw, t, (N, 96))
    assert pw.kind == "q8" and pw.codes.shape == (96, 256)
    assert_planes_equal(pw, _jax_repack(raw, t, (N, 96)))


def test_compact_q4_k_and_its_expansion_match_jax():
    """Q4_K at K % 512 == 0 keeps the compact planes; expand_compact gives the
    multiplied-out nibble planes the JAX expansion gives."""
    raw = random_raw(GGMLType.Q4_K, N, 1024, seed=21)
    pw, jpw = planar.repack(raw, GGMLType.Q4_K, (N, 1024)), _jax_repack(raw, GGMLType.Q4_K, (N, 1024))
    assert pw.supers is not None
    assert_planes_equal(pw, jpw)
    flat, jflat = planar.expand_compact(pw), jplanar.expand_compact(jpw)
    assert flat.supers is None and flat.kind == "q4" and flat.scales.shape == (2, 16, 256)
    assert_planes_equal(flat, jflat)
    assert planar.expand_compact(flat) is flat
    np.testing.assert_array_equal(planar.dequant_planar(flat), planar.dequant_planar(pw))


def test_expansion_equals_the_multiplied_out_repack(monkeypatch):
    raw = random_raw(GGMLType.Q4_K, N, 1024, seed=22)
    monkeypatch.setenv("GGML_TPU_COMPACT_SCALES", "0")
    jpw = _jax_repack(raw, GGMLType.Q4_K, (N, 1024))
    assert jpw.supers is None and jpw.kind == "q4"
    assert_planes_equal(planar.expand_compact(planar.repack(raw, GGMLType.Q4_K, (N, 1024))), jpw)


@pytest.mark.parametrize("t", [GGMLType.Q4_0, GGMLType.Q3_K], ids=ids)
def test_permute_output_columns_matches_jax(t):
    raw = random_raw(t, N, 512, seed=33)
    perm = np.random.default_rng(1).permutation(N)
    pw = planar.permute_output_columns(planar.repack(raw, t, (N, 512)), perm)
    assert_planes_equal(pw, jplanar.permute_output_columns(_jax_repack(raw, t, (N, 512)), perm))
    assert all(b.is_contiguous() for b in pw.buffers())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiplied_out_planes_carry_over(dtype):
    """convert.params_from_numpy takes q4 planes without supers, f32 or bf16."""
    import ml_dtypes

    raw = random_raw(GGMLType.Q2_K, N, 512, seed=7)
    jpw = _jax_repack(raw, GGMLType.Q2_K, (N, 512))
    if dtype == "bfloat16":
        jpw.scales = jpw.scales.astype(ml_dtypes.bfloat16)
        jpw.offsets = jpw.offsets.astype(ml_dtypes.bfloat16)
    pw = params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"]
    assert pw.scales.dtype == getattr(torch, dtype) and pw.supers is None
    assert_planes_equal_bits(pw, jpw)
    assert pw.plane_bytes() == 256 * 256 + (2 * 16 + 32) * 256 * pw.scales.element_size()


def assert_planes_equal_bits(pw, jpw):
    """assert_planes_equal for planes that may be bf16 (numpy has no bf16)."""
    for got, want in ((pw.codes, jpw.codes), (pw.scales, jpw.scales), (pw.offsets, jpw.offsets)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
