"""The port's dequantizers and repack of the int8-plane GGUF types (Q8_0,
Q5_0, Q5_1, Q5_K, Q6_K; Q4_K with force_q8) against the JAX package's, on
random blocks that reach every code value: planes, dequantized blocks and
dequantized planes bit for bit.
"""

import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.quant import planar as jplanar
from ggml_tpu.quant import reference as jref
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.quant import planar, reference
from ggml_tpu_torch.quant.planar import PlanarWeight
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, one_thread, random_raw)

N = 200  # not a multiple of the 128-column pad
TYPES = [GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K, GGMLType.Q6_K]
ids = lambda t: t.name if isinstance(t, GGMLType) else None


def _jax_repack(raw, t, shape, **kw):
    return jplanar.repack(raw, JGGMLType(int(t)), shape, backend="numpy", **kw)


@pytest.mark.parametrize("t", TYPES + [GGMLType.Q4_K], ids=ids)
def test_dequantize_matches_jax(t):
    raw = random_raw(t, N, 512, seed=int(t))
    got = reference.dequantize(raw, t, N * 512)
    np.testing.assert_array_equal(got, jref.dequantize(raw.reshape(-1), JGGMLType(int(t)), N * 512))
    assert np.isfinite(got).all() and got.dtype == np.float32


@pytest.mark.parametrize("k", [768, 1024])
@pytest.mark.parametrize("t", TYPES, ids=ids)
def test_repack_matches_jax(t, k):
    raw = random_raw(t, N, k, seed=k + int(t))
    pw, jpw = planar.repack(raw, t, (N, k)), _jax_repack(raw, t, (N, k))
    assert pw.kind == "q8" and pw.npad == 256
    assert (pw.supers is not None) == (t in (GGMLType.Q5_K, GGMLType.Q6_K))
    assert_planes_equal(pw, jpw)
    np.testing.assert_array_equal(planar.dequant_planar(pw), jplanar.dequant_planar(jpw))
    # and the planes reproduce the block decode up to f32 re-association
    w_ref = reference.dequantize(raw, t, N * k).reshape(N, k)
    np.testing.assert_allclose(planar.dequant_planar(pw), w_ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K], ids=ids)
def test_force_q8_matches_jax(t):
    """force_q8 moves Q4_K from compact nibble planes to multiplied-out int8
    planes and leaves the other types as they are."""
    raw = random_raw(t, N, 1024, seed=3)
    pw = planar.repack(raw, t, (N, 1024), force_q8=True)
    assert_planes_equal(pw, _jax_repack(raw, t, (N, 1024), force_q8=True))
    assert pw.kind == "q8"
    if t == GGMLType.Q4_K:
        assert pw.supers is None and pw.scales.dtype == torch.float32 and pw.offsets is not None


def test_wide_weights_pad_to_1024():
    raw = random_raw(GGMLType.Q8_0, 4100, 256, seed=9)
    pw = planar.repack(raw, GGMLType.Q8_0, (4100, 256))
    assert pw.npad == 5120
    assert_planes_equal(pw, _jax_repack(raw, GGMLType.Q8_0, (4100, 256)))


@pytest.mark.parametrize("t", [GGMLType.Q5_K, GGMLType.Q6_K], ids=ids)
def test_expand_compact_gives_the_multiplied_out_planes(t, monkeypatch):
    """expand_compact of the port's compact planes equals the planes the JAX
    repack builds with the compact layout switched off."""
    raw = random_raw(t, N, 768, seed=21)
    monkeypatch.setenv("GGML_TPU_COMPACT_SCALES", "0")
    jpw = _jax_repack(raw, t, (N, 768))
    assert jpw.supers is None
    pw = planar.expand_compact(planar.repack(raw, t, (N, 768)))
    assert_planes_equal(pw, jpw)
    assert planar.expand_compact(pw) is pw


@pytest.mark.parametrize("t", [GGMLType.Q8_0, GGMLType.Q5_1, GGMLType.Q5_K, GGMLType.Q6_K], ids=ids)
def test_permute_output_columns_matches_jax(t):
    raw = random_raw(t, N, 512, seed=33)
    perm = np.random.default_rng(1).permutation(N)
    pw = planar.permute_output_columns(planar.repack(raw, t, (N, 512)), perm)
    assert_planes_equal(pw, jplanar.permute_output_columns(_jax_repack(raw, t, (N, 512)), perm))
    assert all(b.is_contiguous() for b in pw.buffers())


def test_plane_bytes_and_module_moves():
    """plane_bytes counts the planes a weight has; absent planes are None and
    survive .to() and deepcopy."""
    import copy

    raw = random_raw(GGMLType.Q6_K, 128, 512, seed=2)
    pw = planar.repack(raw, GGMLType.Q6_K, (128, 512))
    assert pw.offsets is None and pw.dmin is None and pw.supers == (pw.d, None)
    assert pw.plane_bytes() == 512 * 128 + 32 * 128 + 2 * 128 * 4
    moved = copy.deepcopy(pw).to("cpu")
    assert moved.offsets is None and moved.plane_bytes() == pw.plane_bytes()
    q5 = planar.repack(random_raw(GGMLType.Q5_1, 128, 512, seed=2), GGMLType.Q5_1, (128, 512))
    assert q5.plane_bytes() == 512 * 128 + 2 * 16 * 128 * 4


def test_unported_planes_raise():
    raw = random_raw(GGMLType.Q4_K, N, 768, seed=1)
    with pytest.raises(NotImplementedError):  # types without planes (the IQ* and TQ* types have them now)
        planar.repack(raw, GGMLType.Q8_1, (N, 768))
    with pytest.raises(NotImplementedError):
        planar.repack(raw, GGMLType.Q8_K, (N, 768))
    with pytest.raises(NotImplementedError):  # and without a dequantizer
        reference.dequantize(raw, GGMLType.Q8_1, 32)
    q4 = planar.repack(random_raw(GGMLType.Q4_K, N, 512, seed=1), GGMLType.Q4_K, (N, 512))
    with pytest.raises(ValueError):  # compact q4 planes are the Q4_K factoring only: groups of 32 with min codes
        PlanarWeight("q4", q4.codes, q4.scales, None, 32, N, 512, GGMLType.Q4_K, supers=(q4.d, None))
    with pytest.raises(ValueError):
        PlanarWeight("q4", q4.codes, q4.scales, q4.offsets, 16, N, 512, GGMLType.Q4_K, supers=q4.supers)
    codes = np.zeros((64, 128), np.int8)
    with pytest.raises(ValueError):
        PlanarWeight("q2", codes, codes, None, 32, 128, 64, GGMLType.Q8_0)
    with pytest.raises(ValueError):  # min codes without dmin
        PlanarWeight("q8", codes, codes[:2], codes[:2], 32, 128, 64, GGMLType.Q5_K,
                     supers=(np.ones((1, 128), np.float32), None))
