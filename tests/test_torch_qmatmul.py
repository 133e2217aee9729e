"""Port kernels A, B and C (ggml_tpu_torch.kernels.qmatmul) against the JAX
planar_matmul on the same compact Q4_K planes.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU; the port runs its plain PyTorch versions (CPU tensors).  The int8
activation codes match exactly, so only the f32 summation order differs:
NMSE <= 1e-8.  Against the dense dequantized weight (planar_dequant) the gate
is the JAX tests' 5e-4 (tests/test_planar_qmatmul.py:96).

K=8192 gives two K-tiles per half-plane for the M=1 kernel
(_sb_gemv_k_tile(4096) = 2048), so a wrong activation-scale granularity
shows; at K <= 4096 there is one tile.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.dtypes import GGMLType
from ggml_tpu.kernels.qmatmul import planar_matmul as jax_planar_matmul
from ggml_tpu.quant import reference as R
from ggml_tpu.quant.planar import repack as jax_repack
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.quant.planar import repack
from tests.test_torch_rules import nmse, one_thread, planar_fields  # noqa: F401  (one_thread: the autouse fixture)

N = 256


def _weight(k: int, seed: int):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, k)) * 0.5).astype(np.float32)
    raw = R.quantize(w, GGMLType.Q4_K).reshape(N, -1)
    return raw, jax_repack(raw, GGMLType.Q4_K, (N, k))


@pytest.fixture(scope="module", params=[512, 8192], ids=lambda k: f"K{k}")
def weight(request):
    return _weight(request.param, seed=11 + request.param)


@pytest.mark.parametrize("m", [1, 7, 40])
def test_planar_matmul_matches_jax(weight, m):
    raw, jpw = weight
    k = jpw.k
    pw = params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"]
    x = (np.random.default_rng(100 + m).standard_normal((m, k)) * 0.5).astype(np.float32)

    y_jax = np.asarray(jax_planar_matmul(jnp.asarray(x), jpw, interpret=True))
    y = qmatmul.planar_matmul(torch.from_numpy(x), pw).numpy()
    assert y.shape == y_jax.shape == (m, N)
    assert nmse(y_jax, y) <= 1e-8

    # and against the dense spec: bf16 activations (and int8 codes at M <= 32)
    w_dense = qmatmul.planar_dequant(pw)[:, :N].double().numpy()
    assert nmse(x.astype(np.float64) @ w_dense, y) < 5e-4


@pytest.mark.parametrize("m", [1, 7, 40])
def test_kernel_route_by_rows(weight, m):
    """planar_matmul picks kernel A at M=1, B at 2..32 and C above, as
    _planar_matmul_impl does; each wrapper's plain version returns Npad
    columns of f32."""
    raw, jpw = weight
    pw = params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"]
    x = torch.randn((m, jpw.k), generator=torch.Generator().manual_seed(m)).to(torch.bfloat16)
    want = {1: qmatmul.q4k_gemv_qact, 7: qmatmul.q4k_gemv_rows, 40: qmatmul.q4k_matmul}[m]
    y = want(x, pw)
    assert y.dtype == torch.float32 and y.shape == (m, pw.npad)
    torch.testing.assert_close(qmatmul.planar_matmul(x, pw), y[:, :N].to(torch.bfloat16), rtol=0, atol=0)


def test_repack_matches_jax_repack():
    """The port's own Q4_K repack gives the JAX package's planes bit for bit."""
    raw, jpw = _weight(1024, seed=5)
    pw = repack(raw, GGMLType.Q4_K, (N, 1024))
    np.testing.assert_array_equal(pw.codes.numpy(), np.asarray(jpw.codes))
    np.testing.assert_array_equal(pw.scales.numpy(), np.asarray(jpw.scales))
    np.testing.assert_array_equal(pw.offsets.numpy(), np.asarray(jpw.offsets))
    np.testing.assert_array_equal(pw.d.numpy(), np.asarray(jpw.supers[0]))
    np.testing.assert_array_equal(pw.dmin.numpy(), np.asarray(jpw.supers[1]))
    w_ref = R.dequantize(raw, GGMLType.Q4_K, N * 1024).reshape(N, 1024)
    np.testing.assert_allclose(qmatmul.planar_dequant(pw)[:, :N].numpy().T, w_ref, rtol=1e-5, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take():
    raw, jpw = _weight(512, seed=3)
    pw = params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"]
    x = torch.zeros((1, 512), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        qmatmul.q4k_gemv_qact(x.float(), pw)
    with pytest.raises(ValueError):
        qmatmul.q4k_gemv_qact(torch.zeros((2, 512), dtype=torch.bfloat16), pw)
    with pytest.raises(ValueError):
        qmatmul.q4k_gemv_rows(torch.zeros((33, 512), dtype=torch.bfloat16), pw)
    with pytest.raises(ValueError):
        qmatmul.q4k_matmul(torch.zeros((40, 256), dtype=torch.bfloat16), pw)
    # multiplied-out nibble planes go to q4_gemv, not to the compact-plane GEMVs
    from ggml_tpu_torch.quant.planar import expand_compact

    flat = expand_compact(pw)
    with pytest.raises(ValueError):
        qmatmul.q4k_gemv_qact(x, flat)
    with pytest.raises(ValueError):
        qmatmul.q4k_gemv_rows(x, flat)
    with pytest.raises(ValueError):
        qmatmul.q4_gemv(x, pw)
    with pytest.raises(NotImplementedError):  # a type without planes (the IQ* types have them now)
        repack(raw, GGMLType.Q8_1, (N, 512))


@pytest.mark.parametrize("kind,m,k,npad,group,offsets", [
    ("q4", 1, 192, 384, 32, True),        # M=1, a half-plane ending in a half stage (96 rows)
    ("q4", 33, 256, 640, 16, True),       # groups of 16, Npad = 128 * 5
    ("q4", 100, 4096, 28672, 32, True),   # attn_qkvup at M=100: 224 tiles, no split
    ("q4", 100, 16384, 4096, 32, False),  # ffn_down at M=100: 32 tiles, split 4
    ("q4", 1024, 4096, 4096, 32, True),   # attn_output at M=1024: 256 tiles
    ("q8", 1, 4128, 384, 32, True),       # K % 64 == 32: a half stage at the end
    ("q8", 33, 512, 384, 16, False),
    ("q8", 100, 16384, 4096, 16, False),
    ("q8", 1024, 4096, 28672, 32, True),
])
def test_matmul_plan_is_legal(kind, m, k, npad, group, offsets):
    """matmul_plan, which the wrappers of kernels C and G size their
    scratch with: every weight row lies in a stage, every group in an offset
    stage, the group-sum scratch holds 2 Gp columns, and a split shares the
    stages out with at least 4 to a block and at most one block per SM in
    all; the tiles cover y."""
    p = qmatmul.matmul_plan(kind, m, k, npad, group, offsets)
    rows, per_stage = (k // 2, 64) if kind == "q4" else (k, 128)  # 128 values of K a stage
    assert (p["stages"] - 1) * per_stage < rows <= p["stages"] * per_stage
    ng = k // group
    if offsets:
        assert p["offset_stages"] * 64 >= ng > (p["offset_stages"] - 1) * 64
        assert p["xs_cols"] == 2 * p["offset_stages"] * 64
    else:
        assert p["offset_stages"] == 0 and p["xs_cols"] == 0
    assert p["tiles"] == -(-m // 128) * (npad // 128)
    total = p["stages"] + p["offset_stages"]
    assert 1 <= p["split"] and (p["split"] == 1 or (total // p["split"] >= 4 and p["tiles"] * p["split"] <= 132))
    if p["tiles"] >= 132:
        assert p["split"] == 1


def test_check_planes_accepts_what_it_did():
    """The matmul wrappers take every shape they took before (any M, K % 64
    for nibble planes, K % 32 for int8 planes, groups of 16 and 32) and
    refuse the others they refused but groups of 8 and 256 over int8 planes."""
    from ggml_tpu_torch.quant.planar import PlanarWeight

    def q4(k, g, n=256):
        return PlanarWeight(kind="q4", codes=torch.zeros((k // 2, n), dtype=torch.uint8),
                            scales=torch.ones((2, k // 2 // g, n)), offsets=None, group=g, n=n, k=k,
                            orig_type=GGMLType.Q4_0)

    def q8(k, g, n=256):
        return PlanarWeight(kind="q8", codes=torch.zeros((k, n), dtype=torch.int8), scales=torch.ones((k // g, n)),
                            offsets=None, group=g, n=n, k=k, orig_type=GGMLType.Q8_0)

    for m in (1, 33, 100):
        for k, g in ((192, 32), (256, 16), (64, 32)):
            assert qmatmul.q4k_matmul(torch.zeros((m, k), dtype=torch.bfloat16), q4(k, g)).shape == (m, 256)
        for k, g in ((4128, 32), (32, 32), (96, 16)):
            assert qmatmul.q8_matmul(torch.zeros((m, k), dtype=torch.bfloat16), q8(k, g)).shape == (m, 256)
    with pytest.raises(ValueError):  # K % 64 != 0 over nibble planes
        qmatmul.q4k_matmul(torch.zeros((1, 96), dtype=torch.bfloat16), q4(96, 16))
    with pytest.raises(ValueError):  # K % 32 != 0 over int8 planes
        qmatmul.q8_matmul(torch.zeros((1, 48), dtype=torch.bfloat16), q8(48, 16))
    with pytest.raises(ValueError):  # groups of 64 (8 and 256 are taken now: test_torch_iquants.py)
        qmatmul.q8_matmul(torch.zeros((1, 128), dtype=torch.bfloat16), q8(128, 64))
