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
from tests.test_torch_rules import nmse, planar_fields

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
    with pytest.raises(NotImplementedError):  # the IQ* types: a later slice
        repack(raw, GGMLType.IQ4_NL, (N, 512))
