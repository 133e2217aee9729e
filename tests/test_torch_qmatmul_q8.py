"""Port kernels E, F and G (ggml_tpu_torch.kernels.qmatmul: q8_gemv,
q8_gemv_sb, q8_matmul) against the JAX planar_matmul on the same int8 planes.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU; the port runs its plain PyTorch versions (CPU tensors).  The int8
activation codes match exactly (both divide by 127).  Over multiplied-out
planes the int8 GEMV's plain version keeps the JAX loop's sum order and agrees
bit for bit; elsewhere only the order of the f32 sums differs (and of the bf16
products above 32 rows): NMSE <= 1e-8.
Weights are random blocks, so every code value of a format occurs (-128 in
Q8_0, -32 in Q6_K, negative Q6_K sub-scales).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.kernels import qmatmul as jqmatmul
from ggml_tpu.quant import planar as jplanar
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.quant.planar import PlanarWeight, repack
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, nmse, one_thread, planar_fields, random_raw)

N = 256
# (ggml type, force_q8): the five int8-plane types and Q4_K moved to int8 planes
FORMATS = [(GGMLType.Q8_0, False), (GGMLType.Q5_0, False), (GGMLType.Q5_1, False),
           (GGMLType.Q5_K, False), (GGMLType.Q6_K, False), (GGMLType.Q4_K, True)]
fmt_id = lambda f: f[0].name + ("-force_q8" if f[1] else "")


def _weights(fmt, k: int):
    """The same raw blocks repacked by both packages."""
    t, force_q8 = fmt
    raw = random_raw(t, N, k, seed=17 * int(t) + k)
    jpw = jplanar.repack(raw, JGGMLType(int(t)), (N, k), force_q8=force_q8, backend="numpy")
    return repack(raw, t, (N, k), force_q8=force_q8), jpw


@pytest.fixture(scope="module", params=[(f, k) for f in FORMATS for k in (512, 4096)],
                ids=lambda p: f"{fmt_id(p[0])}-K{p[1]}")
def weights(request):
    return _weights(*request.param)


def _jax_route(jpw, m: int) -> str:
    """The path the JAX dispatch records for m rows (traced, not run)."""
    jqmatmul._selection_log.clear()
    jax.eval_shape(lambda x: jqmatmul.planar_matmul(x, jpw, interpret=True),
                   jax.ShapeDtypeStruct((m, jpw.k), jnp.float32))
    (path,) = jqmatmul._selection_log.values()
    return path


def _expected_kernel(jpw, m: int) -> str:
    """The port wrapper that stands for the Pallas wrapper JAX reaches."""
    path = _jax_route(jpw, m)
    if path == "q8-matmul (fused dequant)":
        return "q8_matmul"
    assert path == "q8-gemv (int8 MXU)"
    compact_tile = jpw.supers is not None and jqmatmul._sb_q8_gemv_ok(jpw.k, jpw.group, jpw.sb)
    return "q8_gemv_sb" if compact_tile else "q8_gemv"


@pytest.mark.parametrize("m", [1, 7, 40])
def test_planar_matmul_matches_jax(weights, m):
    pw, jpw = weights
    k = jpw.k
    x = (np.random.default_rng(100 + m).standard_normal((m, k)) * 0.5).astype(np.float32)
    y_jax = np.asarray(jqmatmul.planar_matmul(jnp.asarray(x), jpw, interpret=True))
    y = qmatmul.planar_matmul(torch.from_numpy(x), pw).numpy()
    assert y.shape == y_jax.shape == (m, N)
    assert nmse(y_jax, y) <= 1e-8
    if m <= 32 and pw.supers is None:  # kernel E's plain version keeps the JAX loop's sum order
        np.testing.assert_array_equal(y, y_jax)
    # and against the dense spec: bf16 activations (and int8 codes at M <= 32)
    w_dense = qmatmul.planar_dequant(pw)[:, :N].double().numpy()
    assert nmse(x.astype(np.float64) @ w_dense, y) < 5e-4


@pytest.mark.parametrize("m", [1, 7, 40])
def test_kernel_route_matches_jax(weights, m):
    """Each (type, M, K) lands on the port's twin of the Pallas wrapper the
    JAX dispatch picks, and planar_matmul returns that wrapper's result."""
    pw, jpw = weights
    name = qmatmul.select_kernel(pw, m)
    assert name == _expected_kernel(jpw, m)
    assert name == {1: "q8_gemv", 7: "q8_gemv", 40: "q8_matmul"}[m] + (
        "_sb" if m <= 32 and pw.supers is not None else "")
    x = torch.randn((m, jpw.k), generator=torch.Generator().manual_seed(m)).to(torch.bfloat16)
    y = getattr(qmatmul, name)(x, pw)
    assert y.dtype == torch.float32 and y.shape == (m, pw.npad)
    torch.testing.assert_close(qmatmul.planar_matmul(x, pw), y[:, :N].to(torch.bfloat16), rtol=0, atol=0)


# shapes where the dispatch leaves the usual route
ODD = {
    # compact planes without a legal superblock tile: kernel E over expanded planes
    "Q6_K-K4608-no-tile": ((GGMLType.Q6_K, False), 4608, 1, "q8_gemv"),
    "Q5_K-K4608-no-tile": ((GGMLType.Q5_K, False), 4608, 7, "q8_gemv"),
    # a whole-K tile up to 4096 is legal
    "Q6_K-K768-whole-K": ((GGMLType.Q6_K, False), 768, 1, "q8_gemv_sb"),
    # (K/G) % 8 != 0: no GEMV tile, the matmul kernel at every M
    "Q8_0-K128-M1": ((GGMLType.Q8_0, False), 128, 1, "q8_matmul"),
    "Q5_1-K416-M7": ((GGMLType.Q5_1, False), 416, 7, "q8_matmul"),
}


@pytest.mark.parametrize("case", ODD, ids=list(ODD))
def test_odd_shapes_route_and_match_jax(case):
    fmt, k, m, want = ODD[case]
    pw, jpw = _weights(fmt, k)
    assert_planes_equal(pw, jpw)
    assert qmatmul.select_kernel(pw, m) == _expected_kernel(jpw, m) == want
    x = (np.random.default_rng(k + m).standard_normal((m, k)) * 0.5).astype(np.float32)
    y_jax = np.asarray(jqmatmul.planar_matmul(jnp.asarray(x), jpw, interpret=True))
    assert nmse(y_jax, qmatmul.planar_matmul(torch.from_numpy(x), pw).numpy()) <= 1e-8


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("group,affine", [(32, False), (32, True), (16, False)],
                         ids=["q8_0-like", "q5_k-like", "q6_k-like"])
def test_synthesized_planes_match_jax(group, affine, dtype):
    """Planes as synth_quantized_params builds them: full-range int8 codes,
    one scale (and offset) per group in f32 or bf16."""
    import ml_dtypes

    rng = np.random.default_rng(group + affine)
    k, dt = 1024, ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    small = lambda: ((rng.random((k // group, N), dtype=np.float32) + 0.5) * 2.5e-3).astype(dt)
    jpw = jplanar.PlanarWeight(
        kind="q8", codes=rng.integers(-128, 128, (k, N), dtype=np.int8), scales=small(),
        offsets=-8 * small() if affine else None, group=group, n=N, k=k, orig_type=JGGMLType.Q8_0)
    pw = params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"]
    assert pw.scales.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    for m in (1, 40):
        x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
        y_jax = np.asarray(jqmatmul.planar_matmul(jnp.asarray(x), jpw, interpret=True))
        assert nmse(y_jax, qmatmul.planar_matmul(torch.from_numpy(x), pw).numpy()) <= 1e-8


def test_row_quantization_divides_by_127():
    """The per-row activation scale is a true division (the op-by-op JAX
    form), not a multiply by f32(1/127): the two differ in the last bit for
    about half of all amax values, and the codes at rounding ties with them."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32))
    x = x.to(torch.bfloat16)
    xq, sx = qmatmul.quantize_rows(x)
    jq, jsx = jqmatmul._quantize_activations_per_row(jnp.asarray(x.float().numpy()))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq).astype(np.float32))
    _, folded = qmatmul.quantize_rows(x, folded_scale=True)
    assert (folded != sx).any()


def test_wrappers_reject_what_the_kernels_do_not_take():
    q8_0, _ = _weights((GGMLType.Q8_0, False), 512)
    q6_k, _ = _weights((GGMLType.Q6_K, False), 512)
    q4_k = repack(random_raw(GGMLType.Q4_K, N, 512, seed=1), GGMLType.Q4_K, (N, 512))
    x = torch.zeros((1, 512), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        qmatmul.q8_gemv(x.float(), q8_0)
    with pytest.raises(ValueError):  # 33 rows
        qmatmul.q8_gemv(torch.zeros((33, 512), dtype=torch.bfloat16), q8_0)
    with pytest.raises(ValueError):  # K mismatch
        qmatmul.q8_matmul(torch.zeros((40, 256), dtype=torch.bfloat16), q8_0)
    with pytest.raises(ValueError):  # compact planes into the multiplied-out kernel and back
        qmatmul.q8_gemv(x, q6_k)
    with pytest.raises(ValueError):
        qmatmul.q8_gemv_sb(x, q8_0)
    with pytest.raises(ValueError):  # nibble planes into an int8 kernel and back
        qmatmul.q8_gemv(x, q4_k)
    with pytest.raises(ValueError):
        qmatmul.q4k_gemv_rows(x, q8_0)
    k128, _ = _weights((GGMLType.Q8_0, False), 128)
    with pytest.raises(ValueError):  # 4 groups: no GEMV tile
        qmatmul.q8_gemv(torch.zeros((1, 128), dtype=torch.bfloat16), k128)
    codes = torch.zeros((256, 128), dtype=torch.int8)
    g8 = PlanarWeight("q8", codes, torch.ones((32, 128)), None, 8, 128, 256, GGMLType.Q8_0)
    with pytest.raises(ValueError):  # groups of 8: the GEMV refuses them (G takes them: test_torch_iquants.py)
        qmatmul.q8_gemv(torch.zeros((1, 256), dtype=torch.bfloat16), g8)
    with pytest.raises(ValueError):  # planar_matmul checks K before it dispatches
        qmatmul.planar_matmul(torch.zeros((1, 256)), q8_0)
