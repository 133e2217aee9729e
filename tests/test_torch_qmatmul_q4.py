"""Port kernel H (q4_gemv), the int8-x entry q4k_gemv_i8 and kernel C over
multiplied-out planes (ggml_tpu_torch.kernels.qmatmul) against the JAX Pallas
wrappers on the same packed-nibble planes, and the dispatch against the JAX
dispatch.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU; the port runs its plain PyTorch versions (CPU tensors).  The int8
activation codes match exactly (both divide by 127), so only the order of the
f32 sums differs (and of the bf16 products above 32 rows): NMSE <= 1e-8.
Kernel H's plain version keeps the JAX loop bodies' order with fused
multiply-adds: bit for bit at M >= 2 and K = 8192 (at K = 512 XLA compiles
the single whole-K tile in another order, and at M = 1 the block-diagonal
bodies reduce a K-tile as a tree).
"""

import jax
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
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.quant.planar import expand_compact, repack
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, nmse, one_thread, planar_fields, random_raw)

N = 256


def _random_planes(k: int, group: int, offsets: bool, dtype, seed: int, n: int = N):
    """Multiplied-out nibble planes with random codes and random scales (and
    offsets), as numpy in a JAX PlanarWeight and carried over to the port."""
    rng = np.random.default_rng(seed)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    small = lambda shape: ((rng.random(shape, dtype=np.float32) + 0.5) * 2.5e-3).astype(dt)
    jpw = jplanar.PlanarWeight(
        kind="q4", codes=rng.integers(0, 256, (k // 2, n), dtype=np.uint8),
        scales=small((2, k // 2 // group, n)),
        offsets=(-8 * small((k // group, n)).astype(np.float32)).astype(dt) if offsets else None,
        group=group, n=n, k=k, orig_type=JGGMLType.Q4_0)
    return params_from_numpy({"w": planar_fields(jpw)}, device="cpu")["w"], jpw


def _x(m: int, k: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((m, k)) * 0.5).astype(np.float32)


def _jax_q4_gemv(x: np.ndarray, jpw):
    """_q4_gemv with the per-row quantizer before and * sx after, as
    _planar_matmul_impl runs it (qmatmul.py:1054, :1069-1073)."""
    xq, sx = jqmatmul._quantize_activations_per_row(jnp.asarray(x).astype(jnp.bfloat16))
    offsets = None if jpw.offsets is None else jnp.asarray(jpw.offsets)
    return np.asarray(jqmatmul._q4_gemv(xq, jnp.asarray(jpw.codes), jnp.asarray(jpw.scales), jpw.group,
                                        True, offsets=offsets) * sx)


@pytest.mark.parametrize("k", [512, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", [True, False], ids=["offsets", "no-offsets"])
@pytest.mark.parametrize("group", [16, 32])
def test_q4_gemv_plain_matches_jax(group, offsets, dtype, k):
    pw, jpw = _random_planes(k, group, offsets, dtype, seed=group + k, n=128)
    for m in (1, 7, 32):
        x = _x(m, k, seed=m)
        want = _jax_q4_gemv(x, jpw)
        got = qmatmul.q4_gemv(torch.from_numpy(x).to(torch.bfloat16), pw)
        assert got.shape == (m, pw.npad) and got.dtype == torch.float32
        assert nmse(want, got.numpy()) <= 1e-8, (m, nmse(want, got.numpy()))
        if m >= 2 and k == 8192:  # the loop bodies' sum order, multiply-adds fused
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("row", ["zero-row", "late-amax"])
@pytest.mark.parametrize("group,offsets,dtype", [(32, True, "bfloat16"), (16, False, "float32")])
def test_q4_gemv_quantizer_edges_match_jax(group, offsets, dtype, row):
    """Kernel H quantizes x itself on the card, with the per-row quantizer's
    arithmetic: at M = 7, a row of zeros (amax = 0: sx = 1, every code 0)
    or a row whose amax occurs once, in the last 256-row slab of K's high
    half (the last slab a block walks), among random rows."""
    k = 2048
    pw, jpw = _random_planes(k, group, offsets, dtype, seed=5 * group, n=128)
    x = _x(7, k, seed=group)
    if row == "zero-row":
        x[3] = 0.0
    else:
        x[3] = np.clip(x[3], -1.0, 1.0)
        x[3, k - 11] = -6.5
    want = _jax_q4_gemv(x, jpw)
    got = qmatmul.q4_gemv(torch.from_numpy(x).to(torch.bfloat16), pw)
    assert nmse(want, got.numpy()) <= 1e-8, nmse(want, got.numpy())
    if row == "zero-row":
        assert not got[3].any()
    xq, sx = qmatmul.quantize_rows(torch.from_numpy(x[3:4]).to(torch.bfloat16))
    assert float(sx) == (1.0 if row == "zero-row" else np.float32(6.5) / np.float32(127.0))
    assert int((xq.abs() == 127).sum()) == (0 if row == "zero-row" else 1)


def test_q4k_gemv_i8_plain_matches_jax():
    """The int8-x entry against _q4_gemv_sb with int8 x at M = 1 (the
    _q4gemv_bd_sb_kernel body): the un-scaled sum."""
    for k in (512, 8192):
        raw = random_raw(GGMLType.Q4_K, N, k, seed=k)
        pw = repack(raw, GGMLType.Q4_K, (N, k))
        jpw = jplanar.repack(raw, JGGMLType.Q4_K, (N, k), backend="numpy")
        xq = np.random.default_rng(k).integers(-127, 128, (1, k), dtype=np.int8)
        want = np.asarray(jqmatmul._q4_gemv_sb(
            jnp.asarray(xq), jnp.asarray(jpw.codes), jnp.asarray(jpw.scales), jnp.asarray(jpw.offsets),
            jnp.asarray(jpw.supers[0]), jnp.asarray(jpw.supers[1]), jpw.group, jpw.sb, True))
        got = qmatmul.q4k_gemv_i8(torch.from_numpy(xq), pw)
        assert got.shape == (1, pw.npad) and got.dtype == torch.float32
        assert nmse(want, got.numpy()) <= 1e-8
    with pytest.raises(TypeError):  # bf16 x belongs to q4k_gemv_qact
        qmatmul.q4k_gemv_i8(torch.zeros((1, 8192), dtype=torch.bfloat16), pw)
    with pytest.raises(ValueError):
        qmatmul.q4k_gemv_i8(torch.zeros((2, 8192), dtype=torch.int8), pw)


@pytest.mark.parametrize("m", [40, 520])
@pytest.mark.parametrize("group,offsets,dtype", [(32, True, "float32"), (16, True, "bfloat16"),
                                                 (32, False, "bfloat16")])
def test_q4k_matmul_on_multiplied_out_planes_matches_jax(group, offsets, dtype, m):
    """Kernel C's plain version against _q4_matmul + xsum @ eff_o
    (qmatmul.py:1078-1084), one call of 512 rows at most on the JAX side."""
    k = 1024
    pw, jpw = _random_planes(k, group, offsets, dtype, seed=3 * group + m)
    x = _x(m, k, seed=m)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    chunks = []
    for r0 in range(0, m, 512):
        xc = xb[r0 : r0 + 512]
        y = jqmatmul._q4_matmul(xc, jnp.asarray(jpw.codes), jnp.asarray(jpw.scales), group, True)
        if offsets:
            xsum = xc.astype(jnp.float32).reshape(xc.shape[0], k // group, group).sum(-1)
            y = y + xsum @ jnp.asarray(jpw.offsets).astype(jnp.float32)
        chunks.append(np.asarray(y))
    got = qmatmul.q4k_matmul(torch.from_numpy(x).to(torch.bfloat16), pw)
    assert got.shape == (m, pw.npad)
    assert nmse(np.concatenate(chunks), got.numpy()) <= 1e-8


def _weights(t, k: int):
    raw = random_raw(t, N, k, seed=17 * int(t) + k)
    return repack(raw, t, (N, k)), jplanar.repack(raw, JGGMLType(int(t)), (N, k), backend="numpy")


def _jax_route(jpw, m: int) -> str:
    """The path the JAX dispatch records for m rows (traced, not run)."""
    jqmatmul._selection_log.clear()
    jax.eval_shape(lambda x: jqmatmul.planar_matmul(x, jpw, interpret=True),
                   jax.ShapeDtypeStruct((m, jpw.k), jnp.float32))
    (path,) = jqmatmul._selection_log.values()
    return path


def _expected_kernel(jpw, m: int) -> str:
    """The port wrapper that stands for the Pallas wrapper JAX reaches
    (qmatmul.py:1043-1085)."""
    path = _jax_route(jpw, m)
    if path == "q4-matmul (fused dequant)":
        return "q4k_matmul"
    assert path == "q4-gemv (int8 MXU)"
    if jpw.supers is not None and jqmatmul._sb_gemv_k_tile(jpw.k // 2, jpw.group, jpw.sb) is not None:
        return "q4k_gemv_qact" if m == 1 else "q4k_gemv_rows"
    return "q4_gemv"


# (type, K) classes: multiplied-out planes with a GEMV tile; compact planes
# with and without a legal superblock tile (K/2 = 4608 > 4096 is no multiple
# of 2048); (K/2/G) % 8 != 0, the matmul kernel at every M
ROUTES = {
    "Q4_0-K512": (GGMLType.Q4_0, 512, ("q4_gemv", "q4_gemv", "q4k_matmul")),
    "Q4_1-K1024": (GGMLType.Q4_1, 1024, ("q4_gemv", "q4_gemv", "q4k_matmul")),
    "Q2_K-K768": (GGMLType.Q2_K, 768, ("q4_gemv", "q4_gemv", "q4k_matmul")),
    "Q3_K-K512": (GGMLType.Q3_K, 512, ("q4_gemv", "q4_gemv", "q4k_matmul")),
    "Q4_K-K1024-compact": (GGMLType.Q4_K, 1024, ("q4k_gemv_qact", "q4k_gemv_rows", "q4k_matmul")),
    "Q4_K-K9216-no-tile": (GGMLType.Q4_K, 9216, ("q4_gemv", "q4_gemv", "q4k_matmul")),
    "Q4_K-K768-12-groups": (GGMLType.Q4_K, 768, ("q4k_matmul",) * 3),
    "Q4_0-K256-4-groups": (GGMLType.Q4_0, 256, ("q4k_matmul",) * 3),
    "Q3_K-K256-8-groups": (GGMLType.Q3_K, 256, ("q4_gemv", "q4_gemv", "q4k_matmul")),
}


@pytest.mark.parametrize("case", ROUTES, ids=list(ROUTES))
def test_kernel_route_and_result_match_jax(case):
    """Each (type, K, M) lands on the port's twin of the Pallas wrapper the
    JAX dispatch picks, planar_matmul returns that wrapper's result, and the
    result is the JAX one."""
    t, k, wants = ROUTES[case]
    pw, jpw = _weights(t, k)
    assert_planes_equal(pw, jpw)
    for m, want in zip((1, 7, 40), wants):
        assert qmatmul.select_kernel(pw, m) == _expected_kernel(jpw, m) == want, m
        x = _x(m, k, seed=k + m)
        y = qmatmul.planar_matmul(torch.from_numpy(x), pw)
        direct = getattr(qmatmul, want)(torch.from_numpy(x).to(torch.bfloat16),
                                        expand_compact(pw) if want == "q4_gemv" else pw)
        torch.testing.assert_close(y, direct[:, :N], rtol=0, atol=0)
        y_jax = np.asarray(jqmatmul.planar_matmul(jnp.asarray(x), jpw, interpret=True))
        assert nmse(y_jax, y.numpy()) <= 1e-8, (m, nmse(y_jax, y.numpy()))
        w_dense = qmatmul.planar_dequant(pw)[:, :N].double().numpy()
        assert nmse(x.astype(np.float64) @ w_dense, y.numpy()) < 5e-4


def test_tiny_config_q4_k_takes_the_matmul_kernel_at_one_row():
    """random_config("tiny") has E = 256: its synthesized Q4_K weights are
    multiplied-out nibble planes with 4 groups per half-plane (ffn_down: 16),
    so the E-wide ones take kernel C at M = 1."""
    cfg = gptj.random_config("tiny")
    assert (cfg.n_embd, cfg.n_head, cfg.n_layer, cfg.n_vocab) == (256, 4, 2, 512)
    params = gptj.synth_quantized_params(cfg, GGMLType.Q4_K, seed=1, dtype=torch.float32, device="cpu")
    qkvup, down = params["blk.0.attn_qkvup.weight"], params["blk.0.ffn_down.weight"]
    assert qkvup.kind == "q4" and qkvup.supers is None and qkvup.scales.shape == (2, 4, 1792)
    assert qmatmul.select_kernel(qkvup, 1) == "q4k_matmul"
    assert down.supers is not None and qmatmul.select_kernel(down, 1) == "q4k_gemv_qact"
    model = gptj.GPTJ(params, cfg, max_seq=32, device="cpu")
    before = dict(qmatmul.launches)
    out = model.generate(np.arange(3)[None], 3)
    assert len(out) == 3 and qmatmul.launches == before  # CPU tensors: plain versions, nothing launched


@pytest.mark.parametrize("m", [520, 1030])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_rows_above_the_jax_chunk_match_jax(t, m):
    """The JAX package pads rows above 512 to a multiple of 512 and maps its
    kernel chunk by chunk; the port's kernels take all rows in one launch.
    Row for row the results agree within the matmul tolerance."""
    k = 512
    pw, jpw = _weights(t, k)
    x = _x(m, k, seed=m)
    y_jax = np.asarray(jqmatmul.planar_matmul(jnp.asarray(x), jpw, interpret=True))
    y = qmatmul.planar_matmul(torch.from_numpy(x), pw).numpy()
    assert y.shape == y_jax.shape == (m, N)
    assert nmse(y_jax, y) <= 1e-8
    rows = [nmse(y_jax[i], y[i]) for i in range(m)]
    assert max(rows) <= 1e-6, max(rows)


def test_wrappers_reject_what_the_kernels_do_not_take():
    pw, _ = _random_planes(512, 32, True, "float32", seed=1)
    x = torch.zeros((1, 512), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        qmatmul.q4_gemv(x.float(), pw)
    with pytest.raises(ValueError):  # 33 rows
        qmatmul.q4_gemv(torch.zeros((33, 512), dtype=torch.bfloat16), pw)
    with pytest.raises(ValueError):  # K mismatch
        qmatmul.q4_gemv(torch.zeros((1, 1024), dtype=torch.bfloat16), pw)
    k256, _ = _random_planes(256, 32, True, "float32", seed=2)
    with pytest.raises(ValueError):  # 4 groups per half-plane: no GEMV tile
        qmatmul.q4_gemv(torch.zeros((1, 256), dtype=torch.bfloat16), k256)
    q8, _ = _weights(GGMLType.Q8_0, 512)
    with pytest.raises(ValueError):  # int8 planes into a nibble kernel
        qmatmul.q4_gemv(x, q8)
