"""The IQ* and TQ* GGUF types in the port (ggml_tpu_torch.quant, kernel G's
new groups) against the JAX package on the CPU.

- For all eleven types: random_blocks gives finite fp16 fields (IQ1_M's
  scale is spread over four nibbles), the port's dequantize equals the JAX
  reference.dequantize bit for bit on the same bytes, and repack gives the
  JAX repack's planes bit for bit.
- planar_matmul (the plain versions on the CPU) against the JAX
  planar_matmul(interpret=True) at K = 512, N = 256: IQ1_M (groups of 8 with
  offsets), TQ1_0 and TQ2_0 (groups of 256) go to kernel G at every M, as
  in JAX; IQ4_XS, IQ2_XS and IQ1_S take E at M = 1 and G at M = 40.  Gate:
  NMSE <= 1e-8, the gate of the existing int8-plane product tests
  (test_torch_qmatmul_q8.py: the f32 sums, and above 32 rows the bf16
  products, run in another order); E over multiplied-out planes keeps the
  JAX loop's order and agrees bit for bit at groups of 32, to an ulp at 16.
- q8_matmul's checks take groups of 8 and 256; q8_gemv's still refuse them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.kernels import qmatmul as jqmatmul
from ggml_tpu.quant import planar as jplanar
from ggml_tpu.quant import reference as jreference
from ggml_tpu_torch.dtypes import GGMLType, get_type_traits
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.quant import reference
from ggml_tpu_torch.quant.planar import PlanarWeight, planar_types, repack
from tests.test_torch_qmatmul_q8 import _expected_kernel
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, nmse, one_thread, random_raw)

# type -> (group, offsets) of its planes, as the JAX package factors it
IQ_TYPES = {
    GGMLType.IQ4_NL: (32, False), GGMLType.IQ4_XS: (32, False), GGMLType.IQ3_S: (32, False),
    GGMLType.IQ3_XXS: (32, False), GGMLType.IQ2_S: (16, False), GGMLType.IQ2_XS: (16, False),
    GGMLType.IQ2_XXS: (32, False), GGMLType.IQ1_M: (8, True), GGMLType.IQ1_S: (32, True),
    GGMLType.TQ2_0: (256, False), GGMLType.TQ1_0: (256, False),
}
N = 256


def _f16_fields(t, blocks) -> np.ndarray:
    """The block scales of each block, as float32."""
    if t == GGMLType.IQ1_M:
        return reference.iq1m_d(blocks)
    off = {GGMLType.TQ1_0: 52, GGMLType.TQ2_0: 64}.get(t, 0)
    return reference._f16(blocks, off)


@pytest.mark.parametrize("t", list(IQ_TYPES), ids=lambda t: t.name)
def test_blocks_dequantize_and_repack_match_jax(t):
    tr = get_type_traits(t)
    n, k = 300, 512  # 300 rows: a padded column strip
    blocks = reference.random_blocks(t, n * k // tr.block_size, np.random.default_rng(int(t)), scale=2e-3)
    d = _f16_fields(t, blocks)
    assert np.isfinite(d).all() and (d > 0.999e-3).all() and (d < 3.001e-3).all()  # [s/2, 3s/2) in fp16
    w = reference.dequantize(blocks, t, n * k)
    assert np.isfinite(w).all()
    np.testing.assert_array_equal(w, jreference.dequantize(blocks, JGGMLType(int(t)), n * k))
    raw = blocks.reshape(n, -1)
    pw = repack(raw, t, (n, k))
    assert t in planar_types() and pw.kind == "q8"
    assert (pw.group, pw.offsets is not None) == IQ_TYPES[t]
    assert_planes_equal(pw, jplanar.repack(raw, JGGMLType(int(t)), (n, k)))
    np.testing.assert_array_equal(qmatmul.planar_dequant(pw)[:, :n].numpy().T, w.reshape(n, k))


CASES = [(t, m) for t in (GGMLType.IQ1_M, GGMLType.TQ1_0, GGMLType.TQ2_0) for m in (1, 7, 40)]
CASES += [(t, m) for t in (GGMLType.IQ4_XS, GGMLType.IQ2_XS, GGMLType.IQ1_S) for m in (1, 40)]


@pytest.mark.parametrize("t,m", CASES, ids=[f"{t.name}-M{m}" for t, m in CASES])
def test_planar_matmul_matches_jax(t, m):
    k = 512
    raw = random_raw(t, N, k, seed=31 * int(t) + m)
    pw = repack(raw, t, (N, k))
    jpw = jplanar.repack(raw, JGGMLType(int(t)), (N, k), backend="numpy")
    name = qmatmul.select_kernel(pw, m)
    assert name == _expected_kernel(jpw, m)
    group = IQ_TYPES[t][0]
    assert name == ("q8_gemv" if m <= qmatmul.GEMV_MAX_M and group in (16, 32) else "q8_matmul")
    x = (np.random.default_rng(100 + m).standard_normal((m, k)) * 0.5).astype(np.float32)
    y_jax = np.asarray(jqmatmul.planar_matmul(jnp.asarray(x), jpw, interpret=True))
    y = qmatmul.planar_matmul(torch.from_numpy(x), pw).numpy()
    assert y.shape == y_jax.shape == (m, N)
    assert nmse(y_jax, y) <= 1e-8
    if name == "q8_gemv" and group == 32:  # kernel E's plain version keeps the JAX loop's sum order
        np.testing.assert_array_equal(y, y_jax)
    elif name == "q8_gemv":  # groups of 16: XLA orders a few sums otherwise, an ulp (NMSE 2e-16 to 1.3e-15)
        assert nmse(y_jax, y) <= 1e-14
    # and against the dense spec with bf16 activations
    w_dense = qmatmul.planar_dequant(pw)[:, :N].double().numpy()
    assert nmse(x.astype(np.float64) @ w_dense, y) < 5e-4


def test_check_planes_takes_groups_8_and_256():
    """q8_matmul takes multiplied-out planes in groups of 8 and 256 (K a
    multiple of 256 there); compact planes and the GEMVs stay at 16 and 32."""
    def q8(k, g, offsets=False):
        return PlanarWeight(kind="q8", codes=torch.ones((k, 128), dtype=torch.int8), scales=torch.ones((k // g, 128)),
                            offsets=torch.ones((k // g, 128)) if offsets else None, group=g, n=128, k=k,
                            orig_type=GGMLType.IQ1_M if g == 8 else GGMLType.TQ2_0)

    for m in (1, 7, 40):
        x = torch.ones((m, 512), dtype=torch.bfloat16)
        for g, offsets in ((8, True), (8, False), (256, False)):
            y = qmatmul.q8_matmul(x, q8(512, g, offsets))
            assert y.shape == (m, 128) and bool((y == (1024 if offsets else 512)).all())
        for g in (8, 256):
            with pytest.raises(ValueError):
                qmatmul.q8_gemv(x[:1], q8(512, g))
    with pytest.raises(ValueError):  # K not a multiple of the group of 256
        qmatmul.q8_matmul(torch.ones((1, 288), dtype=torch.bfloat16), q8(288, 256))
    compact = PlanarWeight(kind="q8", codes=torch.ones((512, 128), dtype=torch.int8),
                           scales=torch.ones((64, 128), dtype=torch.int8), offsets=None, group=8, n=128, k=512,
                           orig_type=GGMLType.IQ1_M, supers=(torch.ones((8, 128)), None), sb=8)
    with pytest.raises(ValueError):  # compact planes: groups of 16 and 32 only
        qmatmul.q8_matmul(torch.ones((1, 512), dtype=torch.bfloat16), compact)


@pytest.mark.parametrize("t", [GGMLType.IQ4_XS, GGMLType.IQ1_M, GGMLType.TQ2_0, GGMLType.TQ1_0],
                         ids=lambda t: t.name)
def test_random_gguf_weights_have_a_trained_scale(tmp_path, t):
    """write_random_gguf(types=) writes every 2-D weight in the type asked
    for, with zero-mean weights of std about 0.02; TQ2_0's codes ternary."""
    from ggml_tpu_torch.gguf import GGUFFile

    cfg = gptj.GPTJConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_layer=1, n_rot=32)
    path = tmp_path / "w.gguf"
    gptj.write_random_gguf(path, cfg, types=dict.fromkeys(gptj.matmul_weight_names(cfg), t))
    with GGUFFile(path) as g:
        for name in gptj.matmul_weight_names(cfg):
            assert g.tensors[name].ggml_type == t
        w = g.to_float32("blk.0.ffn_up.weight")
        raw = np.array(g.tensor_bytes("blk.0.ffn_up.weight"))
    assert 0.018 < w.std() < 0.022 and abs(w.mean()) < 1e-3
    if t == GGMLType.TQ2_0:
        codes = repack(raw, t, (4 * 256, 256)).codes
        assert set(codes.unique().tolist()) == {-1, 0, 1}
