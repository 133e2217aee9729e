"""Port kernel D (ggml_tpu_torch.kernels.decode_attn) against the JAX
fused_decode_attention (Pallas, interpret mode) on the same inputs.

Both compute f32 dots and an f32 softmax over the cache window with the new
row at pos, so only the f32 summation order differs: NMSE <= 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.kernels.decode_attn import fused_decode_attention as jax_fused_decode_attention
from ggml_tpu_torch.kernels.decode_attn import fused_decode_attention
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (one_thread: the autouse fixture)

HQ, HKV, D, S = 4, 4, 64, 64


def _inputs(seed: int, hq: int = HQ, hkv: int = HKV):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(1, hq, 1, D), f(1, hkv, 1, D), f(1, hkv, 1, D), f(1, hkv, S, D), f(1, hkv, S, D)


@pytest.mark.parametrize("pos", [0, 17, 63])
def test_decode_attention_matches_jax(pos):
    q, kn, vn, kc, vc = _inputs(pos)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jax_fused_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(pos), scale=scale, interpret=True))
    got = fused_decode_attention(*(torch.from_numpy(a) for a in (q, kn, vn, kc, vc)),
                                 torch.tensor(pos, dtype=torch.int32), scale=scale)
    assert got.dtype == torch.float32 and got.shape == (1, HQ, 1, D)
    assert nmse(want, got.numpy()) <= 1e-10


def test_decode_attention_gqa_and_bf16_cache():
    """GQA (q head h reads kv head h // 2) over a bf16 cache, as the model's
    decode step calls it."""
    q, kn, vn, kc, vc = _inputs(5, hq=8, hkv=4)
    pos = 30
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = np.asarray(jax_fused_decode_attention(
        jnp.asarray(q), bf(kn), bf(vn), bf(kc), bf(vc), jnp.int32(pos), scale=0.125, interpret=True))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = fused_decode_attention(torch.from_numpy(q), tb(kn), tb(vn), tb(kc), tb(vc),
                                 torch.tensor(pos, dtype=torch.int32), scale=0.125)
    assert nmse(want, got.numpy()) <= 1e-10


def test_decode_attention_rejects_bad_inputs():
    q, kn, vn, kc, vc = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(TypeError):
        fused_decode_attention(q, kn, vn, kc, vc, 3, scale=0.1)
    with pytest.raises(ValueError):
        fused_decode_attention(q.expand(2, -1, -1, -1), kn, vn, kc, vc,
                               torch.tensor(3, dtype=torch.int32), scale=0.1)


@pytest.mark.parametrize("pos", [63, 64, 127, 299])
def test_decode_attention_gqa_at_chunk_edges(pos):
    """GQA (4 query heads a kv head) at head dim 128 over a window of 300 rows,
    at the edges of the CUDA kernel's 64-key chunks and at the window's end."""
    rng = np.random.default_rng(pos)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, kn, vn, kc, vc = f(1, 8, 1, 128), f(1, 2, 1, 128), f(1, 2, 1, 128), f(1, 2, 300, 128), f(1, 2, 300, 128)
    want = np.asarray(jax_fused_decode_attention(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(pos),
                                                 scale=0.088, interpret=True))
    got = fused_decode_attention(*(torch.from_numpy(a) for a in (q, kn, vn, kc, vc)),
                                 torch.tensor(pos, dtype=torch.int32), scale=0.088)
    assert nmse(want, got.numpy()) <= 1e-10
