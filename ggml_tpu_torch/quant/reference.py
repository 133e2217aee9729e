"""Reference dequantization in NumPy — the port's own copy of the parts of
ggml_tpu/quant/reference.py this slice needs: the scalar float types and the
Q4_K block decode (reference: src/ggml-quants.c dequantize_row_q4_K, block
layout src/ggml-common.h:279-290).  Other block formats raise
NotImplementedError until their slice is ported (ROADMAP.md, "GGUF types on
q8 planes and non-compact q4").
"""

from __future__ import annotations

import numpy as np

from ..dtypes import QK_K, GGMLType, bf16_bits_to_fp32, get_type_traits

F32 = np.float32


def _f16(blocks: np.ndarray, off: int) -> np.ndarray:
    """fp16 scalar field at byte offset -> (nb,) float32."""
    return np.ascontiguousarray(blocks[:, off : off + 2]).view("<f2").astype(F32).reshape(-1)


def _k4_scale_min(scales: np.ndarray):
    """(nb,12) packed -> (nb,8) 6-bit sc and m (reference: get_scale_min_k4)."""
    j = np.arange(8)
    sc = np.where(j < 4, scales[:, j % 12] & 63, (scales[:, (j % 4) + 8] & 0xF) | ((scales[:, j % 4] >> 6) << 4))
    m = np.where(j < 4, scales[:, (j % 4) + 4] & 63, (scales[:, (j % 4) + 8] >> 4) | ((scales[:, (j % 4) + 4] >> 6) << 4))
    return sc.astype(F32), m.astype(F32)


# static element->byte/nibble maps for the 256-element Q4_K superblock
_E = np.arange(QK_K)
_Q4K_IS = 2 * (_E // 64) + (_E % 64) // 32
_Q4K_QIDX = 32 * (_E // 64) + (_E % 32)
_Q4K_NIB = (_E % 64) // 32


def dequant_q4_k(b):
    d = _f16(b, 0)[:, None]
    dmin = _f16(b, 2)[:, None]
    sc, m = _k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144]
    q = np.where(_Q4K_NIB == 0, qs[:, _Q4K_QIDX] & 0xF, qs[:, _Q4K_QIDX] >> 4).astype(F32)
    dl = d * sc[:, _Q4K_IS]
    ml = dmin * m[:, _Q4K_IS]
    return dl * q - ml


def dequantize(data: np.ndarray, ggml_type: GGMLType, n_elements: int) -> np.ndarray:
    """Raw bytes -> flat float32 array of n_elements (reference: to_float
    traits, include/ggml.h:2148-2158)."""
    t = GGMLType(ggml_type)
    data = np.asarray(data).reshape(-1).view(np.uint8)
    if t == GGMLType.F32:
        return data.view("<f4")[:n_elements].astype(F32)
    if t == GGMLType.F16:
        return data.view("<f2")[:n_elements].astype(F32)
    if t == GGMLType.BF16:
        return bf16_bits_to_fp32(data.view("<u2")[:n_elements])
    if t != GGMLType.Q4_K:
        raise NotImplementedError(
            f"dequantize {t.name}: not ported yet (ROADMAP.md, GGUF types on q8 planes "
            "and non-compact q4)")
    tr = get_type_traits(t)
    if n_elements % tr.block_size:
        raise ValueError(f"{t.name}: {n_elements} elements is not whole blocks")
    nb = n_elements // tr.block_size
    return dequant_q4_k(data[: nb * tr.type_size].reshape(nb, tr.type_size)).reshape(-1)
