"""Reference dequantization in NumPy — the port's own copy of the parts of
ggml_tpu/quant/reference.py the ported slices need: the scalar float types
and the block decodes of Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K
and Q6_K (reference: src/ggml-quants.c dequantize_row_*, block layouts
src/ggml-common.h).  The IQ* and TQ* formats raise NotImplementedError until
their slice is ported (ROADMAP.md, "the remaining GGUF types").
"""

from __future__ import annotations

import numpy as np

from ..dtypes import QK_K, GGMLType, bf16_bits_to_fp32, get_type_traits

F32 = np.float32


def _f16(blocks: np.ndarray, off: int) -> np.ndarray:
    """fp16 scalar field at byte offset -> (nb,) float32."""
    return np.ascontiguousarray(blocks[:, off : off + 2]).view("<f2").astype(F32).reshape(-1)


def _u32(blocks: np.ndarray, off: int, n: int = 1) -> np.ndarray:
    return np.ascontiguousarray(blocks[:, off : off + 4 * n]).view("<u4").reshape(len(blocks), n)


def dequant_q4_0(b):
    d = _f16(b, 0)[:, None]
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1).astype(F32) * d


def dequant_q4_1(b):
    d = _f16(b, 0)[:, None]
    m = _f16(b, 2)[:, None]
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(F32)
    hi = (qs >> 4).astype(F32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _q5_bits(qh_u32):
    """(nb,) uint32 -> (nb, 32) the 5th bits as 0x10/0, ordered per dequant loop."""
    j = np.arange(16)
    xh0 = ((qh_u32[:, None] >> j) << 4) & 0x10  # elements 0..15
    xh1 = (qh_u32[:, None] >> (j + 12)) & 0x10  # elements 16..31
    return np.concatenate([xh0, xh1], axis=1).astype(np.int32)


def _q5_codes(b, qh_off: int):
    """Unsigned 5-bit codes (nb, 32) of a Q5_0/Q5_1 block: the high bits at
    byte qh_off, the nibbles right after them."""
    qs = b[:, qh_off + 4 : qh_off + 20]
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    return np.concatenate([lo, hi], axis=1) | _q5_bits(_u32(b, qh_off).reshape(-1))


def dequant_q5_0(b):
    return (_q5_codes(b, 2) - 16).astype(F32) * _f16(b, 0)[:, None]


def dequant_q5_1(b):
    return _q5_codes(b, 4).astype(F32) * _f16(b, 0)[:, None] + _f16(b, 2)[:, None]


def dequant_q8_0(b):
    d = _f16(b, 0)[:, None]
    return b[:, 2:34].view(np.int8).astype(F32) * d


def _k4_scale_min(scales: np.ndarray):
    """(nb,12) packed -> (nb,8) 6-bit sc and m (reference: get_scale_min_k4)."""
    j = np.arange(8)
    sc = np.where(j < 4, scales[:, j % 12] & 63, (scales[:, (j % 4) + 8] & 0xF) | ((scales[:, j % 4] >> 6) << 4))
    m = np.where(j < 4, scales[:, (j % 4) + 4] & 63, (scales[:, (j % 4) + 8] >> 4) | ((scales[:, (j % 4) + 4] >> 6) << 4))
    return sc.astype(F32), m.astype(F32)


# static element->byte/shift maps for the 256-element superblocks
_E = np.arange(QK_K)


def _q2k_maps():
    g = _E // 16  # 16 groups of 16
    l = _E % 16
    qidx = 32 * (g // 8) + 16 * (g % 2) + l
    shift = 2 * ((g % 8) // 2)
    return g, qidx, shift


_Q2K_G, _Q2K_QIDX, _Q2K_SHIFT = _q2k_maps()


def _q2k_codes(qs):
    """2-bit codes 0..3 (nb, 256) of a Q2_K/Q3_K superblock in element order."""
    return (qs[:, _Q2K_QIDX] >> _Q2K_SHIFT) & 3


def dequant_q2_k(b):
    d = _f16(b, 80)[:, None]
    dmin = _f16(b, 82)[:, None]
    sc = b[:, 0:16][:, _Q2K_G]
    q = _q2k_codes(b[:, 16:80]).astype(np.int8).astype(F32)
    dl = d * (sc & 0xF).astype(F32)
    ml = dmin * (sc >> 4).astype(F32)
    return dl * q - ml


def _q3k_scales(scales: np.ndarray) -> np.ndarray:
    """12 packed bytes -> 16 6-bit scales, minus 32 (reference: dequantize_row_q3_K
    kmask trick, equivalently quantize_row_q3_K_ref's decode)."""
    j = np.arange(16)
    lo = np.where(j < 8, scales[:, j % 8] & 0xF, scales[:, (j - 8) % 8] >> 4)
    hi = (scales[:, 8 + j % 4] >> (2 * (j // 4))) & 3
    return (lo | (hi << 4)).astype(np.int32) - 32


def _q3k_high_bits(hmask):
    """The third bit (nb, 256) of each Q3_K code, 0 or 1, in element order."""
    g = _Q2K_G
    return (hmask[:, 16 * (g % 2) + (_E % 16)] >> (g // 2)) & 1


def dequant_q3_k(b):
    d = _f16(b, 108)[:, None]
    sc16 = _q3k_scales(b[:, 96:108])
    q = _q2k_codes(b[:, 32:96]).astype(np.int32) - np.where(_q3k_high_bits(b[:, 0:32]) == 0, 4, 0)
    dl = d * sc16[:, _Q2K_G].astype(F32)
    return dl * q.astype(F32)


# element->byte/nibble maps of the Q4_K/Q5_K superblock
_Q4K_IS = 2 * (_E // 64) + (_E % 64) // 32
_Q4K_QIDX = 32 * (_E // 64) + (_E % 32)
_Q4K_NIB = (_E % 64) // 32


def dequant_q4_k(b):
    d = _f16(b, 0)[:, None]
    dmin = _f16(b, 2)[:, None]
    sc, m = _k4_scale_min(b[:, 4:16])
    q = _k4_codes(b[:, 16:144]).astype(F32)
    dl = d * sc[:, _Q4K_IS]
    ml = dmin * m[:, _Q4K_IS]
    return dl * q - ml


def _k4_codes(qs):
    """Nibble codes (nb, 256) of a Q4_K/Q5_K superblock in element order."""
    return np.where(_Q4K_NIB == 0, qs[:, _Q4K_QIDX] & 0xF, qs[:, _Q4K_QIDX] >> 4)


def _q5k_codes(b):
    """5-bit codes 0..31 (nb, 256) of a Q5_K superblock: the nibbles plus the
    high bit, whose index within the qh byte is the element's 32-group."""
    hi = ((b[:, 16:48][:, _E % 32] >> _Q4K_IS) & 1).astype(np.int32) * 16
    return _k4_codes(b[:, 48:176]).astype(np.int32) + hi


def dequant_q5_k(b):
    d = _f16(b, 0)[:, None]
    dmin = _f16(b, 2)[:, None]
    sc, m = _k4_scale_min(b[:, 4:16])
    dl = d * sc[:, _Q4K_IS]
    ml = dmin * m[:, _Q4K_IS]
    return dl * _q5k_codes(b).astype(F32) - ml


# element maps of the Q6_K superblock: two halves of 128, four 32-quads each
_Q6_HALF = _E // 128
_Q6_R = _E % 128
_Q6_QUAD = _Q6_R // 32
_Q6_L = _Q6_R % 32
_Q6_SC = 8 * _Q6_HALF + 2 * _Q6_QUAD + _Q6_L // 16
_Q6_QL = 64 * _Q6_HALF + 32 * (_Q6_QUAD % 2) + _Q6_L
_Q6_QLHI = _Q6_QUAD // 2  # 0 -> low nibble, 1 -> high nibble
_Q6_QH = 32 * _Q6_HALF + _Q6_L
_Q6_QHS = 2 * _Q6_QUAD


def _q6k_codes(b):
    """Signed 6-bit codes -32..31 (nb, 256) of a Q6_K superblock."""
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    lo = np.where(_Q6_QLHI == 0, ql[:, _Q6_QL] & 0xF, ql[:, _Q6_QL] >> 4).astype(np.int32)
    hi = ((qh[:, _Q6_QH] >> _Q6_QHS) & 3).astype(np.int32) << 4
    return (lo | hi) - 32


def dequant_q6_k(b):
    scales = b[:, 192:208].view(np.int8)
    d = _f16(b, 208)[:, None]
    return d * scales[:, _Q6_SC].astype(F32) * _q6k_codes(b).astype(F32)


_DEQUANT = {
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
}

# byte offsets of the fp16 fields of each ported block format
_F16_FIELDS = {
    GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q2_K: (80, 82), GGMLType.Q3_K: (108,),
    GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2), GGMLType.Q8_0: (0,),
    GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2), GGMLType.Q6_K: (208,),
}


def random_blocks(ggml_type: GGMLType, n_blocks: int, rng: np.random.Generator,
                  scale: float = 1e-3) -> np.ndarray:
    """(n_blocks, type_size) uint8 blocks with every code, sub-scale and high
    bit drawn at random and every fp16 field a finite value in
    [scale/2, 3*scale/2) — weights for tests and smoke runs that need no
    quantizer and reach every code value the format can hold."""
    t = GGMLType(ggml_type)
    tr = get_type_traits(t)
    b = rng.integers(0, 256, (n_blocks, tr.type_size), dtype=np.uint8)
    for off in _F16_FIELDS[t]:
        vals = ((rng.random(n_blocks, dtype=F32) + F32(0.5)) * F32(scale)).astype("<f2")
        b[:, off : off + 2] = vals.view(np.uint8).reshape(n_blocks, 2)
    return b


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
    if t not in _DEQUANT:
        raise NotImplementedError(
            f"dequantize {t.name}: not ported yet (ROADMAP.md, the remaining GGUF types)")
    tr = get_type_traits(t)
    if n_elements % tr.block_size:
        raise ValueError(f"{t.name}: {n_elements} elements is not whole blocks")
    nb = n_elements // tr.block_size
    return _DEQUANT[t](data[: nb * tr.type_size].reshape(nb, tr.type_size)).reshape(-1)
