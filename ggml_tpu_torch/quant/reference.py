"""Reference dequantization in NumPy — the port's own copy of the parts of
ggml_tpu/quant/reference.py the ported slices need: the scalar float types
and the block decodes of Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K,
Q6_K, the ternary TQ1_0 and TQ2_0 and the i-quants IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, IQ4_NL and IQ4_XS (reference:
src/ggml-quants.c dequantize_row_*, block layouts src/ggml-common.h).  The
i-quant codebooks are the port's own copy of the JAX package's grid file
(data/iq_grids.npz, byte for byte).
"""

from __future__ import annotations

import os

import numpy as np

from ..dtypes import QK_K, GGMLType, bf16_bits_to_fp32, fp16_bits_to_fp32, get_type_traits

F32 = np.float32
_GRIDS = np.load(os.path.join(os.path.dirname(__file__), "data", "iq_grids.npz"))
# codebook tables (format-defining constants, reference: src/ggml-common.h:461-1589)
KMASK_IQ2XS = _GRIDS["kmask_iq2xs"]
KSIGNS_IQ2XS = _GRIDS["ksigns_iq2xs"]
IQ2XXS_GRID = _GRIDS["iq2xxs_grid"].view(np.uint8).reshape(256, 8)
IQ2XS_GRID = _GRIDS["iq2xs_grid"].view(np.uint8).reshape(512, 8)
IQ2S_GRID = _GRIDS["iq2s_grid"].view(np.uint8).reshape(1024, 8)
IQ3XXS_GRID = _GRIDS["iq3xxs_grid"].view(np.uint8).reshape(256, 4)
IQ3S_GRID = _GRIDS["iq3s_grid"].view(np.uint8).reshape(512, 4)
IQ1S_GRID = _GRIDS["iq1s_grid"].view(np.int8).reshape(2048, 8)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113], dtype=np.int8
)  # reference: src/ggml-quants.c:2434
IQ1S_DELTA = F32(0.125)  # reference: src/ggml-common.h:1072


def _f16(blocks: np.ndarray, off: int) -> np.ndarray:
    """fp16 scalar field at byte offset -> (nb,) float32."""
    return np.ascontiguousarray(blocks[:, off : off + 2]).view("<f2").astype(F32).reshape(-1)


def _u16(blocks: np.ndarray, off: int, n: int = 1) -> np.ndarray:
    return np.ascontiguousarray(blocks[:, off : off + 2 * n]).view("<u2").reshape(len(blocks), n)


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


# --- ternary ----------------------------------------------------------------

_POW3 = np.array([1, 3, 9, 27, 81, 243], dtype=np.uint8)


def _trits(qs, n: int):
    """Trit n (0, 1 or 2) of each base-3 packed byte, minus 1."""
    q = (qs * _POW3[n]).astype(np.uint8)
    return ((q.astype(np.uint16) * 3) >> 8).astype(np.int16) - 1


def dequant_tq1_0(b):
    nb = len(b)
    qs = b[:, 0:48]
    qh = b[:, 48:52]
    d = _f16(b, 52)[:, None]
    out = np.empty((nb, QK_K), dtype=F32)
    # first 32-byte chunk: 5 trits per byte, elements laid out m + 32*n
    for n in range(5):
        out[:, 32 * n : 32 * (n + 1)] = _trits(qs[:, 0:32], n).astype(F32)
    for n in range(5):
        out[:, 160 + 16 * n : 160 + 16 * (n + 1)] = _trits(qs[:, 32:48], n).astype(F32)
    for n in range(4):
        out[:, 240 + 4 * n : 240 + 4 * (n + 1)] = _trits(qh, n).astype(F32)
    return out * d


def dequant_tq2_0(b):
    # element 128 h + 32 j + l is bits 2 j of byte 32 h + l
    qs = b[:, 0:64].reshape(len(b), 2, 1, 32)
    d = _f16(b, 64)[:, None]
    q = ((qs >> np.array([0, 2, 4, 6], np.uint8)[:, None]) & 3).astype(np.int8).reshape(len(b), QK_K) - 1
    return q.astype(F32) * d


# --- i-quants ---------------------------------------------------------------


def _signs_for(bits7: np.ndarray) -> np.ndarray:
    """(...,) 7-bit sign codes -> (..., 8) +1/-1 float32 via ksigns/kmask."""
    signs = KSIGNS_IQ2XS[bits7]
    return np.where((signs[..., None] & KMASK_IQ2XS) != 0, F32(-1.0), F32(1.0))


def _bit_signs(signs_b):
    """(...,) sign bytes -> (..., 8) +1/-1 float32, bit j the sign of value j."""
    return np.where((signs_b[..., None] & KMASK_IQ2XS) != 0, F32(-1.0), F32(1.0))


def _iq2xxs_parts(b):
    """IQ2_XXS: (nb, 8) f32 scale per 32, (nb, 8, 4, 8) grid values, signs."""
    nb = len(b)
    d = _f16(b, 0)
    q16 = _u16(b, 2, 32).reshape(nb, 8, 2, 2)  # (nb, ib32, aux32 idx, u16 pair)
    aux32 = q16[..., 0].astype(np.uint32) | (q16[..., 1].astype(np.uint32) << 16)  # (nb, 8, 2)
    aux8 = np.ascontiguousarray(aux32[..., 0]).view(np.uint8).reshape(nb, 8, 4)
    db = d[:, None] * (F32(0.5) + (aux32[..., 1] >> 28).astype(F32)) * F32(0.25)  # (nb, 8)
    shifts = (7 * np.arange(4))[None, None, :]
    return db, IQ2XXS_GRID[aux8], _signs_for((aux32[..., 1:2] >> shifts) & 127)


def dequant_iq2_xxs(b):
    db, grid, signs = _iq2xxs_parts(b)
    return (db[:, :, None, None] * grid.astype(F32) * signs).reshape(len(b), QK_K)


def _half_scales(d, scales):
    """IQ2_XS/IQ2_S: 4-bit scale codes, two a byte -> (nb, 8, 2) f32 scales of 16 values."""
    sc = np.stack([scales & 0xF, scales >> 4], axis=-1).astype(F32)
    return d[:, None, None] * (F32(0.5) + sc) * F32(0.25)


def _iq2xs_parts(b):
    nb = len(b)
    q16 = _u16(b, 2, 32).reshape(nb, 8, 4)
    return _half_scales(_f16(b, 0), b[:, 66:74]), IQ2XS_GRID[q16 & 511], _signs_for(q16 >> 9)


def dequant_iq2_xs(b):
    db, grid, signs = _iq2xs_parts(b)
    db_l = db[:, :, np.arange(4) // 2]  # (nb, 8, 4)
    return (db_l[..., None] * grid.astype(F32) * signs).reshape(len(b), QK_K)


def _iq2s_parts(b):
    nb = len(b)
    qs = b[:, 2:34].reshape(nb, 8, 4)
    qh = b[:, 66:74]
    l = np.arange(4)
    idx = qs.astype(np.int32) | ((qh[:, :, None].astype(np.int32) << (8 - 2 * l)) & 0x300)
    return _half_scales(_f16(b, 0), b[:, 74:82]), IQ2S_GRID[idx], _bit_signs(b[:, 34:66].reshape(nb, 8, 4))


def dequant_iq2_s(b):
    db, grid, signs = _iq2s_parts(b)
    db_l = db[:, :, np.arange(4) // 2]
    return (db_l[..., None] * grid.astype(F32) * signs).reshape(len(b), QK_K)


def _iq3xxs_parts(b):
    nb = len(b)
    d = _f16(b, 0)
    qs = b[:, 2:66].reshape(nb, 8, 8)  # 8 grid-bytes per ib32
    aux32 = _u32(b, 66, 8)  # scales and signs, one u32 per ib32
    db = d[:, None] * (F32(0.5) + (aux32 >> 28).astype(F32)) * F32(0.5)  # (nb, 8)
    shifts = (7 * np.arange(4))[None, None, :]
    # pairs of 4-value rows
    return db, IQ3XXS_GRID[qs].reshape(nb, 8, 4, 8), _signs_for((aux32[..., None] >> shifts) & 127)


def dequant_iq3_xxs(b):
    db, grid, signs = _iq3xxs_parts(b)
    return (db[:, :, None, None] * grid.astype(F32) * signs).reshape(len(b), QK_K)


def _iq3s_parts(b):
    """Per ib32 (8 of them): 8 qs bytes, 1 qh byte, 4 sign bytes, a 4-bit scale."""
    nb = len(b)
    d = _f16(b, 0)
    qs = b[:, 2:66].reshape(nb, 8, 8)
    qh = b[:, 66:74]
    scales = b[:, 106:110]
    sc_pair = np.stack([scales & 0xF, scales >> 4], axis=-1).reshape(nb, 8)  # per ib32
    db = d[:, None] * (1 + 2 * sc_pair).astype(F32)  # (nb, 8)
    l = np.arange(4)
    idx1 = qs[:, :, 0::2].astype(np.int32) | ((qh[:, :, None].astype(np.int32) << (8 - 2 * l)) & 256)
    idx2 = qs[:, :, 1::2].astype(np.int32) | ((qh[:, :, None].astype(np.int32) << (7 - 2 * l)) & 256)
    grid = np.concatenate([IQ3S_GRID[idx1], IQ3S_GRID[idx2]], axis=-1)  # (nb, 8, 4, 8) j: 0-3 idx1, 4-7 idx2
    return db, grid, _bit_signs(b[:, 74:106].reshape(nb, 8, 4))


def dequant_iq3_s(b):
    db, grid, signs = _iq3s_parts(b)
    return (db[:, :, None, None] * grid.astype(F32) * signs).reshape(len(b), QK_K)


def _iq1s_parts(b):
    """IQ1_S: (nb, 8) scale and delta per 32, (nb, 256) grid values -1..1."""
    nb = len(b)
    d = _f16(b, 0)
    qs = b[:, 2:34].reshape(nb, 8, 4)
    qh = _u16(b, 34, 8)  # (nb, 8)
    dl = d[:, None] * (2 * ((qh >> 12) & 7) + 1).astype(F32)  # (nb, 8)
    delta = np.where((qh & 0x8000) != 0, -IQ1S_DELTA, IQ1S_DELTA)  # (nb, 8)
    l = np.arange(4)
    idx = qs.astype(np.int32) | (((qh[:, :, None].astype(np.int32) >> (3 * l)) & 7) << 8)
    return dl, delta, IQ1S_GRID[idx].reshape(nb, QK_K)


def dequant_iq1_s(b):
    dl, delta, grid = _iq1s_parts(b)
    nb = len(b)
    return (dl[:, :, None] * (grid.reshape(nb, 8, 32).astype(F32) + delta[:, :, None])).reshape(nb, QK_K)


def iq1m_d(b) -> np.ndarray:
    """IQ1_M's block scale: an fp16 whose four nibbles are the top nibbles of
    the four u16 scale words at bytes 48-55 (reference: src/ggml-quants.c
    dequantize_row_iq1_m)."""
    sc = _u16(b, 48, 4)
    bits = (sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)
    return fp16_bits_to_fp32(bits.astype(np.uint16))


def _iq1m_parts(b):
    """IQ1_M: (nb, 8, 4) scale and delta per 8 values, (nb, 256) grid values."""
    nb = len(b)
    qs = b[:, 0:32].reshape(nb, 8, 4)
    qh = b[:, 32:48].reshape(nb, 8, 2)
    sc = _u16(b, 48, 4)  # (nb, 4)
    d = iq1m_d(b)
    ib = np.arange(8)
    dl1 = d[:, None] * (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 0)) & 0x7) + 1).astype(F32)
    dl2 = d[:, None] * (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 3)) & 0x7) + 1).astype(F32)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=-1)  # (nb, 8, 4) per l
    idx = np.empty((nb, 8, 4), dtype=np.int32)
    delta = np.empty((nb, 8, 4), dtype=F32)
    for l, (byte, shift, sign) in enumerate(((0, 8, 0x08), (0, 4, 0x80), (1, 8, 0x08), (1, 4, 0x80))):
        idx[..., l] = qs[..., l] | ((qh[..., byte].astype(np.int32) << shift) & 0x700)
        delta[..., l] = np.where((qh[..., byte] & sign) != 0, -IQ1S_DELTA, IQ1S_DELTA)
    return dl, delta, IQ1S_GRID[idx].reshape(nb, QK_K)


def dequant_iq1_m(b):
    dl, delta, grid = _iq1m_parts(b)
    nb = len(b)
    return (dl[..., None] * (grid.reshape(nb, 8, 4, 8).astype(F32) + delta[..., None])).reshape(nb, QK_K)


def dequant_iq4_nl(b):
    d = _f16(b, 0)[:, None]
    qs = b[:, 2:18]
    return d * np.concatenate([KVALUES_IQ4NL[qs & 0xF], KVALUES_IQ4NL[qs >> 4]], axis=1).astype(F32)


def _iq4xs_parts(b):
    """IQ4_XS: (nb, 8) f32 scale per 32, (nb, 256) int8 values."""
    nb = len(b)
    d = _f16(b, 0)
    scales_h = _u16(b, 2).reshape(-1)
    scales_l = b[:, 4:8]
    qs = b[:, 8:136].reshape(nb, 8, 16)
    ib = np.arange(8)
    ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF).astype(np.int32) | (
        ((scales_h[:, None].astype(np.int32) >> (2 * ib)) & 3) << 4
    )
    vals = np.concatenate([KVALUES_IQ4NL[qs & 0xF], KVALUES_IQ4NL[qs >> 4]], axis=-1)  # (nb, 8, 32)
    return d[:, None] * (ls - 32).astype(F32), vals.reshape(nb, QK_K)


def dequant_iq4_xs(b):
    dl, vals = _iq4xs_parts(b)
    nb = len(b)
    return (dl[:, :, None] * vals.reshape(nb, 8, 32).astype(F32)).reshape(nb, QK_K)


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
    GGMLType.TQ1_0: dequant_tq1_0,
    GGMLType.TQ2_0: dequant_tq2_0,
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
}

# byte offsets of the fp16 fields of each ported block format; IQ1_M's block
# scale is spread over the top nibbles of its scale words (iq1m_d)
_F16_FIELDS = {
    GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q2_K: (80, 82), GGMLType.Q3_K: (108,),
    GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2), GGMLType.Q8_0: (0,),
    GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2), GGMLType.Q6_K: (208,),
    GGMLType.TQ1_0: (52,), GGMLType.TQ2_0: (64,),
    GGMLType.IQ2_XXS: (0,), GGMLType.IQ2_XS: (0,), GGMLType.IQ2_S: (0,), GGMLType.IQ3_XXS: (0,),
    GGMLType.IQ3_S: (0,), GGMLType.IQ1_S: (0,), GGMLType.IQ4_NL: (0,), GGMLType.IQ4_XS: (0,),
    GGMLType.IQ1_M: (),
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
    draw = lambda: ((rng.random(n_blocks, dtype=F32) + F32(0.5)) * F32(scale)).astype("<f2")
    for off in _F16_FIELDS[t]:
        b[:, off : off + 2] = draw().view(np.uint8).reshape(n_blocks, 2)
    if t == GGMLType.IQ1_M:  # nibble i of d into the top nibble of scale word i (byte 49 + 2 i)
        bits = draw().view(np.uint16)
        for i in range(4):
            b[:, 49 + 2 * i] = (b[:, 49 + 2 * i] & 0x0F) | (((bits >> (4 * i)) & 0xF) << 4).astype(np.uint8)
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
        raise NotImplementedError(f"dequantize {t.name}: no dequantizer for this type")
    tr = get_type_traits(t)
    if n_elements % tr.block_size:
        raise ValueError(f"{t.name}: {n_elements} elements is not whole blocks")
    nb = n_elements // tr.block_size
    return _DEQUANT[t](data[: nb * tr.type_size].reshape(nb, tr.type_size)).reshape(-1)
