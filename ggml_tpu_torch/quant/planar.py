"""Planar repack for the port: ggml block formats -> matmul planes.

The port's own copy of the ported part of ggml_tpu/quant/planar.py.  Every
format is factored into w[k, n] = s[k // G, n] * q[k, n] + o[k // G, n] with
integer codes q, a scale s and an optional offset o per group of G elements.
A weight W (N rows of length K, ggml orientation) is stored K-major so that
columns are independent and N is the fastest axis.

q4 planes (packed nibbles: Q4_0, Q4_1, Q2_K, Q3_K, Q4_K where (K/2) % G == 0):
  codes   (K/2, Npad) uint8   byte (c, n) holds k=c in its low nibble and
                              k=c+K/2 in its high nibble (two half-planes)
  scales  (2, K/2/G, Npad)    effective scale, plane-major, fp32 (repack) or
                              bf16 (synth)
  offsets (K/G, Npad) or None effective offset, natural group order
or, COMPACT, for Q4_K at K % 512 == 0 (G=32, sb=8):
  scales  (2, K/64, Npad) int8  6-bit sub-scale codes, plane-major
  offsets (K/32, Npad) int8     6-bit min codes, natural group order
  d, dmin (2, K/512, Npad)      per-superblock fp32 (repack) or bf16 (synth)

q8 planes (Q8_0, Q5_0, Q5_1, Q5_K, Q6_K, the IQ* and TQ* types; Q4_K with
force_q8):
  codes   (K, Npad) int8
  scales  (K/G, Npad)         effective scale, fp32 (repack) or bf16 (synth)
  offsets (K/G, Npad) or None effective offset of the affine types
                              (IQ1_S, IQ1_M: scale times their +-1/8 delta)
or, COMPACT, for the K-quants at K % 256 == 0 (Q5_K: G=32, sb=8, affine;
Q6_K: G=16, sb=16, signed sub-scales, no offsets):
  scales  (K/G, Npad) int8      sub-scale codes
  offsets (K/G, Npad) int8 or None  min codes
  d, dmin (K/(G*sb), Npad)      per-superblock fp32; dmin None without offsets
with s = d * scales and o = -dmin * offsets rebuilt in f32 by the kernels,
exactly the reference block factoring (src/ggml-common.h:279-320).

Groups of the i-quants and ternary types, as the JAX package factors them:
32 for IQ4_NL, IQ4_XS, IQ2_XXS, IQ3_XXS, IQ3_S and IQ1_S; 16 for IQ2_XS and
IQ2_S; 8 for IQ1_M; 256 for TQ1_0 and TQ2_0.  Their codes are the grid
values times their signs (-127..113 for the IQ4 types).  The JAX package
holds them as multiplied-out int8 planes with f32 scales, and so does the
port: an IQ1_M weight takes 2 bytes of planes (1 + 0.5 + 0.5).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..dtypes import GGMLType, get_type_traits, row_size
from . import reference as R

F32 = np.float32



# Per-type plane extractors: (nb, type_size) uint8 raw blocks ->
#   q (nb, block) integer codes, s (nb, block // G) fp32 effective scale,
#   o (nb, block // G) fp32 effective offset or None, G
# in natural element order (that of reference dequantize_row_*).


def _nibbles(qs):
    return np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int16)


def _planes_q4_0(b):
    d = R._f16(b, 0)
    return _nibbles(b[:, 2:18]), d[:, None], (-8.0 * d)[:, None], 32


def _planes_q4_1(b):
    return _nibbles(b[:, 4:20]), R._f16(b, 0)[:, None], R._f16(b, 2)[:, None], 32


def _planes_q5_0(b):
    return R._q5_codes(b, 2) - 16, R._f16(b, 0)[:, None], None, 32


def _planes_q5_1(b):
    return R._q5_codes(b, 4), R._f16(b, 0)[:, None], R._f16(b, 2)[:, None], 32


def _planes_q8_0(b):
    return b[:, 2:34].view(np.int8).astype(np.int16), R._f16(b, 0)[:, None], None, 32


def _planes_q2_k(b):
    d = R._f16(b, 80)[:, None]
    dmin = R._f16(b, 82)[:, None]
    scales = b[:, 0:16]
    s = d * (scales & 0xF).astype(F32)
    o = -dmin * (scales >> 4).astype(F32)
    return R._q2k_codes(b[:, 16:80]).astype(np.int16), s, o, 16


def _planes_q3_k(b):
    d = R._f16(b, 108)[:, None]
    # value = code2 - 4 when the high bit is clear: store code + 4 in 0..7
    q = R._q2k_codes(b[:, 32:96]).astype(np.int16) + 4 * R._q3k_high_bits(b[:, 0:32]).astype(np.int16)
    s = d * R._q3k_scales(b[:, 96:108]).astype(F32)
    return q, s, -4.0 * s, 16


def _planes_q4_k(b):
    q, sc, m, d, dmin, G, _ = _compact_planes_q4_k(b)
    return q, d[:, None] * sc.astype(F32), -dmin[:, None] * m.astype(F32), G


def _planes_iq4_nl(b):
    q = np.concatenate([R.KVALUES_IQ4NL[b[:, 2:18] & 0xF], R.KVALUES_IQ4NL[b[:, 2:18] >> 4]], axis=1)
    return q.astype(np.int16), R._f16(b, 0)[:, None], None, 32


def _planes_iq4_xs(b):
    s, q = R._iq4xs_parts(b)
    return q.astype(np.int16), s, None, 32


def _signed_grid(parts, G):
    s, grid, signs = parts
    return (grid.astype(np.int16) * signs.astype(np.int16)).reshape(len(grid), 256), s.reshape(len(s), -1), None, G


def _planes_iq2_xxs(b):
    return _signed_grid(R._iq2xxs_parts(b), 32)


def _planes_iq2_xs(b):
    return _signed_grid(R._iq2xs_parts(b), 16)


def _planes_iq2_s(b):
    return _signed_grid(R._iq2s_parts(b), 16)


def _planes_iq3_xxs(b):
    return _signed_grid(R._iq3xxs_parts(b), 32)


def _planes_iq3_s(b):
    return _signed_grid(R._iq3s_parts(b), 32)


def _planes_iq1_s(b):
    s, delta, grid = R._iq1s_parts(b)
    return grid.astype(np.int16), s, s * delta, 32


def _planes_iq1_m(b):
    dl, delta, grid = R._iq1m_parts(b)
    nb = len(b)
    return grid.astype(np.int16), dl.reshape(nb, 32), (dl * delta).reshape(nb, 32), 8


def _ternary_planes(w, d):
    """Codes -1..1 of a ternary block back from its dequantized values."""
    dd = np.where(d == 0, F32(1.0), d)
    return np.rint(w / dd[:, None]).astype(np.int16), d[:, None], None, 256


def _planes_tq1_0(b):
    return _ternary_planes(R.dequant_tq1_0(b), R._f16(b, 52))


def _planes_tq2_0(b):
    return _ternary_planes(R.dequant_tq2_0(b), R._f16(b, 64))


# Compact extractors keep the superblock structure FACTORED: integer
# sub-scale/min codes per group plus d/dmin per 256-element superblock ->
#   q, sc int8, m int8 or None, d (nb,), dmin (nb,) or None, G, groups per superblock


def _compact_planes_q4_k(b):
    sc, m = R._k4_scale_min(b[:, 4:16])  # (nb, 8) float-valued 6-bit ints
    q = R._k4_codes(b[:, 16:144]).astype(np.int16)
    return q, sc.astype(np.int8), m.astype(np.int8), R._f16(b, 0), R._f16(b, 2), 32, 8


def _compact_planes_q5_k(b):
    sc, m = R._k4_scale_min(b[:, 4:16])
    return R._q5k_codes(b), sc.astype(np.int8), m.astype(np.int8), R._f16(b, 0), R._f16(b, 2), 32, 8


def _compact_planes_q6_k(b):
    """Signed int8 sub-scales per 16-group, codes -32..31, no offsets."""
    return R._q6k_codes(b), b[:, 192:208].view(np.int8).copy(), None, R._f16(b, 208), None, 16, 16


_COMPACT_PLANES = {
    GGMLType.Q4_K: _compact_planes_q4_k,
    GGMLType.Q5_K: _compact_planes_q5_k,
    GGMLType.Q6_K: _compact_planes_q6_k,
}

# Q5_K and Q6_K always take the compact planes (their K is whole superblocks),
# so of the compact types only Q4_K needs a multiplied-out extractor, for
# force_q8 and for K % 512 != 0.
_PLANES = {
    GGMLType.Q4_0: _planes_q4_0,
    GGMLType.Q4_1: _planes_q4_1,
    GGMLType.Q2_K: _planes_q2_k,
    GGMLType.Q3_K: _planes_q3_k,
    GGMLType.Q5_0: _planes_q5_0,
    GGMLType.Q5_1: _planes_q5_1,
    GGMLType.Q8_0: _planes_q8_0,
    GGMLType.Q4_K: _planes_q4_k,
    GGMLType.IQ4_NL: _planes_iq4_nl,
    GGMLType.IQ4_XS: _planes_iq4_xs,
    GGMLType.IQ2_XXS: _planes_iq2_xxs,
    GGMLType.IQ2_XS: _planes_iq2_xs,
    GGMLType.IQ2_S: _planes_iq2_s,
    GGMLType.IQ3_XXS: _planes_iq3_xxs,
    GGMLType.IQ3_S: _planes_iq3_s,
    GGMLType.IQ1_S: _planes_iq1_s,
    GGMLType.IQ1_M: _planes_iq1_m,
    GGMLType.TQ1_0: _planes_tq1_0,
    GGMLType.TQ2_0: _planes_tq2_0,
}

# Types whose codes fit an unsigned 4-bit plane (0..15).
_Q4_PLANE_TYPES = {GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K}


def planar_types() -> set[GGMLType]:
    return set(_PLANES) | set(_COMPACT_PLANES)


def _as_tensor(a):
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class PlanarWeight(nn.Module):
    """A weight repacked into planes (see the module docstring).

    The planes are buffers, so `.to(device)` moves them all; a plane the
    format does not have (offsets, d, dmin) is None.  Logical math:
    y = x @ W^T for ggml-orientation W (N rows of length K).
    """

    def __init__(self, kind: str, codes, scales, offsets, group: int, n: int, k: int,
                 orig_type: GGMLType, supers: tuple | None = None, sb: int = 8):
        super().__init__()
        if kind not in ("q4", "q8"):
            raise ValueError(f"unknown plane kind {kind!r}")
        if supers is not None and (supers[1] is None) != (offsets is None):
            raise ValueError("compact planes carry dmin exactly when they carry min codes")
        if kind == "q4" and supers is not None and (offsets is None or group != 32 or sb != 8):
            raise ValueError("compact q4 planes are the Q4_K factoring: groups of 32, 8 per superblock, min codes")
        self.kind = kind
        self.group = group
        self.n = n
        self.k = k
        self.orig_type = GGMLType(orig_type)
        self.sb = sb
        d, dmin = (None, None) if supers is None else supers
        for name, plane in (("codes", codes), ("scales", scales), ("offsets", offsets),
                            ("d", d), ("dmin", dmin)):
            self.register_buffer(name, _as_tensor(plane))

    @property
    def npad(self) -> int:
        return self.codes.shape[-1]

    @property
    def supers(self) -> tuple | None:
        """(d, dmin) of compact planes, None for multiplied-out planes."""
        return None if self.d is None else (self.d, self.dmin)

    def plane_bytes(self) -> int:
        """Bytes of every plane a matmul over this weight reads."""
        return sum(t.numel() * t.element_size() for t in self.buffers())


def repack(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, int],
           n_pad_to: int = 128, force_q8: bool = False) -> PlanarWeight:
    """Repack raw ggml-format bytes of a (N, K) weight into planes.

    force_q8 keeps the 4-bit types on int8 planes with multiplied-out fp32
    scales and offsets in place of the packed-nibble planes."""
    n, k = shape
    ggml_type = GGMLType(ggml_type)
    if ggml_type not in planar_types():
        raise NotImplementedError(f"repack {ggml_type.name}: no planes for this type")
    compact = _compact_applicable(ggml_type, k, force_q8)
    tt = get_type_traits(ggml_type)
    blocks = np.asarray(raw).reshape(n * (k // tt.block_size), tt.type_size)
    n_pad_to = _wide_pad(n, n_pad_to)
    npad = -(-n // n_pad_to) * n_pad_to
    if compact:
        return _repack_numpy_compact(blocks, ggml_type, n, k, npad)

    q, s, o, G = _PLANES[ggml_type](blocks)
    pad = lambda a: np.pad(a, ((0, npad - n), (0, 0)))
    q = pad(q.reshape(n, k))
    plane = lambda a: np.ascontiguousarray(pad(a.reshape(n, k // G)).T.astype(F32))  # (K/G, Npad)
    scales, offsets = plane(s), None if o is None else plane(o)
    # q4: half the code bytes; else int8 codes
    if ggml_type in _Q4_PLANE_TYPES and (k // 2) % G == 0 and not force_q8:
        kind, codes = "q4", _pack_halves(q, k)
        # plane-major scales (2, K/2/G, Npad): [0] = low-nibble plane (k < K/2)
        scales = scales.reshape(2, (k // 2) // G, npad)
    else:
        kind, codes = "q8", np.ascontiguousarray(q.astype(np.int8).T)
    return PlanarWeight(kind=kind, codes=codes, scales=scales, offsets=offsets, group=G,
                        n=n, k=k, orig_type=ggml_type)


def _pack_halves(q: np.ndarray, k: int) -> np.ndarray:
    """(Npad, K) codes 0..15 -> (K/2, Npad) uint8: k < K/2 in the low nibble,
    k + K/2 in the high nibble of the same byte."""
    qu = q.astype(np.uint8)
    return np.ascontiguousarray((qu[:, : k // 2] | (qu[:, k // 2 :] << 4)).T)


def _compact_applicable(ggml_type: GGMLType, k: int, force_q8: bool = False) -> bool:
    """Compact sub-scale planes: the K-quants whose superblock factoring is
    kept, where K is whole superblocks (in each packed half-plane for q4)."""
    if ggml_type not in _COMPACT_PLANES:
        return False
    if ggml_type in _Q4_PLANE_TYPES:
        return not force_q8 and k % 512 == 0
    return k % 256 == 0


def _repack_numpy_compact(blocks: np.ndarray, ggml_type: GGMLType, n: int, k: int,
                          npad: int) -> PlanarWeight:
    """int8 sub-scale(/min) codes per group + fp32 d(/dmin) per superblock
    (kept EXACT: fp32 holds every fp16 value)."""
    q, sc, m, d, dmin, G, SB = _COMPACT_PLANES[ggml_type](blocks)

    def plane(a, per_row, dtype=None):
        """(nb, ...) block field -> (per_row, Npad) plane, N last."""
        if a is None:
            return None
        a = np.pad(a.reshape(n, per_row), ((0, npad - n), (0, 0)))
        return np.ascontiguousarray(a.T if dtype is None else a.T.astype(dtype))

    sc, m = plane(sc, k // G), plane(m, k // G)
    d, dmin = plane(d, k // (G * SB), F32), plane(dmin, k // (G * SB), F32)
    if ggml_type in _Q4_PLANE_TYPES:
        codes = _pack_halves(np.pad(q.reshape(n, k), ((0, npad - n), (0, 0))), k)
        # sub-scales and d/dmin plane-major; min codes stay in natural order
        halves = lambda a: a.reshape(2, a.shape[0] // 2, npad)
        return PlanarWeight(kind="q4", codes=codes, scales=halves(sc), offsets=m, group=G,
                            n=n, k=k, orig_type=ggml_type, supers=(halves(d), halves(dmin)), sb=SB)
    return PlanarWeight(kind="q8", codes=plane(q, k, np.int8), scales=sc, offsets=m, group=G,
                        n=n, k=k, orig_type=ggml_type, supers=(d, dmin), sb=SB)


def _wide_pad(n: int, n_pad_to: int) -> int:
    """Pad large-N weights to a 1024 multiple, as the JAX package does, so
    both packages hold the same planes."""
    if n >= 4096 and n_pad_to < 1024:
        return 1024
    return n_pad_to


def repack_rows(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, int], r0: int, r1: int,
                n_pad_to: int = 128) -> PlanarWeight:
    """repack of rows [r0, r1) of a (N, K) weight whose raw bytes are `raw`,
    padded as the whole weight pads: concat_columns of such parts, each but
    the last a whole number of padding units (padding_unit(N)), is the
    whole weight's repack."""
    n, k = shape
    rb = row_size(ggml_type, k)
    return repack(np.asarray(raw).reshape(-1)[r0 * rb:r1 * rb], ggml_type, (r1 - r0, k),
                  n_pad_to=padding_unit(n, n_pad_to))


def padding_unit(n: int, n_pad_to: int = 128) -> int:
    """The multiple of rows repack pads a weight of n rows to."""
    return _wide_pad(n, n_pad_to)


def concat_columns(parts: list) -> PlanarWeight:
    """One PlanarWeight from repack_rows parts of consecutive row ranges:
    their planes side by side along the N (last) axis, which holds the
    columns independently."""
    first = parts[0]
    cat = lambda name: None if getattr(first, name) is None else torch.cat([getattr(p, name) for p in parts], -1)
    return PlanarWeight(kind=first.kind, codes=cat("codes"), scales=cat("scales"), offsets=cat("offsets"),
                        group=first.group, n=sum(p.n for p in parts), k=first.k, orig_type=first.orig_type,
                        sb=first.sb, supers=None if first.d is None else (cat("d"), cat("dmin")))


def _rebuild(pw: PlanarWeight, f) -> PlanarWeight:
    """pw with f applied to every plane it has."""
    g = lambda t: None if t is None else f(t)
    return PlanarWeight(kind=pw.kind, codes=f(pw.codes), scales=f(pw.scales), offsets=g(pw.offsets),
                        group=pw.group, n=pw.n, k=pw.k, orig_type=pw.orig_type, sb=pw.sb,
                        supers=None if pw.d is None else (f(pw.d), g(pw.dmin)))


def permute_output_columns(pw: PlanarWeight, perm) -> PlanarWeight:
    """Reorder a weight's logical output features (planar column axis) by
    `perm` (length pw.n); padding columns stay in place.  Columns are fully
    independent in the planar layout, so this is an exact relayout — used for
    the on-load RoPE deinterleave permutation (models/gptj.rope_permutation)."""
    idx = torch.from_numpy(np.concatenate([np.asarray(perm), np.arange(len(perm), pw.npad)]))
    idx = idx.to(pw.codes.device)
    return _rebuild(pw, lambda a: a.index_select(-1, idx).contiguous())


def effective_planes(pw: PlanarWeight):
    """Effective f32 group scale and offset (or None) of a weight: the planes
    themselves, or d * sub-scale and -dmin * min code of compact planes
    multiplied out in f32 — the arithmetic the reference dequantizer does.
    The scale keeps the layout of pw.scales (plane-major 3-D for q4); the
    offset is in natural group order (K/G, Npad)."""
    if pw.d is None:
        return pw.scales.float(), None if pw.offsets is None else pw.offsets.float()
    eff_s = pw.d.float().repeat_interleave(pw.sb, dim=-2) * pw.scales.float()
    eff_o = None
    if pw.offsets is not None:
        dmin_nat = pw.dmin.float().reshape(-1, pw.npad)
        eff_o = -dmin_nat.repeat_interleave(pw.sb, dim=0) * pw.offsets.float()
    return eff_s, eff_o


def expand_compact(pw: PlanarWeight) -> PlanarWeight:
    """Multiply a compact K-quant factoring back out to fp32 effective
    scale/offset planes (supers=None)."""
    if pw.d is None:
        return pw
    eff_s, eff_o = effective_planes(pw)
    return PlanarWeight(kind=pw.kind, codes=pw.codes, scales=eff_s, offsets=eff_o, group=pw.group,
                        n=pw.n, k=pw.k, orig_type=pw.orig_type)


def dequant_planar(pw: PlanarWeight) -> np.ndarray:
    """Reconstruct (N, K) fp32 weights from a PlanarWeight (for testing)."""
    eff_s, eff_o = effective_planes(pw)
    if pw.kind == "q4":
        q = torch.cat([pw.codes & 0xF, pw.codes >> 4], dim=0).float()  # (K, Npad)
    else:
        q = pw.codes.float()
    w = eff_s.reshape(-1, pw.npad).repeat_interleave(pw.group, dim=0) * q
    if eff_o is not None:
        w = w + eff_o.repeat_interleave(pw.group, dim=0)
    return w.T[: pw.n].cpu().numpy()
