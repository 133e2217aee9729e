"""Planar repack for the port: ggml Q4_K blocks -> compact packed-nibble planes.

The port's own copy of the Q4_K compact path of ggml_tpu/quant/planar.py.
A weight W (N rows of length K, ggml orientation) is stored K-major so that
columns are independent and N is the fastest axis:

  codes   (K/2, Npad) uint8   byte (c, n) holds k=c in its low nibble and
                              k=c+K/2 in its high nibble (two half-planes)
  scales  (2, K/64, Npad) int8  6-bit sub-scale codes, plane-major
  offsets (K/32, Npad) int8     6-bit min codes, natural group order
  d, dmin (2, K/512, Npad)      per-superblock fp32 (repack) or bf16 (synth)

so that w[k, n] = d*sc * q + (-dmin*m) per 32-group, exactly the reference
block_q4_K factoring (src/ggml-common.h:279-290).  Other ggml types and the
non-compact q4 / q8 planes raise NotImplementedError until their slice is
ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..dtypes import GGMLType, get_type_traits
from . import reference as R

F32 = np.float32

_NOT_PORTED = ("not ported yet (ROADMAP.md, GGUF types on q8 planes and "
               "non-compact q4)")


def _compact_planes_q4_k(b):
    """Q4_K planes with the superblock structure kept FACTORED: integer 6-bit
    sub-scale/min codes per 32-group plus d/dmin per 256-element superblock.
    The kernels recompute s = d * sc in fp32, the same arithmetic the
    reference dequantizer does."""
    d = R._f16(b, 0)
    dmin = R._f16(b, 2)
    sc, m = R._k4_scale_min(b[:, 4:16])  # (nb, 8) float-valued 6-bit ints
    qs = b[:, 16:144]
    q = np.where(R._Q4K_NIB == 0, qs[:, R._Q4K_QIDX] & 0xF, qs[:, R._Q4K_QIDX] >> 4).astype(np.int16)
    return q, sc.astype(np.int8), m.astype(np.int8), d, dmin, 32, 8


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


class PlanarWeight(nn.Module):
    """A Q4_K weight repacked into compact planes (see the module docstring).

    The planes are buffers, so `.to(device)` moves them all.  Logical math:
    y = x @ W^T for ggml-orientation W (N rows of length K).
    """

    def __init__(self, kind: str, codes, scales, offsets, group: int, n: int, k: int,
                 orig_type: GGMLType, supers: tuple | None = None, sb: int = 8):
        super().__init__()
        if kind != "q4" or supers is None or offsets is None or group != 32 or sb != 8:
            raise NotImplementedError(
                f"planar weight kind={kind} group={group} compact={supers is not None}: {_NOT_PORTED}")
        self.kind = kind
        self.group = group
        self.n = n
        self.k = k
        self.orig_type = GGMLType(orig_type)
        self.sb = sb
        self.register_buffer("codes", _as_tensor(codes))
        self.register_buffer("scales", _as_tensor(scales))
        self.register_buffer("offsets", _as_tensor(offsets))
        self.register_buffer("d", _as_tensor(supers[0]))
        self.register_buffer("dmin", _as_tensor(supers[1]))

    @property
    def npad(self) -> int:
        return self.codes.shape[-1]

    def plane_bytes(self) -> int:
        """Bytes of every plane a matmul over this weight reads."""
        return sum(t.numel() * t.element_size() for t in self.buffers())


def repack(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, int],
           n_pad_to: int = 128) -> PlanarWeight:
    """Repack raw Q4_K bytes of a (N, K) weight into compact planes."""
    n, k = shape
    ggml_type = GGMLType(ggml_type)
    if not _compact_applicable(ggml_type, k):
        raise NotImplementedError(f"repack {ggml_type.name} at K={k}: {_NOT_PORTED}")
    n_pad_to = _wide_pad(n, n_pad_to)
    tt = get_type_traits(ggml_type)
    blocks = np.asarray(raw).reshape(n * (k // tt.block_size), tt.type_size)
    npad = -(-n // n_pad_to) * n_pad_to
    return _repack_numpy_compact(blocks, ggml_type, n, k, npad)


def _compact_applicable(ggml_type: GGMLType, k: int) -> bool:
    """Compact packed-nibble planes: Q4_K with full superblocks in each
    packed half-plane."""
    return ggml_type == GGMLType.Q4_K and k % 512 == 0


def _repack_numpy_compact(blocks: np.ndarray, ggml_type: GGMLType, n: int, k: int,
                          npad: int) -> PlanarWeight:
    """int8 sub-scale/min codes per group + fp32 d/dmin per superblock (kept
    EXACT: fp32 holds every fp16 value)."""
    q, sc, m, d, dmin, G, SB = _compact_planes_q4_k(blocks)
    q = q.reshape(n, k)
    sc = sc.reshape(n, k // G)
    m = m.reshape(n, k // G)
    d = d.reshape(n, k // (G * SB)).astype(F32)
    dmin = dmin.reshape(n, k // (G * SB)).astype(F32)
    if npad != n:
        pad = lambda a: np.pad(a, ((0, npad - n), (0, 0)))
        q, sc, m, d, dmin = pad(q), pad(sc), pad(m), pad(d), pad(dmin)
    qu = q.astype(np.uint8)
    lo, hi = qu[:, : k // 2], qu[:, k // 2 :]
    codes = np.ascontiguousarray((lo | (hi << 4)).T)  # (K/2, Npad)
    scales = np.ascontiguousarray(sc.T).reshape(2, (k // 2) // G, npad)
    offsets = np.ascontiguousarray(m.T)  # natural order
    d_pl = np.ascontiguousarray(d.T).reshape(2, (k // 2) // (G * SB), npad)
    dmin_pl = np.ascontiguousarray(dmin.T).reshape(2, (k // 2) // (G * SB), npad)
    return PlanarWeight(kind="q4", codes=codes, scales=scales, offsets=offsets, group=G,
                        n=n, k=k, orig_type=ggml_type, supers=(d_pl, dmin_pl), sb=SB)


def _wide_pad(n: int, n_pad_to: int) -> int:
    """Pad large-N weights to a 1024 multiple, as the JAX package does, so
    both packages hold the same planes."""
    if n >= 4096 and n_pad_to < 1024:
        return 1024
    return n_pad_to


def permute_output_columns(pw: PlanarWeight, perm) -> PlanarWeight:
    """Reorder a weight's logical output features (planar column axis) by
    `perm` (length pw.n); padding columns stay in place.  Columns are fully
    independent in the planar layout, so this is an exact relayout — used for
    the on-load RoPE deinterleave permutation (models/gptj.rope_permutation)."""
    idx = torch.from_numpy(np.concatenate([np.asarray(perm), np.arange(len(perm), pw.npad)]))
    idx = idx.to(pw.codes.device)
    take = lambda a: a.index_select(-1, idx).contiguous()
    return PlanarWeight(kind=pw.kind, codes=take(pw.codes), scales=take(pw.scales),
                        offsets=take(pw.offsets), group=pw.group, n=pw.n, k=pw.k,
                        orig_type=pw.orig_type, supers=(take(pw.d), take(pw.dmin)), sb=pw.sb)
