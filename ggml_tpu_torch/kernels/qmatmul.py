"""Fused Q4_K matmuls over compact packed-nibble planes (kernels A, B, C).

The port of ggml_tpu/kernels/qmatmul.py for the compact Q4_K planes of
quant/planar.py.  `planar_matmul` dispatches as `_planar_matmul_impl` does:

  M == 1        q4k_gemv_qact  int8 activations with one scale per K-tile per
                               half-plane, quantized on the device (kernel A,
                               csrc/q4k_gemv.cu)
  2 <= M <= 32  q4k_gemv_rows  int8 activations with one scale per row
                               (kernel B, csrc/q4k_gemv.cu)
  M > 32        q4k_matmul     bf16 weights dequantized per tile, bf16 dot,
                               f32 sums, f32 offset term (kernel C,
                               csrc/q4k_matmul.cu)

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors; it never falls back from one to the other.  The
plain versions compute the same function as the JAX kernels, with the same
activation quantization, the same bf16 rounding points and f32 sums, and are
what the CPU tests compare with JAX and what the card's kernels are held to.
`launches` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from ..quant.planar import PlanarWeight
from . import _build

GEMV_MAX_M = 32  # int-GEMV path for decode-sized row counts (qmatmul.py:866)

launches = {"q4k_gemv_qact": 0, "q4k_gemv_rows": 0, "q4k_matmul": 0}

_BN = 128  # column strip of the GEMV kernels; Npad must be a multiple of it


def _sb_gemv_k_tile(k2: int, G: int, sb: int) -> int | None:
    """k-tile for the compact-plane GEMV, or None if no VMEM-safe legal tile
    exists.  Legality: superblock-plane tiles need (kt2/(G*sb)) % 8 == 0, or
    kt2 == k2 (the (1, rows, bn) block then spans the plane's row dim)."""
    for c in (2048, 4096):
        if c <= k2 and k2 % c == 0 and c % G == 0 and (c // (G * sb)) % 8 == 0:
            return c
    return k2 if k2 <= 4096 else None  # whole-half-plane tile, VMEM-bounded


def _nib(pw: PlanarWeight):
    """(lo, hi) code half-planes (K/2, Npad) as float32: k < K/2 and k >= K/2."""
    c = pw.codes
    return (c & 0xF).float(), (c >> 4).float()


def _group_planes(pw: PlanarWeight):
    """Effective group scale d*sc (2, K/64, Npad) and offset -dmin*m in
    natural group order (K/32, Npad), f32 — the _sb_expand arithmetic."""
    eff_s = pw.d.float().repeat_interleave(pw.sb, dim=1) * pw.scales.float()
    dmin_nat = pw.dmin.float().reshape(-1, pw.npad)
    eff_o = -dmin_nat.repeat_interleave(pw.sb, dim=0) * pw.offsets.float()
    return eff_s, eff_o


def quantize_rows(x: torch.Tensor, *, folded_scale: bool = False):
    """Symmetric int8 quantization with one scale per row of x (..., L):
    sx = amax/127 (1 where amax == 0), codes round(x / sx) half to even,
    clipped to +-127 (qmatmul.py:856).  Returns (codes as float32, sx (..., 1)
    float32).

    folded_scale: sx = amax * f32(1/127) in place of amax / 127.  That is
    what the JAX M=1 kernel computes for its per-tile scale (:541): XLA
    compiles the kernel body and folds the division by the constant 127 into
    a multiply by its f32 reciprocal, while the per-row quantizer (:856) runs
    op by op and divides (ROADMAP.md, "Faults found")."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = amax * (1.0 / 127.0) if folded_scale else amax / 127.0  # the scalar rounds to f32
    sx = torch.where(amax == 0, torch.ones_like(amax), sx)
    return torch.clamp(torch.round(xf / sx), -127, 127), sx


def _group_dots(xq: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, G: int):
    """Exact per-group integer dots and activation sums of both half-planes.
    xq (M, K) integer-valued float32 -> P_lo, P_hi (M, K/2/G, Npad) and
    xs_lo, xs_hi (M, K/2/G, 1); every partial sum is an integer below 2**24,
    so float32 holds it exactly."""
    m, k = xq.shape
    g2 = k // 2 // G
    xl = xq[:, : k // 2].reshape(m, g2, G)
    xh = xq[:, k // 2 :].reshape(m, g2, G)
    npad = lo.shape[-1]
    p_lo = torch.einsum("mgr,grn->mgn", xl, lo.reshape(g2, G, npad))
    p_hi = torch.einsum("mgr,grn->mgn", xh, hi.reshape(g2, G, npad))
    return p_lo, p_hi, xl.sum(-1, keepdim=True), xh.sum(-1, keepdim=True)


def _gemv_qact_plain(x: torch.Tensor, pw: PlanarWeight, kt2: int) -> torch.Tensor:
    """_q4gemv_bd_sb_qact_kernel semantics: x (1, K) bf16 -> (1, Npad) f32."""
    k2 = pw.k // 2
    nt = k2 // kt2
    # segments: lo tiles, then hi tiles
    xq, sx = quantize_rows(x.reshape(2 * nt, kt2), folded_scale=True)
    lo, hi = _nib(pw)
    p_lo, p_hi, xs_lo, xs_hi = _group_dots(xq.reshape(1, -1), lo, hi, pw.group)
    eff_s, eff_o = _group_planes(pw)
    g2 = k2 // pw.group
    contrib_lo = p_lo[0] * eff_s[0] + xs_lo[0] * eff_o[:g2]
    contrib_hi = p_hi[0] * eff_s[1] + xs_hi[0] * eff_o[g2:]
    gpt = kt2 // pw.group  # groups per tile
    sx_lo = sx[:nt].reshape(nt, 1, 1)
    sx_hi = sx[nt:].reshape(nt, 1, 1)
    per_tile = (contrib_lo.reshape(nt, gpt, -1) * sx_lo
                + contrib_hi.reshape(nt, gpt, -1) * sx_hi).sum(1)  # (nt, Npad)
    y = per_tile[0]
    for t in range(1, nt):  # the sequential K grid of the TPU kernel
        y = y + per_tile[t]
    return y.reshape(1, -1)


def _gemv_rows_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q4gemv_sb_kernel semantics with the per-row quantization around it:
    x (M, K) bf16 -> (M, Npad) f32."""
    xq, sx = quantize_rows(x)
    lo, hi = _nib(pw)
    p_lo, p_hi, xs_lo, xs_hi = _group_dots(xq, lo, hi, pw.group)
    eff_s, eff_o = _group_planes(pw)
    g2 = pw.k // 2 // pw.group
    y = (p_lo * eff_s[0] + xs_lo * eff_o[:g2] + p_hi * eff_s[1] + xs_hi * eff_o[g2:]).sum(1)
    return y * sx


def _matmul_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q4_kernel semantics plus the xsum @ eff_o side product:
    x (M, K) bf16 -> (M, Npad) f32."""
    eff_s, eff_o = _group_planes(pw)
    lo, hi = _nib(pw)
    w_lo = (lo * eff_s[0].repeat_interleave(pw.group, dim=0)).to(torch.bfloat16)
    w_hi = (hi * eff_s[1].repeat_interleave(pw.group, dim=0)).to(torch.bfloat16)
    w = torch.cat([w_lo, w_hi], dim=0).float()  # (K, Npad): bf16 values, exact in f32
    xf = x.float()
    y = xf @ w
    xsum = xf.reshape(x.shape[0], pw.k // pw.group, pw.group).sum(-1)
    return y + xsum @ eff_o


def _check_planes(x: torch.Tensor, pw: PlanarWeight, max_m: int | None = None):
    if x.dim() != 2 or x.shape[1] != pw.k:
        raise ValueError(f"x {tuple(x.shape)} does not match weight K={pw.k}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if max_m is not None and not 1 <= x.shape[0] <= max_m:
        raise ValueError(f"M={x.shape[0]} outside 1..{max_m}")
    if pw.k % 512:
        raise ValueError(f"K={pw.k} is not a multiple of 512")
    planes = (pw.codes, pw.scales, pw.offsets, pw.d, pw.dmin)
    if any(t.device != x.device for t in planes):
        raise ValueError("x and the weight planes are on different devices")
    if x.is_cuda:
        if not x.is_contiguous() or any(not t.is_contiguous() for t in planes):
            raise ValueError("the CUDA kernels take contiguous tensors only")
        if pw.npad % _BN:
            raise ValueError(f"Npad={pw.npad} is not a multiple of {_BN}")
        if pw.d.dtype not in (torch.float32, torch.bfloat16) or pw.dmin.dtype != pw.d.dtype:
            raise TypeError(f"d/dmin must both be float32 or bfloat16, got {pw.d.dtype}/{pw.dmin.dtype}")
        if (pw.codes.dtype, pw.scales.dtype, pw.offsets.dtype) != (torch.uint8, torch.int8, torch.int8):
            raise TypeError("codes must be uint8 and scales/offsets int8")
        if any(t.data_ptr() % 16 for t in (x, *planes)):
            raise ValueError("the CUDA kernels need 16-byte aligned tensors")


def _plane_ptrs(pw: PlanarWeight):
    return (pw.codes.data_ptr(), pw.scales.data_ptr(), pw.offsets.data_ptr(),
            pw.d.data_ptr(), pw.dmin.data_ptr(), int(pw.d.dtype == torch.bfloat16))


def _gemv_cuda(name: str, x: torch.Tensor, pw: PlanarWeight, kt2: int) -> torch.Tensor:
    m, k = x.shape
    dev = x.device
    y = torch.empty((m, pw.npad), dtype=torch.float32, device=dev)
    # scratch of this launch alone, from the stream-ordered allocator; the
    # quantization kernel zeroes the tickets before the GEMV counts on them
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((k // kt2 if kt2 else m,), dtype=torch.float32, device=dev)
    partial = torch.empty((k // 512, m, pw.npad), dtype=torch.float32, device=dev)
    tickets = torch.empty((pw.npad // _BN,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x.data_ptr(), *_plane_ptrs(pw), xq.data_ptr(), sx.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), y.data_ptr())
    if kt2:
        rc = _build.lib().q4k_gemv_qact(*args, k, pw.npad, kt2, stream)
    else:
        rc = _build.lib().q4k_gemv_rows(*args, m, k, pw.npad, stream)
    launches[name] += 1
    _build.check(rc, name)
    return y


def q4k_gemv_qact(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel A: x (1, K) bf16 -> y (1, Npad) f32 with in-kernel per-tile
    activation quantization (replaces _q4gemv_bd_sb_qact_kernel)."""
    _check_planes(x, pw, max_m=1)
    kt2 = _sb_gemv_k_tile(pw.k // 2, pw.group, pw.sb)
    if kt2 is None:
        raise NotImplementedError(f"K={pw.k}: no compact GEMV tile; the non-compact q4 GEMV is not ported yet")
    if not x.is_cuda:
        return _gemv_qact_plain(x, pw, kt2)
    return _gemv_cuda("q4k_gemv_qact", x, pw, kt2)


def q4k_gemv_rows(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel B: x (M, K) bf16, 1 <= M <= 32 -> y (M, Npad) f32 with one
    activation scale per row (replaces _q4gemv_sb_kernel and the per-row
    quantization around it)."""
    _check_planes(x, pw, max_m=GEMV_MAX_M)
    if not x.is_cuda:
        return _gemv_rows_plain(x, pw)
    return _gemv_cuda("q4k_gemv_rows", x, pw, 0)


def q4k_matmul(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel C: x (M, K) bf16 -> y (M, Npad) f32, dequantizing bf16 weight
    tiles from the compact planes (replaces _q4_kernel, _effective_planes and
    the xsum @ eff_o side product)."""
    _check_planes(x, pw)
    if not x.is_cuda:
        return _matmul_plain(x, pw)
    m, k = x.shape
    y = torch.empty((m, pw.npad), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matmul(x.data_ptr(), *_plane_ptrs(pw), y.data_ptr(), m, k, pw.npad, stream)
    launches["q4k_matmul"] += 1
    _build.check(rc, "q4k_matmul")
    return y


def planar_dequant(pw: PlanarWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, Npad) dequantized weight — the executable spec of the planar
    factoring (qmatmul.py:904)."""
    eff_s, eff_o = _group_planes(pw)
    lo, hi = _nib(pw)
    g = pw.group
    w = torch.cat([lo * eff_s[0].repeat_interleave(g, dim=0),
                   hi * eff_s[1].repeat_interleave(g, dim=0)], dim=0)
    w = w + eff_o.repeat_interleave(g, dim=0)
    return w.to(dtype)


def planar_matmul(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """y = x @ W^T with W a compact Q4_K planar weight.

    x: (..., K) float tensor, computed as bf16.  Returns (..., N) in x's dtype.
    """
    *batch, k = x.shape
    if k != pw.k:
        raise ValueError(f"K mismatch: x {k} vs weight {pw.k}")
    xb = x.reshape(-1, k).to(torch.bfloat16)
    m = xb.shape[0]
    has_tile = _sb_gemv_k_tile(k // 2, pw.group, pw.sb) is not None
    if m == 1 and has_tile:
        y = q4k_gemv_qact(xb, pw)
    elif m <= GEMV_MAX_M and has_tile:
        y = q4k_gemv_rows(xb, pw)
    elif m > GEMV_MAX_M:
        y = q4k_matmul(xb, pw)
    else:
        raise NotImplementedError(
            f"K={k}: no compact GEMV tile; the expanded-plane q4 GEMV is not ported yet (ROADMAP.md)")
    return y[:, : pw.n].reshape(*batch, pw.n).to(x.dtype)
