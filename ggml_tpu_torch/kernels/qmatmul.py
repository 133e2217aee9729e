"""Fused quantized matmuls over the planes of quant/planar.py (kernels A-C
and H over packed-nibble planes, E-G over int8 planes).

The port of ggml_tpu/kernels/qmatmul.py.  `planar_matmul` dispatches as
`_planar_matmul_impl` does (`select_kernel`):

q4 planes; "GEMV" means M <= 32 and (K/2/G) % 8 == 0
  GEMV, compact planes (Q4_K, K % 512 == 0) with a legal superblock tile
    M == 1        q4k_gemv_qact  int8 activations with one scale per K-tile
                               per half-plane, quantized in the kernel
                               (kernel A, csrc/q4k_gemv.cu)
    2 <= M <= 32  q4k_gemv_rows  int8 activations with one scale per row,
                               quantized in the kernel (kernel B, the same file)
  GEMV otherwise  q4_gemv      the same per-row quantization over
                               multiplied-out scale/offset planes, G 16 or 32
                               (kernel H, csrc/q4_gemv.cu); compact planes
                               without a legal tile are expanded first
  every other M and K  q4k_matmul  bf16 weights dequantized per tile into
                               shared memory, wgmma bf16 products, f32 sums,
                               the offset term as extra product columns, over
                               compact or multiplied-out planes (kernel C,
                               csrc/q4k_matmul.cu over csrc/qmatmul_sm90.cuh)
q8 planes; "GEMV" means M <= 32, G in (16, 32) and (K/G) % 8 == 0
  GEMV, compact planes with a legal superblock tile (_sb_q8_gemv_ok)
                q8_gemv_sb     int8 activations per row; d * sub-scale and
                               -dmin * min code rebuilt in the kernel
                               (kernel F, csrc/q8_gemv.cu)
  GEMV otherwise  q8_gemv      the same sum over multiplied-out scale/offset
                               planes (kernel E, csrc/q8_gemv.cu); compact
                               planes without a legal tile are expanded first
  every other M and K  q8_matmul  the same pipeline over int8 planes
                               (kernel G, csrc/q8_matmul.cu); at every M
                               over multiplied-out planes in groups of 8
                               (IQ1_M) and 256 (TQ1_0, TQ2_0), which the
                               GEMVs do not take
The GEMV kernels A, B, E, F, H and the int8-x entry are one pipeline
(csrc/gemv_sm90.cuh): one launch each, no scratch, x quantized in the kernel.

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors; it never falls back from one to the other.  The
plain versions compute the same function as the JAX kernels, with the same
activation quantization, the same bf16 rounding points and f32 sums, and are
what the CPU tests compare with JAX and what the card's kernels are held to.
`launches` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from ..quant.planar import PlanarWeight, effective_planes, expand_compact
from . import _build

GEMV_MAX_M = 32  # int-GEMV path for decode-sized row counts (qmatmul.py:866)

launches = {"q4k_gemv_qact": 0, "q4k_gemv_rows": 0, "q4k_gemv_i8": 0, "q4k_matmul": 0, "q4_gemv": 0,
            "q8_gemv": 0, "q8_gemv_sb": 0, "q8_matmul": 0}

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
    # the folded scalar rounds to f32; the division is by a tensor, because on
    # the card PyTorch turns a division by a number into a multiply by its
    # reciprocal (the folded form again)
    sx = amax * (1.0 / 127.0) if folded_scale else amax / torch.full_like(amax, 127.0)
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
    # segments: lo tiles, then hi tiles
    xq, sx = quantize_rows(x.reshape(pw.k // kt2, kt2), folded_scale=True)
    return _gemv_tiles_plain(xq, sx, pw, kt2)


def _gemv_i8_plain(xq: torch.Tensor, pw: PlanarWeight, kt2: int) -> torch.Tensor:
    """_q4gemv_bd_sb_kernel semantics: x (1, K) int8, already quantized ->
    the un-scaled sum (1, Npad) f32."""
    return _gemv_tiles_plain(xq.float(), torch.ones((pw.k // kt2, 1), device=xq.device), pw, kt2)


def _gemv_tiles_plain(xq: torch.Tensor, sx: torch.Tensor, pw: PlanarWeight, kt2: int) -> torch.Tensor:
    """The sum of the block-diagonal compact bodies: integer-valued f32
    activations xq (K elements) with one scale sx per K-tile per half-plane
    ((2 * K/2/kt2, 1): lo tiles, then hi tiles); each tile's groups add up
    first, then the tiles in K order."""
    k2 = pw.k // 2
    nt = k2 // kt2
    lo, hi = _nib(pw)
    p_lo, p_hi, xs_lo, xs_hi = _group_dots(xq.reshape(1, -1), lo, hi, pw.group)
    eff_s, eff_o = effective_planes(pw)
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


def _q4_gemv_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q4gemv_kernel / _q4gemv_off_kernel semantics (and, at M = 1, those of
    the two block-diagonal bodies) with the per-row quantization before and
    the * sx after: x (M, K) bf16 -> (M, Npad) f32 over multiplied-out planes.

    Sum order: group by group in the order of the packed rows, the low
    half-plane's group before the high one's, acc = fma(dot, s, acc) then
    acc = fma(sum xq, o, acc), with exact int32 dots: the order of the JAX
    loop bodies as XLA compiles them for the CPU (each multiply-add fused).
    The block-diagonal bodies reduce each K-tile as a tree, and the CUDA
    kernel adds warps, slabs and K-splits in its own fixed order; both are
    held to this version by NMSE."""
    xq, sx = quantize_rows(x)
    lo, hi = _nib(pw)
    p_lo, p_hi, xs_lo, xs_hi = _group_dots(xq, lo, hi, pw.group)
    eff_s, eff_o = effective_planes(pw)
    g2 = pw.k // 2 // pw.group
    acc = torch.zeros((x.shape[0], pw.npad), dtype=torch.float32, device=x.device)
    for g in range(g2):
        for h, p, xs in ((0, p_lo, xs_lo), (1, p_hi, xs_hi)):
            acc = _fma(p[:, g], eff_s[h, g], acc)
            if eff_o is not None:
                acc = _fma(xs[:, g], eff_o[h * g2 + g], acc)
    return acc * sx


def _gemv_rows_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q4gemv_sb_kernel semantics with the per-row quantization around it:
    x (M, K) bf16 -> (M, Npad) f32."""
    xq, sx = quantize_rows(x)
    lo, hi = _nib(pw)
    p_lo, p_hi, xs_lo, xs_hi = _group_dots(xq, lo, hi, pw.group)
    eff_s, eff_o = effective_planes(pw)
    g2 = pw.k // 2 // pw.group
    y = (p_lo * eff_s[0] + xs_lo * eff_o[:g2] + p_hi * eff_s[1] + xs_hi * eff_o[g2:]).sum(1)
    return y * sx


def _matmul_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q4_kernel semantics plus the xsum @ eff_o side product:
    x (M, K) bf16 -> (M, Npad) f32."""
    eff_s, eff_o = effective_planes(pw)
    lo, hi = _nib(pw)
    w_lo = (lo * eff_s[0].repeat_interleave(pw.group, dim=0)).to(torch.bfloat16)
    w_hi = (hi * eff_s[1].repeat_interleave(pw.group, dim=0)).to(torch.bfloat16)
    w = torch.cat([w_lo, w_hi], dim=0).float()  # (K, Npad): bf16 values, exact in f32
    xf = x.float()
    y = xf @ w
    if eff_o is not None:
        y = y + xf.reshape(x.shape[0], pw.k // pw.group, pw.group).sum(-1) @ eff_o
    return y


def _sb_q8_gemv_ok(k: int, G: int, sb: int) -> bool:
    """Whether the JAX compact q8 GEMV has a legal K tile at this K (a 2048
    or 4096 tile whose superblock rows are a multiple of 8, or a whole-K tile
    up to 4096); without one the dispatch expands the planes (qmatmul.py:793)."""
    for c in (2048, 4096):
        if c <= k and k % c == 0 and c % G == 0 and (c // (G * sb)) % 8 == 0:
            return True
    return k <= 4096


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add does (the
    product of two float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _q8_gemv_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q8gemv_kernel / _q8gemv_off_kernel semantics (and, over compact
    planes, those of the four _q8gemv*_sb* bodies) with the per-row
    quantization before and the * sx after: x (M, K) bf16 -> (M, Npad) f32.

    Sum order: the groups one by one in K order into a running f32 sum,
    acc = fma(dot(xq_g, q_g), s_g, acc), then acc = fma(sum xq_g, o_g, acc),
    with exact int32 dots: the order of the JAX loop bodies as XLA compiles
    them for the CPU (it fuses each multiply-add), which this reproduces bit
    for bit on multiplied-out planes.  The block-diagonal bodies (compact
    planes at M = 1) reduce each K-tile as a tree, and the CUDA kernel adds
    warps, slabs and K-splits in its own fixed order; both are held to this
    version by NMSE."""
    xq, sx = quantize_rows(x)
    eff_s, eff_o = effective_planes(pw)
    m, g = x.shape[0], pw.group
    xg = xq.reshape(m, pw.k // g, g)
    # every partial sum is an integer below 2**24: float32 holds it exactly
    dots = torch.einsum("mgr,grn->mgn", xg, pw.codes.float().reshape(pw.k // g, g, pw.npad))
    xsum = xg.sum(-1, keepdim=True)
    acc = torch.zeros((m, pw.npad), dtype=torch.float32, device=x.device)
    for i in range(pw.k // g):
        acc = _fma(dots[:, i], eff_s[i], acc)
        if eff_o is not None:
            acc = _fma(xsum[:, i], eff_o[i], acc)
    return acc * sx


def _q8_matmul_plain(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """_q8_kernel semantics, w = bf16(f32(code) * f32(scale)) with the
    effective scale of compact planes formed in f32 first, plus the f32 side
    product xsum @ eff_o over the bf16 activations: x (M, K) bf16 -> (M, Npad) f32."""
    eff_s, eff_o = effective_planes(pw)
    w = (pw.codes.float() * eff_s.repeat_interleave(pw.group, dim=0)).to(torch.bfloat16).float()
    xf = x.float()
    y = xf @ w
    if eff_o is not None:
        y = y + xf.reshape(x.shape[0], pw.k // pw.group, pw.group).sum(-1) @ eff_o
    return y


_FLOAT_PLANES = (torch.float32, torch.bfloat16)


def _check_planes(x: torch.Tensor, pw: PlanarWeight, kind: str, max_m: int | None = None,
                  x_dtype=torch.bfloat16, groups=(16, 32)):
    """Raise on what the kernels of `kind` planes do not take (groups: the
    group sizes of the caller's kernel)."""
    if pw.kind != kind:
        raise ValueError(f"a {kind} kernel was given {pw.kind} planes")
    if x.dim() != 2 or x.shape[1] != pw.k:
        raise ValueError(f"x {tuple(x.shape)} does not match weight K={pw.k}")
    if x.dtype != x_dtype:
        raise TypeError(f"x must be {x_dtype}, got {x.dtype}")
    if max_m is not None and not 1 <= x.shape[0] <= max_m:
        raise ValueError(f"M={x.shape[0]} outside 1..{max_m}")
    if kind == "q4" and pw.d is not None and pw.k % 512:
        raise ValueError(f"K={pw.k} is not a multiple of 512")
    k_step = 64 if kind == "q4" else 32  # a 32-row step of the code planes (32 rows of each half-plane for q4)
    if pw.group not in groups or pw.k % k_step or pw.k % pw.group:
        raise ValueError(f"group {pw.group} / K={pw.k}: this {kind} kernel takes groups of "
                         f"{', '.join(map(str, groups))} and K a multiple of {k_step} and of the group")
    planes = list(pw.buffers())
    if any(t.device != x.device for t in planes):
        raise ValueError("x and the weight planes are on different devices")
    if not x.is_cuda:
        return
    if not x.is_contiguous() or any(not t.is_contiguous() for t in planes):
        raise ValueError("the CUDA kernels take contiguous tensors only")
    if pw.npad % _BN:
        raise ValueError(f"Npad={pw.npad} is not a multiple of {_BN}")
    if any(t.data_ptr() % 16 for t in (x, *planes)):
        raise ValueError("the CUDA kernels need 16-byte aligned tensors")
    # integer planes, then the float planes, which share one of two types
    compact = pw.d is not None
    ints = [pw.codes] + ([pw.scales, pw.offsets] if compact else [])
    floats = [pw.d, pw.dmin] if compact else [pw.scales, pw.offsets]
    want = [torch.uint8 if kind == "q4" else torch.int8] + [torch.int8] * 2
    if any(t is not None and t.dtype != w for t, w in zip(ints, want)):
        raise TypeError(f"{kind} codes must be {want[0]} and compact sub-scale/min codes int8")
    if floats[0].dtype not in _FLOAT_PLANES or any(t is not None and t.dtype != floats[0].dtype for t in floats):
        raise TypeError("the float planes (scales/offsets or d/dmin) must all be float32 or all bfloat16")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _plane_ptrs(pw: PlanarWeight):
    """codes, scales, offsets, d, dmin (None where absent) and whether the
    float planes are bf16."""
    floats = pw.scales if pw.d is None else pw.d
    return (pw.codes.data_ptr(), pw.scales.data_ptr(), _ptr(pw.offsets), _ptr(pw.d), _ptr(pw.dmin),
            int(floats.dtype == torch.bfloat16))


def _gemv_cuda(name: str, x: torch.Tensor, pw: PlanarWeight, kt2: int = 0) -> torch.Tensor:
    """One launch of a GEMV kernel (csrc/gemv_sm90.cuh): it quantizes x
    itself (the int8-x entry takes int8 x as it is) and splits K over a
    thread-block cluster summed in shared memory, so y is all it needs."""
    m, k = x.shape
    lib = _build.lib()
    y = torch.empty((m, pw.npad), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "q4_gemv":
        rc = lib.q4_gemv(x.data_ptr(), pw.codes.data_ptr(), pw.scales.data_ptr(), _ptr(pw.offsets),
                         int(pw.scales.dtype == torch.bfloat16), y.data_ptr(), pw.group, m, k, pw.npad, stream)
    elif pw.kind == "q8":
        rc = lib.q8_gemv(x.data_ptr(), *_plane_ptrs(pw), y.data_ptr(), pw.group, pw.sb, m, k, pw.npad, stream)
    elif name == "q4k_gemv_qact":
        rc = lib.q4k_gemv_qact(x.data_ptr(), *_plane_ptrs(pw), y.data_ptr(), k, pw.npad, kt2, stream)
    elif name == "q4k_gemv_rows":
        rc = lib.q4k_gemv_rows(x.data_ptr(), *_plane_ptrs(pw), y.data_ptr(), m, k, pw.npad, stream)
    else:
        rc = lib.q4k_gemv_i8(x.data_ptr(), *_plane_ptrs(pw), y.data_ptr(), k, pw.npad, stream)
    launches[name] += 1
    _build.check(rc, name)
    return y


_MM_TILE = 128  # rows and columns of y a block of the matmul kernels owns (csrc/qmatmul_sm90.cuh)
_MM_STAGE = 64  # nibble-plane rows (int8: twice as many) and offset groups a stage of theirs takes
_SMS = 132  # streaming multiprocessors of the H100


def matmul_plan(kind: str, m: int, k: int, npad: int, group: int, has_offsets: bool) -> dict:
    """How kernels C and G (csrc/qmatmul_sm90.cuh) walk a product, as their C
    entries recompute it: `stages` of 128 values of K (64 rows of the K/2
    rows of nibble planes, 128 of int8 planes), then `offset_stages` of 64 groups that add
    the groups' offset term (Gp = K/G rounded up to 64; the group sums of x
    go to an (m, 2 Gp) bf16 scratch, `xs_cols`), over `tiles` tiles of
    128 x 128.  Where the tiles do not fill the card's SMs, `split`
    blocks share a tile's stages (each at least 4), write f32 partials to a
    (split, m, npad) scratch, and the last to arrive adds them in order."""
    rows, per_stage = (k // 2, _MM_STAGE) if kind == "q4" else (k, 2 * _MM_STAGE)
    stages = -(-rows // per_stage)
    gp = -(-(k // group) // _MM_STAGE) * _MM_STAGE
    offset_stages = gp // _MM_STAGE if has_offsets else 0
    tiles = -(-m // _MM_TILE) * (npad // _MM_TILE)
    split = 1
    if tiles < _SMS:
        split = max(1, min(_SMS // tiles, (stages + offset_stages) // 4))
    return dict(stages=stages, offset_stages=offset_stages, xs_cols=2 * gp if has_offsets else 0, tiles=tiles,
                split=split)


# device -> int32 arrival counters of the split matmuls, zero between launches.
# A captured decode graph keeps the buffer's address (IQ1_M and TQ decode
# split attn_output and ffn_down at M = 1), so the buffer is sound on one
# stream only, as kernel D's is: launches on two streams at once would share
# counters.
_counters: dict = {}
_retired: list = []  # buffers a larger one replaced: a captured decode graph may still use them


def _zeroed_counters(n: int, device) -> torch.Tensor:
    """At least n int32 arrival counters on `device`, zero: each launch
    leaves the ones it used at zero, so one buffer serves every launch (and
    every replay of a CUDA graph that captured one, on one stream)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _matmul_cuda(name: str, x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    m, k = x.shape
    dev = x.device
    plan = matmul_plan(pw.kind, m, k, pw.npad, pw.group, pw.offsets is not None)
    y = torch.empty((m, pw.npad), dtype=torch.float32, device=dev)
    # scratch of this launch alone, from the stream-ordered allocator
    xs = torch.empty((m, plan["xs_cols"]), dtype=torch.bfloat16, device=dev) if plan["xs_cols"] else None
    split = plan["split"]
    partial = torch.empty((split, m, pw.npad), dtype=torch.float32, device=dev) if split > 1 else None
    counters = _zeroed_counters(plan["tiles"], dev) if split > 1 else None
    scratch = (_ptr(xs), _ptr(partial), _ptr(counters), split, torch.cuda.current_stream(dev).cuda_stream)
    if pw.kind == "q8":
        rc = _build.lib().q8_matmul(x.data_ptr(), *_plane_ptrs(pw), pw.group, pw.sb, y.data_ptr(),
                                    m, k, pw.npad, *scratch)
    else:
        rc = _build.lib().q4k_matmul(x.data_ptr(), *_plane_ptrs(pw), pw.group, y.data_ptr(), m, k, pw.npad,
                                     *scratch)
    launches[name] += 1
    _build.check(rc, name)
    return y


def _compact_tile(pw: PlanarWeight) -> int:
    """The superblock K-tile of the compact-plane GEMVs; raises where the
    planes are not compact or no legal tile exists (planar_matmul expands
    such planes and takes q4_gemv)."""
    if pw.d is None:
        raise ValueError("the q4k GEMVs take compact planes; multiplied-out planes go to q4_gemv")
    kt2 = _sb_gemv_k_tile(pw.k // 2, pw.group, pw.sb)
    if kt2 is None:
        raise ValueError(f"K={pw.k}: no compact GEMV tile; expand the planes and take q4_gemv")
    return kt2


def q4k_gemv_qact(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel A: x (1, K) bf16 -> y (1, Npad) f32 with in-kernel per-tile
    activation quantization (replaces _q4gemv_bd_sb_qact_kernel)."""
    _check_planes(x, pw, "q4", max_m=1)
    kt2 = _compact_tile(pw)
    if not x.is_cuda:
        return _gemv_qact_plain(x, pw, kt2)
    return _gemv_cuda("q4k_gemv_qact", x, pw, kt2)


def q4k_gemv_rows(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel B: x (M, K) bf16, 1 <= M <= 32 -> y (M, Npad) f32 with one
    activation scale per row (replaces _q4gemv_sb_kernel and the per-row
    quantization around it)."""
    _check_planes(x, pw, "q4", max_m=GEMV_MAX_M)
    _compact_tile(pw)
    if not x.is_cuda:
        return _gemv_rows_plain(x, pw)
    return _gemv_cuda("q4k_gemv_rows", x, pw)


def q4k_gemv_i8(xq: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """x (1, K) int8, already quantized -> the un-scaled sum (1, Npad) f32
    over compact planes (replaces _q4gemv_bd_sb_kernel, what _q4_gemv_sb runs
    for int8 x at M = 1).  The caller multiplies by its activation scale.
    planar_matmul never takes this entry, in either package: at M = 1 it
    hands bf16 x to kernel A."""
    _check_planes(xq, pw, "q4", max_m=1, x_dtype=torch.int8)
    kt2 = _compact_tile(pw)
    if not xq.is_cuda:
        return _gemv_i8_plain(xq, pw, kt2)
    return _gemv_cuda("q4k_gemv_i8", xq, pw)


def q4k_matmul(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel C: x (M, K) bf16 -> y (M, Npad) f32, dequantizing bf16 weight
    tiles from compact planes (scale d * sub-scale, offset -dmin * min code)
    or from multiplied-out f32/bf16 scale and offset planes with groups of 16
    or 32 (replaces _q4_kernel, _effective_planes and the xsum @ eff_o side
    product).  One launch takes any M: its grid has a block row per 128 rows
    of x (matmul_plan), so the JAX package's chunks of 512 rows (its bound on
    VMEM) have no counterpart here."""
    _check_planes(x, pw, "q4")
    if not x.is_cuda:
        return _matmul_plain(x, pw)
    return _matmul_cuda("q4k_matmul", x, pw)


def q4_gemv(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel H: x (M, K) bf16, 1 <= M <= 32 -> y (M, Npad) f32 over packed
    nibbles with one f32 or bf16 scale (and offset) per group of G = 16 or 32
    (replaces _q4gemv_kernel, _q4gemv_off_kernel, _q4gemv_bd_kernel and
    _q4gemv_bd_off_kernel, the per-row quantization before them and the * sx
    after, all in one launch on the card)."""
    _check_planes(x, pw, "q4", max_m=GEMV_MAX_M)
    if pw.d is not None:
        raise ValueError("q4_gemv takes multiplied-out planes (expand_compact first)")
    if (pw.k // 2 // pw.group) % 8:
        raise ValueError(f"K={pw.k}: the q4 GEMV needs a multiple of 8 groups of {pw.group} per half-plane")
    if not x.is_cuda:
        return _q4_gemv_plain(x, pw)
    return _gemv_cuda("q4_gemv", x, pw)


def _check_q8_gemv(x: torch.Tensor, pw: PlanarWeight, compact: bool):
    _check_planes(x, pw, "q8", max_m=GEMV_MAX_M)
    if (pw.k // pw.group) % 8:
        raise ValueError(f"K={pw.k}: the q8 GEMV needs a multiple of 8 groups of {pw.group}")
    if (pw.d is not None) != compact:
        raise ValueError("q8_gemv takes multiplied-out planes and q8_gemv_sb compact planes")


def q8_gemv(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel E: x (M, K) bf16, 1 <= M <= 32 -> y (M, Npad) f32 over int8
    codes with one f32 or bf16 scale (and offset) per group (replaces
    _q8gemv_kernel, _q8gemv_off_kernel, the per-row quantization before them
    and the * sx after)."""
    _check_q8_gemv(x, pw, compact=False)
    if not x.is_cuda:
        return _q8_gemv_plain(x, pw)
    return _gemv_cuda("q8_gemv", x, pw)


def q8_gemv_sb(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel F: the sum of kernel E over COMPACT planes, the group scale
    d * sub-scale and offset -dmin * min code rebuilt in f32 in the kernel
    (replaces _q8gemv_sb_kernel, _q8gemv_bd_sb_kernel and their two affine
    twins, with the quantization and the * sx around them)."""
    _check_q8_gemv(x, pw, compact=True)
    if pw.k % (pw.group * pw.sb):
        raise ValueError(f"K={pw.k} is not whole superblocks of {pw.group * pw.sb}")
    if not x.is_cuda:
        return _q8_gemv_plain(x, pw)
    return _gemv_cuda("q8_gemv_sb", x, pw)


_Q8_MATMUL_GROUPS = (8, 16, 32, 256)  # multiplied-out planes; compact planes: 16 and 32


def q8_matmul(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """Kernel G: x (M, K) bf16 -> y (M, Npad) f32, dequantizing bf16 weight
    tiles from int8 planes, compact (groups of 16 or 32) or multiplied out
    (groups of 8, 16, 32 or 256; K a multiple of 256 at 256) (replaces
    _q8_kernel, _effective_planes and the xsum @ eff_o side product)."""
    _check_planes(x, pw, "q8", groups=_Q8_MATMUL_GROUPS if pw.d is None else (16, 32))
    if not x.is_cuda:
        return _q8_matmul_plain(x, pw)
    return _matmul_cuda("q8_matmul", x, pw)


def planar_dequant(pw: PlanarWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, Npad) dequantized weight — the executable spec of the planar
    factoring (qmatmul.py:904)."""
    eff_s, eff_o = effective_planes(pw)
    g = pw.group
    if pw.kind == "q4":
        lo, hi = _nib(pw)
        w = torch.cat([lo * eff_s[0].repeat_interleave(g, dim=0),
                       hi * eff_s[1].repeat_interleave(g, dim=0)], dim=0)
    else:
        w = pw.codes.float() * eff_s.repeat_interleave(g, dim=0)
    if eff_o is not None:
        w = w + eff_o.repeat_interleave(g, dim=0)
    return w.to(dtype)


_WRAPPERS = {f.__name__: f for f in (q4k_gemv_qact, q4k_gemv_rows, q4k_matmul, q4_gemv,
                                     q8_gemv, q8_gemv_sb, q8_matmul)}


def select_kernel(pw: PlanarWeight, m: int) -> str:
    """Name of the wrapper planar_matmul runs for m rows of x, decided as
    _planar_matmul_impl decides (qmatmul.py:998-1085)."""
    k, g = pw.k, pw.group
    if pw.kind == "q4":
        if m > GEMV_MAX_M or g not in (16, 32) or (k // 2) % g or (k // 2 // g) % 8:
            return "q4k_matmul"
        if pw.d is not None and _sb_gemv_k_tile(k // 2, g, pw.sb) is not None:
            return "q4k_gemv_qact" if m == 1 else "q4k_gemv_rows"
        return "q4_gemv"  # compact planes with no legal tile are expanded first
    if m > GEMV_MAX_M or g not in (16, 32) or (k // g) % 8:
        return "q8_matmul"
    if pw.d is not None and _sb_q8_gemv_ok(k, g, pw.sb):
        return "q8_gemv_sb"
    return "q8_gemv"  # compact planes with no legal tile are expanded first


# kernel-selection observability (qmatmul.py:875-900, the GGML_SCHED_DEBUG
# assignment-dump idiom): planar_matmul records on the host which wrappers
# each (kind, K, N, M class) site ran, in the order of first use (the gemv-M
# class holds two wrappers for the compact Q4_K planes: M = 1 and 2..32).
# The IQ* and TQ* types are q8 sites: IQ1_M, TQ1_0 and TQ2_0 report
# q8_matmul in both classes.  A captured decode graph records at its
# capture; a replay runs no Python and records nothing.
_selection_log: dict[tuple, list[str]] = {}


def kernel_selection_report() -> list[str]:
    """One line per distinct matmul site run so far: which kernels ran.
    Printed by `python -m ggml_tpu_torch.cli.generate --verbose`; reset with
    _selection_log.clear()."""
    return [
        f"{kind:>3} K={k:<6} N={n:<6} {mclass:>7} -> {', '.join(paths)}"
        for (kind, k, n, mclass), paths in sorted(_selection_log.items())
    ]


def _record_selection(kind: str, k: int, n: int, m: int, path: str):
    paths = _selection_log.setdefault((kind, k, n, "gemv-M" if m <= GEMV_MAX_M else "matmul-M"), [])
    if path not in paths:
        paths.append(path)


def planar_matmul(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    """y = x @ W^T with W a planar-repacked quantized weight.

    x: (..., K) float tensor, computed as bf16.  Returns (..., N) in x's dtype.
    Every kernel takes all the rows in one launch (the matmul kernels tile M
    in their grid), so rows above 512 are not cut into chunks as the JAX
    package cuts them; each row's result is the same either way.

    Differentiable with respect to x (_PlanarMatmul, the JAX custom VJP
    _planar_matmul_d): dx = dy @ dequant(W), the weight dequantized in the
    backward only; the planes are frozen and get no gradient (QLoRA).
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _PlanarMatmul.apply(x, pw)
    return _planar_matmul_fwd(x, pw)


class _PlanarMatmul(torch.autograd.Function):
    """planar_matmul under autograd (qmatmul.py:955-984).  The forward is
    planar_matmul's kernels and saves only the weight (the output has x's
    type, so the gradient has it too).  The backward dequantizes the planes
    to bf16, as the JAX backward does, and multiplies the bf16-rounded
    gradient with them in f32 (bf16 x bf16 products are exact in f32; the
    caller keeps TF32 off): the JAX einsum's bf16 operands with f32
    accumulation (preferred_element_type=f32), returned in the gradient's
    type."""

    @staticmethod
    def forward(ctx, x, pw):
        ctx.pw = pw
        return _planar_matmul_fwd(x, pw)

    @staticmethod
    def backward(ctx, g):
        pw = ctx.pw
        with torch.profiler.record_function("planar_matmul.bwd_dequant"):
            wd = planar_dequant(pw, torch.bfloat16)[:, : pw.n]
        with torch.profiler.record_function("planar_matmul.bwd_product"):
            dx = torch.matmul(g.to(torch.bfloat16).float(), wd.float().t())
        return dx.to(g.dtype), None


def _planar_matmul_fwd(x: torch.Tensor, pw: PlanarWeight) -> torch.Tensor:
    *batch, k = x.shape
    if k != pw.k:
        raise ValueError(f"K mismatch: x {k} vs weight {pw.k}")
    xb = x.reshape(-1, k).to(torch.bfloat16)
    name = select_kernel(pw, xb.shape[0])
    _record_selection(pw.kind, k, pw.n, xb.shape[0], name)
    if name in ("q8_gemv", "q4_gemv") and pw.d is not None:
        with torch.profiler.record_function("planar_matmul.expand_compact"):  # every call, as the JAX dispatch
            pw = expand_compact(pw)
    y = _WRAPPERS[name](xb, pw)
    return y[:, : pw.n].reshape(*batch, pw.n).to(x.dtype)
