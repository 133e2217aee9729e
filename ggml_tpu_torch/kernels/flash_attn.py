"""Flash attention: the prefill forward (kernel J) and the training forward
and backward (kernels K, L, M).

J is the port of ggml_tpu/kernels/flash_attn.py `flash_attention`: additive f32
mask (the ggml KQ mask) times a per-head ALiBi slope, optional logit softcap
applied before the mask, GQA by h // h_kv, f32 scores and sums, `p` rounded to
v's type before p @ v.  Ragged q and kv lengths need no padding here: the
kernel checks bounds.  The JAX wrapper pads kv to a multiple of 32 with zero
rows masked -1e30 (times the slope); J folds those columns into every row
as K does (below), and rows whose folded max is at or below -5e29 give zeros,
as JAX's test on its padded row.
q, k and v are all bf16, all f32, or f32 q and k with bf16 v: what a bf16
model's prefill hands over, since RoPE leaves q and k in f32.  On the card
the bf16 and f32-q/k sets run on Hopper's wgmma (csrc/flash_attn_sm90.cu)
after two helper kernels: `split_hi_lo` writes f32 k as hi and lo bf16
planes (the kernel splits q itself as it reads it), and `mask_ranges` gives
each 64 x 64 tile of the mask its min and max, from which the kernel skips,
adds a constant or reads the mask (a model computes the ranges once per
forward and hands them to every layer's call).  q, k and v may be head views
with contiguous rows (no copy is made of them).

K, L and M are the port of `flash_attention_train` (`_fa_forward_lse`,
`_fa_train_bwd`): the same function without softcap, differentiable, with a
backward from the saved output and its logsumexp (FlashAttention-2).  K gives
the output and the LSE, one f32 per row; L gives dq, M dk and dv.  p and ds stay
f32 in the backward; only the forward rounds p to v's type before p @ v.  As
the JAX wrapper pads kv to a multiple of 32 with zero rows masked -1e30 (times
the slope), K folds those columns into every row: live rows do not change, a
row masked -1e30 everywhere averages v over the padded length, and its LSE is
about -1e30.  Its dead rows are those left with l = 0 (every score -inf and no
padding): zeros, LSE +1e30 and no gradient.  q, k and v are all bf16 or all
f32.  For bf16, K (J's kernel with its LSE rules), L and M run on Hopper's
wgmma and skip, add or read mask tiles from the mask ranges, which the
model hands over (once per forward for all its layers) or the autograd
Function computes once per call, for all three.

For CPU tensors each wrapper runs its plain PyTorch version; for CUDA tensors
it launches its kernel (csrc/flash_attn_sm90.cu: J, its helpers and K for
bf16; csrc/flash_attn.cu: the all-f32 sets of J and K; csrc/flash_bwd_sm90.cu:
L and M for bf16; csrc/flash_attn_bwd.cu: the f32 sets of L and M), never the
plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build

launches = {"flash_attn": 0, "flash_split": 0, "flash_mask_ranges": 0,
            "flash_attn_fwd_lse": 0, "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}

_NEG_INF = -1e30  # finite "minus infinity": the running max starts here, so exp() stays NaN-free
_BKV = 64  # kv rows per step of J's kernel for bf16 q/k/v (K's too), and of their plain versions
_TILE = 64  # q rows and kv columns of a mask-range tile (J's tiles)
_KV_ALIGN = 32  # the JAX wrappers pad kv to a multiple of this


# the type sets the kernel takes (q, k, v), by the code csrc/flash_attn.cu knows them by
_TYPES = {(torch.float32, torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16, torch.bfloat16): 1,
          (torch.float32, torch.float32, torch.bfloat16): 2}
_TRAIN_TYPES = {(torch.float32,) * 3: 0, (torch.bfloat16,) * 3: 1}  # K, L and M


def alibi_slopes(n_head: int, max_bias: float) -> np.ndarray:
    """Per-head ALiBi slopes (n_head,) f32 (ggml_tpu/ops/core.py alibi_slopes)."""
    n_head_log2 = 1 << int(math.floor(math.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n_head_log2)
    m1 = 2.0 ** (-(max_bias / 2.0) / n_head_log2)
    h = np.arange(n_head)
    slopes = np.where(h < n_head_log2, m0 ** (h + 1), m1 ** (2 * (h - n_head_log2) + 1))
    if max_bias <= 0.0:
        slopes = np.ones(n_head)
    return slopes.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _slopes_on(n_head: int, max_bias: float, device: torch.device) -> torch.Tensor:
    """The ALiBi slopes on `device`, built once per (heads, max_bias, device):
    a copy from host memory on every call would block the host."""
    return torch.from_numpy(alibi_slopes(n_head, max_bias)).to(device)


def _online_softmax_plain(q, k, v, mask, slopes, score_scale: float, softcap: float, bkv: int = _BKV):
    """The forward kernels' recurrence in PyTorch over kv tiles of bkv rows,
    the kernel's (_j_tile for J, 64 for K).  The tile fixes the running max
    each p is rounded against before p @ v; the JAX wrappers pick other tiles,
    so for a bf16 v the two differ by single bf16 roundings of p (for an f32 v
    only in the last bits).  mask: (nq, nkv) f32 or None; slopes: (h,) f32;
    score_scale: scale, or scale / softcap where softcap != 0.  Returns the
    running sum of p @ v, the max and the sum of p after the last tile,
    (b, h, nq, d_v) and (b, h, nq, 1)."""
    b, h, n_q, _ = q.shape
    _, h_kv, n_kv, d_v = v.shape
    rep = h // h_kv
    qf = q.float()
    m = torch.full((b, h, n_q, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, n_q, d_v), dtype=torch.float32, device=q.device)
    for kv0 in range(0, n_kv, bkv):
        kf = k[:, :, kv0 : kv0 + bkv].float().repeat_interleave(rep, dim=1)
        vt = v[:, :, kv0 : kv0 + bkv].repeat_interleave(rep, dim=1)
        s = torch.matmul(qf, kf.transpose(-1, -2))
        s = torch.tanh(s * score_scale) * softcap if softcap != 0.0 else s * score_scale
        if mask is not None:
            s = s + slopes.view(1, h, 1, 1) * mask[:, kv0 : kv0 + bkv]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return acc, m, l


def _j_tile(q, v) -> int:
    """J's kv tile: 32 rows for f32 q and k with a bf16 v (the hi and lo
    planes take twice the shared memory of bf16 ones), else 64."""
    return 32 if q.dtype == torch.float32 and v.dtype == torch.bfloat16 else _BKV


def _fold_padding(acc, m, l, n_kv: int, slopes):
    """The n_pad zero kv columns the JAX wrappers append (flash_attention,
    _fa_setup: kv padded to a multiple of 32, masked slope * -1e30; their
    score is 0, also under softcap) folded into finished rows:
    m' = max(m, slope * -1e30), l' = l e^(m - m') + n_pad e^(slope * -1e30 - m'),
    acc' = acc e^(m - m').  Live rows do not change; a row masked -1e30
    everywhere averages v over the padded length."""
    n_pad = -(-n_kv // _KV_ALIGN) * _KV_ALIGN - n_kv
    if n_pad:
        pad = slopes.view(1, -1, 1, 1) * _NEG_INF  # the padded columns' score
        m_new = torch.maximum(m, pad)
        alpha = torch.exp(m - m_new)  # 1 for a live row, which the padding leaves alone
        l = l * alpha + n_pad * torch.exp(pad - m_new)
        acc = acc * alpha
        m = m_new
    return acc, m, l


def _flash_attention_plain(q, k, v, mask, slopes, score_scale: float, softcap: float) -> torch.Tensor:
    """Kernel J's function: the kv padding folded in, then rows whose max is
    at or below -5e29 give zeros.  Returns (b, nq, h, d_v) in q's type."""
    acc, m, l = _online_softmax_plain(q, k, v, mask, slopes, score_scale, softcap, _j_tile(q, v))
    acc, m, l = _fold_padding(acc, m, l, k.shape[2], slopes)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(m <= _NEG_INF * 0.5, torch.zeros_like(acc), acc / l)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def _fa_forward_lse_plain(q, k, v, mask, slopes, scale: float):
    """Kernel K's function: the n_pad zero kv columns that _fa_setup appends
    (masked slope * -1e30) folded in, then rows with l = 0 give zeros and
    LSE +1e30.  Returns o (b, nq, h, d_v) in q's type and lse (b, h, nq) f32."""
    acc, m, l = _online_softmax_plain(q, k, v, mask, slopes, scale, 0.0)
    acc, m, l = _fold_padding(acc, m, l, k.shape[2], slopes)
    dead = l == 0.0
    l1 = torch.where(dead, torch.ones_like(l), l)
    out = torch.where(dead, torch.zeros_like(acc), acc / l1)
    lse = torch.where(dead, torch.full_like(m, -_NEG_INF), m + torch.log(l1))
    return out.to(q.dtype).transpose(1, 2).contiguous(), lse[..., 0]


def _p_ds_plain(q, k, v, mask, slopes, scale: float, do, lse, delta):
    """p and ds (b, h, nq, nkv) f32 of the backward kernels, and the f32 q, k
    (per q head) and dO (b, h, nq, d_v) they are multiplied with."""
    rep = q.shape[1] // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    dof = do.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + slopes.view(1, -1, 1, 1) * mask
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) * scale
    return p, ds, qf, kf, dof


def _fa_bwd_dq_plain(q, k, v, mask, slopes, scale: float, do, lse, delta) -> torch.Tensor:
    """Kernel L's function: dq (b, h, nq, d) in q's type."""
    _, ds, _, kf, _ = _p_ds_plain(q, k, v, mask, slopes, scale, do, lse, delta)
    return torch.matmul(ds, kf).to(q.dtype)


def _fa_bwd_dkv_plain(q, k, v, mask, slopes, scale: float, do, lse, delta):
    """Kernel M's function: dk (b, h, nkv, d) and dv (b, h, nkv, d_v) per q
    head, in k's and v's types."""
    p, ds, qf, _, dof = _p_ds_plain(q, k, v, mask, slopes, scale, do, lse, delta)
    return torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype), torch.matmul(p.transpose(-1, -2), dof).to(v.dtype)


def _split_hi_lo_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 x as two bf16 planes (2, *x.shape): hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return torch.stack((hi, (x - hi.float()).to(torch.bfloat16)))


def _mask_ranges_plain(mask: torch.Tensor) -> torch.Tensor:
    """(2, ceil(nq / 64), ceil(nkv / 64)) f32: the min and max of the mask
    entries of each 64 x 64 tile (the ragged edge tiles over their entries)."""
    nq, nkv = mask.shape
    nqt, nkt = -(-nq // _TILE), -(-nkv // _TILE)

    def tiles(fill):
        t = torch.full((nqt * _TILE, nkt * _TILE), fill, dtype=torch.float32, device=mask.device)
        t[:nq, :nkv] = mask
        return t.view(nqt, _TILE, nkt, _TILE)

    return torch.stack((tiles(float("inf")).amin(dim=(1, 3)), tiles(float("-inf")).amax(dim=(1, 3))))


def _row_strides(t: torch.Tensor, align: int):
    """t (b, h, n, d) as the kernels read it: rows contiguous, every row start
    `align` elements apart (16 bytes); a copy only where t is not so already.
    Returns the tensor and its (batch, head, row) strides."""
    if t.stride(-1) != 1 or any(st % align for st in t.stride()[:3]) or t.data_ptr() % 16:
        t = t.contiguous()
    return t, t.stride()[:3]


def split_hi_lo(x: torch.Tensor) -> torch.Tensor:
    """Helper of kernel J: f32 (b, h, n, d) x as hi and lo bf16 planes
    (2, b, h, n, d), contiguous."""
    if not x.is_cuda:
        return _split_hi_lo_plain(x)
    if x.dim() != 4 or x.dtype != torch.float32 or x.shape[-1] % 8:
        raise ValueError(f"split_hi_lo takes an f32 (b, h, n, d) tensor, d a multiple of 8: {tuple(x.shape)} {x.dtype}")
    x, st = _row_strides(x, 4)
    planes = torch.empty((2, *x.shape), dtype=torch.bfloat16, device=x.device)
    rc = _build.lib().flash_split(x.data_ptr(), planes.data_ptr(), *x.shape[:3], *st, x.shape[-1],
                                  torch.cuda.current_stream(x.device).cuda_stream)
    launches["flash_split"] += 1
    _build.check(rc, "flash_split")
    return planes


def mask_ranges(mask: torch.Tensor) -> torch.Tensor:
    """Helper of kernels J, K, L and M: the (nq, nkv) f32 mask's min and max per
    64 x 64 tile, (2, ceil(nq / 64), ceil(nkv / 64)) f32."""
    if not mask.is_cuda:
        return _mask_ranges_plain(mask)
    if mask.dim() != 2 or mask.dtype != torch.float32:
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}: want (nq, nkv) float32")
    mask = mask.contiguous()
    nq, nkv = mask.shape
    ranges = torch.empty((2, -(-nq // _TILE), -(-nkv // _TILE)), dtype=torch.float32, device=mask.device)
    rc = _build.lib().flash_mask_ranges(mask.data_ptr(), ranges.data_ptr(), nq, nkv,
                                        torch.cuda.current_stream(mask.device).cuda_stream)
    launches["flash_mask_ranges"] += 1
    _build.check(rc, "flash_mask_ranges")
    return ranges


def _prepare(q, k, v, mask, types: dict):
    """Check the inputs of a flash wrapper; returns the type-set code, the
    shapes (b, h, n_q, d, h_kv, n_kv, d_v) and the mask as (nq, nkv) f32."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, heads, rows, dim)")
    b, h, n_q, d = q.shape
    _, h_kv, n_kv, d_v = v.shape
    if (k.shape[0], v.shape[0]) != (b, b) or k.shape[1] != h_kv or h % h_kv or k.shape[2:] != (n_kv, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit together")
    code = types.get((q.dtype, k.dtype, v.dtype))
    if code is None:
        raise TypeError(f"unsupported types of q, k and v: {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v)) or (mask is not None and mask.device != q.device):
        raise ValueError("all inputs must be on one device")
    if mask is not None:
        if mask.shape[-1] != n_kv or mask.numel() // n_kv < n_q or mask.numel() != mask.shape[-2] * n_kv:
            raise ValueError(f"mask {tuple(mask.shape)} does not cover ({n_q}, {n_kv})")
        mask = mask.reshape(-1, n_kv)[:n_q].float()
    return code, (b, h, n_q, d, h_kv, n_kv, d_v), mask


def flash_attention(q, k, v, mask=None, scale: float = 1.0, max_bias: float = 0.0,
                    logit_softcap: float = 0.0, ranges=None) -> torch.Tensor:
    """Fused attention (kernel J).  q (b, h, nq, d), k (b, h_kv, nkv, d), v
    (b, h_kv, nkv, d_v), all bf16, all f32, or f32 q and k with bf16 v; mask
    (nq', nkv) additive f32 with nq' >= nq, or None; ranges: mask_ranges of
    the mask's first nq rows where the caller has them (checked on any
    device; the bf16 and mixed sets on the card read them, else this call
    computes them).  Returns (b, nq, h, d_v) in q's type."""
    types, (b, h, n_q, d, h_kv, n_kv, d_v), mask = _prepare(q, k, v, mask, _TYPES)
    if ranges is not None:
        ranges = _train_ranges(mask, ranges)
    slopes = _slopes_on(h, float(max_bias), q.device)
    softcap = float(logit_softcap)
    score_scale = float(scale / softcap) if softcap != 0.0 else float(scale)
    if not q.is_cuda:
        return _flash_attention_plain(q, k, v, mask, slopes, score_scale, softcap)

    if d % 8 or d_v % 8 or d > 256 or d_v > 256:
        raise ValueError(f"head dims {d}/{d_v}: the kernel takes multiples of 8 up to 256")
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((b, n_q, h, d_v), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if types == 0:  # all f32: the FMA kernel of csrc/flash_attn.cu
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        rc = _build.lib().flash_attn_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), slopes.data_ptr(),
                                         out.data_ptr(), None, b, h, h_kv, n_q, n_kv, d, d_v, score_scale, softcap,
                                         stream)
    else:
        ranges = _train_ranges(mask, ranges)
        v, v_st = _row_strides(v, 8)
        if types == 2:  # f32 q, split by the kernel as it reads it; f32 k as hi and lo planes
            q, q_st = _row_strides(q, 4)
            kp = split_hi_lo(k)
            q_args = (q.data_ptr(), kp[0].data_ptr(), kp[1].data_ptr())
            k_st = kp[0].stride()
        else:
            q, q_st = _row_strides(q, 8)
            k, k_st = _row_strides(k, 8)
            q_args = (q.data_ptr(), k.data_ptr(), None)
        rc = _build.lib().flash_attn_sm90(*q_args, v.data_ptr(), *q_st[:3], *k_st[:3], *v_st, _ptr(mask),
                                          _ptr(ranges), slopes.data_ptr(), out.data_ptr(), int(types == 2), b, h,
                                          h_kv, n_q, n_kv, d, d_v, score_scale, softcap, stream)
    launches["flash_attn"] += 1
    _build.check(rc, "flash_attn")
    return out


def _check_train_dims(code: int, d: int, d_v: int):
    top = 256 if code == 0 else 128
    if d % 8 or d_v % 8 or d > top or d_v > top:
        raise ValueError(f"head dims {d}/{d_v}: the training kernels take multiples of 8 up to {top} "
                         f"for {'f32' if code == 0 else 'bf16'}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _train_ranges(mask, ranges):
    """The bf16 kernels' mask ranges: those handed over (checked), else
    computed here (one flash_mask_ranges launch); None without a mask."""
    if mask is None:
        return None
    if ranges is None:
        return mask_ranges(mask)
    want = (2, -(-mask.shape[0] // _TILE), -(-mask.shape[1] // _TILE))
    if tuple(ranges.shape) != want or ranges.dtype != torch.float32 or ranges.device != mask.device \
            or not ranges.is_contiguous():
        raise ValueError(f"ranges {tuple(ranges.shape)} {ranges.dtype}: want {want} float32, contiguous, "
                         f"on the mask's device")
    return ranges


def flash_attention_fwd_lse(q, k, v, mask=None, scale: float = 1.0, max_bias: float = 0.0, ranges=None):
    """The training forward (kernel K).  q (b, h, nq, d), k (b, h_kv, nkv,
    d), v (b, h_kv, nkv, d_v), all bf16 or all f32; mask (nq', nkv) additive
    f32 with nq' >= nq, or None; ranges: mask_ranges of the mask's first nq
    rows where the caller has them (bf16 on the card reads them).  Returns
    o (b, nq, h, d_v) in q's type and lse (b, h, nq) f32."""
    code, (b, h, n_q, d, h_kv, n_kv, d_v), mask = _prepare(q, k, v, mask, _TRAIN_TYPES)
    slopes = _slopes_on(h, float(max_bias), q.device)
    if not q.is_cuda:
        return _fa_forward_lse_plain(q, k, v, mask, slopes, float(scale))

    _check_train_dims(code, d, d_v)
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((b, n_q, h, d_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if code == 0:  # all f32: the FMA kernel of csrc/flash_attn.cu
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        rc = _build.lib().flash_attn_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), slopes.data_ptr(),
                                         out.data_ptr(), lse.data_ptr(), b, h, h_kv, n_q, n_kv, d, d_v,
                                         float(scale), 0.0, stream)
    else:  # bf16: J's wgmma kernel with K's rules (csrc/flash_attn_sm90.cu)
        ranges = _train_ranges(mask, ranges)
        (q, q_st), (k, k_st), (v, v_st) = (_row_strides(t, 8) for t in (q, k, v))
        rc = _build.lib().flash_attn_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q_st, *k_st, *v_st,
                                             _ptr(mask), _ptr(ranges), slopes.data_ptr(), out.data_ptr(),
                                             lse.data_ptr(), b, h, h_kv, n_q, n_kv, d, d_v, float(scale), stream)
    launches["flash_attn_fwd_lse"] += 1
    _build.check(rc, "flash_attn_fwd_lse")
    return out, lse


def _bwd_args(q, k, v, mask, max_bias, do, lse, delta, ranges):
    """Check the backward wrappers' inputs (handed ranges too, on any
    device); returns the type-set code, the shapes, the mask as (nq, nkv)
    f32, the slopes and the ranges (None where none were handed)."""
    code, shapes, mask = _prepare(q, k, v, mask, _TRAIN_TYPES)
    b, h, n_q, d, h_kv, n_kv, d_v = shapes
    if tuple(do.shape) != (b, n_q, h, d_v) or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype}: want ({b}, {n_q}, {h}, {d_v}) {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, n_q) or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want ({b}, {h}, {n_q}) float32")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError("all inputs must be on one device")
    if ranges is not None:
        ranges = _train_ranges(mask, ranges)
    return code, shapes, mask, _slopes_on(h, float(max_bias), q.device), ranges


def flash_attention_bwd_dq(q, k, v, mask, scale: float, max_bias: float, do, lse, delta,
                           ranges=None) -> torch.Tensor:
    """dq of the training attention (kernel L).  q, k, v, mask and ranges as
    for flash_attention_fwd_lse; do (b, nq, h, d_v) the output's gradient,
    lse (b, h, nq) from the forward, delta (b, h, nq) = rowsum(dO * O), both
    f32.  Returns dq (b, h, nq, d) in q's type."""
    code, (b, h, n_q, d, h_kv, n_kv, d_v), mask, slopes, ranges = _bwd_args(q, k, v, mask, max_bias, do, lse,
                                                                            delta, ranges)
    if not q.is_cuda:
        return _fa_bwd_dq_plain(q, k, v, mask, slopes, float(scale), do, lse, delta)

    _check_train_dims(code, d, d_v)
    q, k, v, do, lse, delta = (t.contiguous() for t in (q, k, v, do, lse, delta))
    mask = None if mask is None else mask.contiguous()
    dq = torch.empty((b, h, n_q, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask))
    tail = (do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, h_kv, n_q, n_kv, d, d_v,
            float(scale), stream)
    if code == 0:  # all f32: the FMA kernel of csrc/flash_attn_bwd.cu
        rc = _build.lib().flash_attn_bwd_dq_f32(*ptrs, slopes.data_ptr(), *tail)
    else:  # bf16: the wgmma kernel of csrc/flash_bwd_sm90.cu
        rc = _build.lib().flash_attn_bwd_dq(*ptrs, _ptr(_train_ranges(mask, ranges)), slopes.data_ptr(), *tail)
    launches["flash_attn_bwd_dq"] += 1
    _build.check(rc, "flash_attn_bwd_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, mask, scale: float, max_bias: float, do, lse, delta, ranges=None):
    """dk and dv of the training attention for each q head (kernel M);
    arguments as for flash_attention_bwd_dq.  Returns dk (b, h, nkv, d) and
    dv (b, h, nkv, d_v) in k's and v's types; the heads that share a kv head
    are summed by the caller."""
    code, (b, h, n_q, d, h_kv, n_kv, d_v), mask, slopes, ranges = _bwd_args(q, k, v, mask, max_bias, do, lse,
                                                                            delta, ranges)
    if not q.is_cuda:
        return _fa_bwd_dkv_plain(q, k, v, mask, slopes, float(scale), do, lse, delta)

    _check_train_dims(code, d, d_v)
    q, k, v, do, lse, delta = (t.contiguous() for t in (q, k, v, do, lse, delta))
    mask = None if mask is None else mask.contiguous()
    dk = torch.empty((b, h, n_kv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, n_kv, d_v), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask))
    tail = (do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, h_kv, n_q, n_kv,
            d, d_v, float(scale), stream)
    if code == 0:  # all f32: the FMA kernel of csrc/flash_attn_bwd.cu
        rc = _build.lib().flash_attn_bwd_dkv_f32(*ptrs, slopes.data_ptr(), *tail)
    else:  # bf16: the wgmma kernel of csrc/flash_bwd_sm90.cu
        rc = _build.lib().flash_attn_bwd_dkv(*ptrs, _ptr(_train_ranges(mask, ranges)), slopes.data_ptr(), *tail)
    launches["flash_attn_bwd_dkv"] += 1
    _build.check(rc, "flash_attn_bwd_dkv")
    return dk, dv


class _FlashAttentionTrain(torch.autograd.Function):
    """K forward; L and M backward from the saved output and LSE
    (JAX _fa_train_fwd / _fa_train_bwd).  The mask gets no gradient.  For
    bf16 on the card K, L and M read the mask's tile ranges: those handed
    over (checked), else computed once here."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float, max_bias: float, ranges):
        # one contiguous copy of each head view, shared by K, L and M
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        code, _, mask2 = _prepare(q, k, v, mask, _TRAIN_TYPES)
        if ranges is not None or (mask2 is not None and q.is_cuda and code == 1):
            ranges = _train_ranges(mask2, ranges)
        o, lse = flash_attention_fwd_lse(q, k, v, mask, scale, max_bias, ranges=ranges)
        ctx.save_for_backward(q, k, v, mask, o, lse, ranges)
        ctx.scale, ctx.max_bias = scale, max_bias
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, mask, o, lse, ranges = ctx.saved_tensors
        do = g.contiguous()
        # delta from the stored output in its own type (the JAX o_pad), not the f32 sums
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, mask, ctx.scale, ctx.max_bias, do, lse, delta, ranges=ranges)
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask, ctx.scale, ctx.max_bias, do, lse, delta, ranges=ranges)
        b, h_kv, n_kv, _ = k.shape
        rep = q.shape[1] // h_kv
        if rep > 1:  # GQA: each q head's dk/dv, in k's type, summed onto its kv head
            dk = dk.view(b, h_kv, rep, n_kv, -1).sum(2).to(k.dtype)
            dv = dv.view(b, h_kv, rep, n_kv, -1).sum(2).to(v.dtype)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, mask=None, scale: float = 1.0, max_bias: float = 0.0,
                          ranges=None) -> torch.Tensor:
    """Differentiable fused attention, the training path: flash_attention's
    semantics and layout without softcap, q, k and v all bf16 or all f32;
    ranges: mask_ranges of the mask where the caller has them (a model
    computes them once per forward for all its layers), else the bf16 set on
    the card computes them once here for K, L and M.  Returns (b, nq, h,
    d_v) in q's type; gradients flow to q, k and v."""
    return _FlashAttentionTrain.apply(q, k, v, mask, float(scale), float(max_bias), ranges)
