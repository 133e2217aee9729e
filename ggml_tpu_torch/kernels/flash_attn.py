"""Flash attention forward (kernel J): online-softmax attention for prefill.

The port of ggml_tpu/kernels/flash_attn.py `flash_attention`: additive f32
mask (the ggml KQ mask) times a per-head ALiBi slope, optional logit softcap
applied before the mask, GQA by h // h_kv, f32 scores and sums, `p` rounded to
v's type before p @ v, rows that never leave the -1e30 sentinel give zeros.
Ragged q and kv lengths need no padding here: the kernel checks bounds.
q, k and v are all bf16, all f32, or f32 q and k with bf16 v: what a bf16
model's prefill hands over, since RoPE leaves q and k in f32.

For CPU tensors the wrapper runs the plain PyTorch version; for CUDA tensors
it launches the kernel (csrc/flash_attn.cu), never the plain version.
`launches` counts kernel launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build

launches = {"flash_attn": 0}

_NEG_INF = -1e30  # finite "minus infinity": the running max starts here, so exp() stays NaN-free
_BKV = 64  # kv rows per step, of the CUDA kernel and of the plain version


# the type sets the kernel takes (q, k, v), by the code csrc/flash_attn.cu knows them by
_TYPES = {(torch.float32, torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16, torch.bfloat16): 1,
          (torch.float32, torch.float32, torch.bfloat16): 2}


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


def _flash_attention_plain(q, k, v, mask, slopes, score_scale: float, softcap: float) -> torch.Tensor:
    """The kernel's function in PyTorch: the online-softmax recurrence over
    kv tiles of 64 rows, the kernel's.  The tile fixes the running max each p
    is rounded against before p @ v; the JAX wrapper picks other tiles, so for
    a bf16 v the two differ by single bf16 roundings of p (for an f32 v only
    in the last bits).  mask: (nq, nkv) f32 or None; slopes: (h,) f32;
    score_scale: scale, or scale / softcap where softcap != 0.  Returns
    (b, nq, h, d_v) in q's type."""
    b, h, n_q, _ = q.shape
    _, h_kv, n_kv, d_v = v.shape
    rep = h // h_kv
    qf = q.float()
    m = torch.full((b, h, n_q, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, n_q, d_v), dtype=torch.float32, device=q.device)
    for kv0 in range(0, n_kv, _BKV):
        kf = k[:, :, kv0 : kv0 + _BKV].float().repeat_interleave(rep, dim=1)
        vt = v[:, :, kv0 : kv0 + _BKV].repeat_interleave(rep, dim=1)
        s = torch.matmul(qf, kf.transpose(-1, -2))
        s = torch.tanh(s * score_scale) * softcap if softcap != 0.0 else s * score_scale
        if mask is not None:
            s = s + slopes.view(1, h, 1, 1) * mask[:, kv0 : kv0 + _BKV]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(m <= _NEG_INF * 0.5, torch.zeros_like(acc), acc / l)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def flash_attention(q, k, v, mask=None, scale: float = 1.0, max_bias: float = 0.0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """Fused attention.  q (b, h, nq, d), k (b, h_kv, nkv, d), v (b, h_kv, nkv,
    d_v), all bf16, all f32, or f32 q and k with bf16 v; mask (nq', nkv)
    additive f32 with nq' >= nq, or None.  Returns (b, nq, h, d_v) in q's type."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, heads, rows, dim)")
    b, h, n_q, d = q.shape
    _, h_kv, n_kv, d_v = v.shape
    if (k.shape[0], v.shape[0]) != (b, b) or k.shape[1] != h_kv or h % h_kv or k.shape[2:] != (n_kv, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit together")
    types = _TYPES.get((q.dtype, k.dtype, v.dtype))
    if types is None:
        raise TypeError("q, k and v must all be bfloat16, all float32, or float32 q and k with bfloat16 v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v)) or (mask is not None and mask.device != q.device):
        raise ValueError("all inputs must be on one device")
    if mask is not None:
        if mask.shape[-1] != n_kv or mask.numel() // n_kv < n_q or mask.numel() != mask.shape[-2] * n_kv:
            raise ValueError(f"mask {tuple(mask.shape)} does not cover ({n_q}, {n_kv})")
        mask = mask.reshape(-1, n_kv)[:n_q].float()
    slopes = torch.from_numpy(alibi_slopes(h, max_bias)).to(q.device)
    softcap = float(logit_softcap)
    score_scale = float(scale / softcap) if softcap != 0.0 else float(scale)
    if not q.is_cuda:
        return _flash_attention_plain(q, k, v, mask, slopes, score_scale, softcap)

    if d % 8 or d_v % 8 or d > 256 or d_v > 256:
        raise ValueError(f"head dims {d}/{d_v}: the kernel takes multiples of 8 up to 256")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty((b, n_q, h, d_v), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None if mask is None else mask.data_ptr(), slopes.data_ptr(),
                                 out.data_ptr(), types, b, h, h_kv, n_q, n_kv,
                                 d, d_v, score_scale, softcap, stream)
    launches["flash_attn"] += 1
    _build.check(rc, "flash_attn")
    return out
