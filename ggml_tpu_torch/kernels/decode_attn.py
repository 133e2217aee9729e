"""Fused single-token decode attention (kernel D).

The port of ggml_tpu/kernels/decode_attn.py.  One call per layer computes

    att = softmax(mask(q . K'^T * scale))   K' = cache with k_new at row pos
    out = att . V'                          V' = cache with v_new at row pos

over the cache as it was BEFORE this step's write; keys past pos are masked
out.  The cache row write stays with the caller, an in-place slice
assignment (models/common.cache_write).  Dots and softmax are f32.  pos is a
0-d int32 tensor on the cache's device: the CUDA kernel reads it itself
(csrc/decode_attn.cu), so the decode loop never syncs with the host.  The
kernel splits the window into chunks of 64 keys over many blocks and merges
their partial softmaxes in the same launch; the window S has no cap of its
own.

For CPU tensors the wrapper runs the plain PyTorch version; for CUDA tensors
it launches the kernel, never the plain version.  `launches` counts kernel
launches.
"""

from __future__ import annotations

import torch

from . import _build

launches = {"decode_attn": 0}
_CHUNK = 64  # keys per block of the CUDA kernel

_counters: dict = {}  # device -> int32 arrival counters, zero between launches
_retired: list = []  # buffers a larger one replaced: a captured decode graph may still use them


def _zeroed_counters(n: int, device) -> torch.Tensor:
    """At least n int32 arrival counters on `device`, zero: each launch
    leaves the ones it used at zero, so one buffer serves every launch (and
    every replay of a CUDA graph that captured one, on one stream)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _decode_attention_plain(q, k_new, v_new, kc, vc, pos, scale):
    """Same function as the kernel, in PyTorch: the new row replaces row pos
    of a copy of the window, then masked f32 attention."""
    _, hq, _, d = q.shape
    _, hkv, s, _ = kc.shape
    rep = hq // hkv
    p = int(pos)
    row = torch.arange(s, device=kc.device).view(1, s, 1)
    kf = torch.where(row == p, k_new.reshape(hkv, 1, d), kc.reshape(hkv, s, d)).float()
    vf = torch.where(row == p, v_new.reshape(hkv, 1, d), vc.reshape(hkv, s, d)).float()
    qh = q.reshape(hkv, rep, d).float()
    att = torch.matmul(qh, kf.transpose(1, 2)) * scale  # (hkv, rep, s)
    att = torch.where(row.view(1, 1, s) <= p, att, torch.tensor(float("-inf")))
    att = torch.softmax(att, dim=-1)
    return torch.matmul(att, vf).reshape(1, hq, 1, d)


def fused_decode_attention(q, k_new, v_new, kc, vc, pos, *, scale: float) -> torch.Tensor:
    """q (1, hq, 1, d); k_new/v_new (1, hkv, 1, d); kc/vc (1, hkv, S, d), the
    PRE-update caches; pos a 0-d int32 tensor on the same device.  Returns
    out (1, hq, 1, d) f32.  The CUDA kernel takes q as f32 (a bf16 q is
    widened exactly) and k_new/v_new/kc/vc as bf16."""
    b, hq, one, d = q.shape
    _, hkv, s, _ = kc.shape
    if b != 1 or one != 1 or hq % hkv or kc.shape[0] != 1 or vc.shape != kc.shape:
        raise ValueError(f"fused decode attention takes one token of one sequence: q {tuple(q.shape)}, "
                         f"cache {tuple(kc.shape)}")
    if k_new.shape != (1, hkv, 1, d) or v_new.shape != (1, hkv, 1, d) or kc.shape[-1] != d:
        raise ValueError(f"k_new/v_new {tuple(k_new.shape)}/{tuple(v_new.shape)} do not match the cache")
    if not isinstance(pos, torch.Tensor) or pos.numel() != 1 or pos.dtype != torch.int32:
        raise TypeError("pos must be a one-element int32 tensor")
    tensors = (q, k_new, v_new, kc, vc, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not q.is_cuda:
        return _decode_attention_plain(q, k_new, v_new, kc, vc, pos, scale)

    if q.dtype == torch.bfloat16:
        q = q.float()
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != torch.bfloat16 for t in (k_new, v_new, kc, vc)):
        raise TypeError("k_new, v_new and the caches must be bfloat16")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    if d not in (64, 128, 256, 512):
        raise ValueError(f"head dim {d} outside the kernel's range (64, 128, 256, 512)")
    lib = _build.lib()
    hb = lib.decode_attn_heads_per_block(hq // hkv, d)
    units = hkv * -(-(hq // hkv) // hb)
    out = torch.empty((1, hq, 1, d), dtype=torch.float32, device=q.device)
    part = torch.empty(units * -(-s // _CHUNK) * hb * (d + 2), dtype=torch.float32, device=q.device)
    counters = _zeroed_counters(units, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                         pos.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(), hq, hkv, s, d,
                         float(scale), stream)
    launches["decode_attn"] += 1
    _build.check(rc, "decode_attn")
    return out
