"""Shared model plumbing: the KV cache, layer norm, linear layers and the
greedy generation loop (port of ggml_tpu/models/common.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch

_SAMPLING_TODO = "sampled generation is not ported yet (ROADMAP.md, sampling and the CLI)"


def init_layer_cache(n_layer: int, batch: int, n_kv_head: int, max_seq: int, head_dim: int,
                     dtype=torch.bfloat16, device="cuda") -> list:
    """KV cache as a list of per-layer (k, v) pairs, each (B, H, S, D).

    Where the JAX package donates the cache to its jitted step so that XLA
    updates it in place, the port writes the rows in place itself
    (cache_write); the buffers are allocated once per sequence."""
    mk = lambda: torch.zeros((batch, n_kv_head, max_seq, head_dim), dtype=dtype, device=device)
    return [(mk(), mk()) for _ in range(n_layer)]


def cache_write(cache_layer: torch.Tensor, kv: torch.Tensor, rows: torch.Tensor):
    """Write kv (b, h, t, d) into cache_layer (b, h, S, d) IN PLACE at the t
    positions `rows` (a long tensor on the cache's device, cache_len ..
    cache_len+t-1, shared by every sequence of the batch), so the write needs
    no host value.  The caller keeps the rows below S."""
    cache_layer.index_copy_(2, rows, kv.to(cache_layer.dtype))


@functools.lru_cache(maxsize=4)
def causal_mask(t: int, device="cuda") -> torch.Tensor:
    """Additive (t, t) f32 causal mask with a finite -inf (-1e30 above the
    diagonal), built on the device and cached per length and device.  Only
    the last few lengths are kept: at t = 2048 a mask is 16.8 MB."""
    i = torch.arange(t, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, -1e30).to(torch.float32)


def layer_norm(x, w, b, eps):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean((x - m) ** 2, dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w + b


def linear(x, w, b=None):
    """Dense or planar-quantized matmul: y = x @ W^T (+ b).  A dense f32
    product runs in full f32: the caller keeps TF32 off, as the JAX package
    pins Precision.HIGHEST."""
    from ..quant.planar import PlanarWeight

    if isinstance(w, PlanarWeight):
        from ..kernels.qmatmul import planar_matmul

        out = planar_matmul(x, w)
    else:
        out = torch.matmul(x, w.t())
    if b is not None:
        out = out + b
    return out


def generate(model, prompt_tokens: np.ndarray, n_tokens: int, sampler=None, key=None) -> list[int]:
    """Greedy generation shared by the model wrappers: prefill, then the
    on-device decode loop.  The tokens stay on the device until the end, so
    the loop never waits for the host.  Returns the n_tokens generated ids of
    the first sequence, as the JAX generate does."""
    if sampler is not None:
        raise NotImplementedError(_SAMPLING_TODO)
    cache = model.new_cache()
    logits, cache, n_past = model.prefill(cache, prompt_tokens)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    if n_tokens <= 1:
        return first[0, :n_tokens].tolist()
    cache, toks = model.decode_greedy(cache, first, n_past, n_tokens - 1)
    return [int(first[0, 0])] + toks[:, 0].tolist()

