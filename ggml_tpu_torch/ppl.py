"""Perplexity harness — the Δppl gate machinery (port of ggml_tpu/ppl.py).

The reference ecosystem measures quantization quality as the perplexity
delta against the f32 model over a token stream (llama.cpp's `perplexity`
tool downstream of ggml).  This module computes windowed perplexity for any
family forward(params, cfg, tokens, pos_start, cache, cache_len,
prefill=True) of the port; a window is one prefill from an empty cache.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def perplexity(forward_fn, params, cfg, tokens: np.ndarray, window: int = 256, stride: int | None = None,
               init_cache_fn=None, cache_dtype=None, device="cuda") -> float:
    """Sliding-window perplexity: mean NLL of each window's second half
    (the llama.cpp convention: the first half is context only).
    init_cache_fn(cfg, batch, max_seq, dtype, device) makes each window's
    cache (f32 unless cache_dtype); the log-softmax runs in f32."""
    tokens = np.asarray(tokens).reshape(-1)
    stride = stride or window // 2
    if not (1 <= stride <= window - 1):
        raise ValueError(f"stride must be in [1, window-1], got {stride}")
    if cache_dtype is None:
        cache_dtype = torch.float32
    zero = torch.zeros((), dtype=torch.int32, device=device)

    total_nll = 0.0
    total_cnt = 0
    pos = 0
    while pos + window <= len(tokens):
        toks = torch.from_numpy(tokens[pos : pos + window].astype(np.int64)).to(device)
        cache = init_cache_fn(cfg, 1, window, cache_dtype, device)
        with torch.no_grad():
            out = forward_fn(params, cfg, toks[None, :], zero.expand(1), cache, zero, prefill=True)
            logits = out[0] if isinstance(out, tuple) else out  # the families return (logits, cache)
            logp = torch.log_softmax(logits[0].float(), dim=-1)
            nll = -torch.gather(logp[:-1], -1, toks[1:, None])[:, 0]  # (window-1,)
        # score each token exactly once: the first window scores everything,
        # later windows score only the `stride` new positions at their end
        # (a caller-supplied stride != window//2 would otherwise double-count
        # or skip tokens)
        half = (window - 1) - stride if pos > 0 else 0
        total_nll += float(nll[half:].sum())
        total_cnt += len(nll) - half
        pos += stride
    if total_cnt == 0:
        raise ValueError("token stream shorter than one window")
    return math.exp(total_nll / total_cnt)
