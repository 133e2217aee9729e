"""Token sampling (port of ggml_tpu/sampling.py; reference:
examples/common.cpp:655-753 gpt_sample_top_k_top_p).

The filtering runs on the logits' device as tensor ops, so the decode loop
can sample inside a captured CUDA graph (models/common.DecodeGraph): no value
goes back to the host.  Temperature and top_p may be Python numbers, 0-d
f32 tensors on that device (what a graph keeps in its static buffers) or
(batch, 1) f32 tensors, one value a row (serve.Engine's per-request
sampling, as the JAX engine passes them); top_k is a shape and stays a
Python int.  Draws come from an explicit
torch.Generator on the logits' device.  JAX's and torch's random streams
differ, so the tests hold the filter against JAX and the draws against the
distribution it defines.
"""

from __future__ import annotations

import torch


def _scalar(x, device) -> torch.Tensor:
    """x as an f32 tensor on `device` (a tensor already there is kept)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def warp_logits(logits, temperature=1.0, top_k: int = 40, top_p=0.9, repeat_penalty: float = 1.0,
                recent_tokens=None) -> torch.Tensor:
    """The reference sampler's filter as a logit transform: repeat penalty
    over recent_tokens (..., n) -> temperature -> top-k -> top-p over the
    sorted distribution, returning f32 logits with -inf outside the kept
    set.  softmax of the result is the sampling distribution.  The same
    order and cut-off rule as the JAX warp_logits: top-p keeps the sorted
    prefix up to the first entry whose cumulative probability reaches top_p."""
    lg = logits.float()
    neg_inf = torch.full((), float("-inf"), device=lg.device)
    if recent_tokens is not None and repeat_penalty != 1.0:
        rp = _scalar(repeat_penalty, lg.device)
        penal = torch.where(lg > 0, lg / rp, lg * rp)
        recent = torch.as_tensor(recent_tokens, device=lg.device).long()
        hit = torch.zeros(lg.shape, dtype=torch.bool, device=lg.device).scatter_(-1, recent, True)
        lg = torch.where(hit, penal, lg)
    lg = lg / torch.clamp(_scalar(temperature, lg.device), min=1e-6)
    kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
    lg = torch.where(lg < kth, neg_inf, lg)
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    # the first index where cum >= top_p; past the end (rounding below a top_p
    # of 1) the JAX gather fills NaN and cuts nothing, as the last value does
    cut = torch.sum(cum < top_p, dim=-1, keepdim=True).clamp(max=lg.shape[-1] - 1)
    return torch.where(lg < torch.gather(sorted_lg, -1, cut), neg_inf, lg)


def sample_top_k_top_p(logits, generator: torch.Generator, temperature=1.0, top_k: int = 40, top_p=0.9,
                       repeat_penalty: float = 1.0, recent_tokens=None):
    """logits (batch, vocab) -> (tokens (batch,) int64, generator).  One draw
    from softmax(warp_logits(...)) per row, as the exponential race that
    torch.multinomial runs for one sample (argmax of log p - log E, E ~
    Exp(1) from `generator`), without its check that reads a value back to
    the host."""
    return race(warp_logits(logits, temperature, top_k, top_p, repeat_penalty, recent_tokens), generator), generator


def race(logits, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) as the exponential race
    (argmax of logits - log E, E ~ Exp(1) from `generator`): what
    torch.multinomial runs for one sample, reading nothing on the host."""
    lg = logits.float()
    e = torch.empty_like(lg).exponential_(generator=generator)
    return torch.argmax(lg - torch.log(e), dim=-1)


def greedy(logits) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)
