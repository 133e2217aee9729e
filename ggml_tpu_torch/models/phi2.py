"""Rotate-half RoPE on the first n_rot dims of each head (port of
ggml_tpu/models/phi2.py:71-82), the helper glm4moe imports from the phi2
module, as the JAX glm4moe does.

Only this helper is here: the phi2 family itself is not ported yet
(models/registry._NOT_PORTED) and comes into this module with it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.cache
def _inv_freq(n_rot: int, base: float, device: torch.device) -> torch.Tensor:
    """base ** (-j / half) for j < half = n_rot / 2, in float64 numpy cast to
    float32, as phi2.py:75 computes it; copied to the device once (a
    captured decode graph reads the tensor)."""
    half = n_rot // 2
    return torch.from_numpy((base ** (-np.arange(half) / half)).astype(np.float32)).to(device)


def partial_angles(positions: torch.Tensor, n_rot: int, base: float):
    """cos, sin (b, t, 1, n_rot/2) f32 at positions (b, t): theta is the f32
    product of the positions and the frequencies.  Computed once per forward
    and shared by every layer's q and k."""
    theta = positions.float()[..., None] * _inv_freq(n_rot, base, positions.device)[None, None, :]
    return torch.cos(theta)[:, :, None, :], torch.sin(theta)[:, :, None, :]


def _rope_half_partial(x, cos, sin, n_rot: int):
    """rotate_half RoPE on the first n_rot dims of x (b, t, h, d), the rest
    passed through (ggml NeoX mode restricted to rope_dim; HF Phi's
    partial_rotary_factor).  cos, sin from partial_angles."""
    half = n_rot // 2
    rot, rest = x[..., :n_rot], x[..., n_rot:]
    x0, x1 = rot[..., :half], rot[..., half:]
    out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return torch.cat([out, rest.to(out.dtype)], dim=-1) if rest.shape[-1] else out
