"""The RoPE helpers of ggml_tpu/ops/core.py that the Llama family's scaled
rotate-half RoPE calls (reference: ggml_rope_ext include/ggml.h:1407-1536,
ggml_rope_yarn_corr_dims src/ggml.c:3699): the port's own copy.

`rope_cos_sin` splits the JAX `_rope_cos_sin` into its position-free
constants, computed on the host once per shape and device and never evicted
(a captured decode graph reads them), and the work on the positions, which
stays on the device, so a decode step reads no value on the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _yarn_corr_dim(n_dims, n_ctx_orig, n_rot, base):
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def rope_yarn_corr_dims(n_dims, n_ctx_orig, freq_base, beta_fast, beta_slow):
    """reference: ggml_rope_yarn_corr_dims src/ggml.c:3699."""
    start = math.floor(_yarn_corr_dim(n_dims, n_ctx_orig, beta_fast, freq_base))
    end = math.ceil(_yarn_corr_dim(n_dims, n_ctx_orig, beta_slow, freq_base))
    return max(0.0, start), min(n_dims - 1.0, end)


@functools.cache
def _rope_tables(n_dims: int, freq_base: float, ext_factor: float, corr_dims: tuple, device: torch.device):
    """theta_scale, 1 - ramp_mix and ramp_mix (n_dims/2,) f32 on `device`,
    in the JAX function's f32 operations (the power in float64, rounded
    once); the ramps are None without YaRN."""
    f32 = np.float32
    i0 = f32(2.0) * np.arange(n_dims // 2, dtype=f32)
    theta_scale = np.power(np.float64(freq_base), (-i0 / f32(n_dims)).astype(np.float64)).astype(f32)
    move = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if ext_factor == 0.0:
        return move(theta_scale), None, None
    low, high = corr_dims
    ramp = f32(1.0) - np.clip((i0 / f32(2) - f32(low)) / f32(max(0.001, high - low)), f32(0.0), f32(1.0))
    ramp_mix = (ramp * f32(ext_factor)).astype(f32)
    return move(theta_scale), move((f32(1) - ramp_mix).astype(f32)), move(ramp_mix)


def rope_cos_sin(pos, n_dims, freq_base, freq_scale, ext_factor, attn_factor, corr_dims):
    """cos and sin (n_pos, n_dims/2) f32 of rope_yarn at the positions pos
    (n_pos,), an integer tensor on any device (port of ggml_tpu/ops/core.py
    _rope_cos_sin without frequency factors)."""
    theta_scale, one_minus_mix, ramp_mix = _rope_tables(int(n_dims), float(freq_base), float(ext_factor),
                                                        tuple(float(c) for c in corr_dims), pos.device)
    theta_extrap = pos.float()[:, None] * theta_scale[None, :]
    theta_interp = freq_scale * theta_extrap
    mscale = attn_factor
    if ext_factor != 0.0:
        theta = theta_interp * one_minus_mix + theta_extrap * ramp_mix
        mscale = mscale * (1.0 + 0.1 * math.log(1.0 / freq_scale))
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale
