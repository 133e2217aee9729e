"""Block decodes of Q4_K, Q5_0 and Q8_0 in PyTorch, run where the raw blocks
are: models/gpt2.load_params dequantizes a CUDA load's stacked experts on
the card (the host copies the raw blocks, a quarter to a ninth of the f32
bytes, and decodes nothing).  Each decode is quant/reference.py's, op for op
in f32 (one elementwise op a kernel, so nothing is contracted into an FMA),
and gives its values bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dtypes import GGMLType, get_type_traits
from .reference import _Q4K_IS, _Q4K_NIB, _Q4K_QIDX


def _f16(b: torch.Tensor, off: int) -> torch.Tensor:
    """The fp16 field at byte offset off of each block -> (nb, 1) f32."""
    return b[:, off:off + 2].contiguous().view(torch.float16).float()


@functools.cache
def _q4k_maps(device: torch.device) -> tuple:
    """reference.py's Q4_K element maps (sub-block, byte, nibble) on device."""
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device) for a in (_Q4K_IS, _Q4K_QIDX, _Q4K_NIB))


def dequant_q4_k(b: torch.Tensor) -> torch.Tensor:
    """reference.dequant_q4_k: (nb, 144) uint8 -> (nb, 256) f32."""
    is_, qidx, nib = _q4k_maps(b.device)
    s = b[:, 4:16].to(torch.int32)
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1).float()
    m = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1).float()
    qs = b[:, 16:144][:, qidx]
    q = torch.where(nib == 0, qs & 0xF, qs >> 4).float()
    dl = _f16(b, 0) * sc[:, is_]
    ml = _f16(b, 2) * m[:, is_]
    return dl * q - ml


def dequant_q5_0(b: torch.Tensor) -> torch.Tensor:
    """reference.dequant_q5_0: (nb, 22) uint8 -> (nb, 32) f32."""
    qs = b[:, 6:22].to(torch.int32)
    qh = b[:, 2:6].to(torch.int64)
    qh = (qh[:, 0] | (qh[:, 1] << 8) | (qh[:, 2] << 16) | (qh[:, 3] << 24))[:, None]
    j = torch.arange(16, device=b.device)
    high = torch.cat([((qh >> j) << 4) & 0x10, (qh >> (j + 12)) & 0x10], dim=1).to(torch.int32)
    codes = torch.cat([qs & 0x0F, qs >> 4], dim=1) | high
    return (codes - 16).float() * _f16(b, 0)


def dequant_q8_0(b: torch.Tensor) -> torch.Tensor:
    """reference.dequant_q8_0: (nb, 34) uint8 -> (nb, 32) f32."""
    return b[:, 2:34].contiguous().view(torch.int8).float() * _f16(b, 0)


DEQUANT = {GGMLType.Q4_K: dequant_q4_k, GGMLType.Q5_0: dequant_q5_0, GGMLType.Q8_0: dequant_q8_0}


def dequantize(raw: torch.Tensor, ggml_type: GGMLType, n_elements: int) -> torch.Tensor:
    """Raw blocks (uint8, on any device) -> flat f32 of n_elements on the same
    device, equal to reference.dequantize's bit for bit."""
    t = GGMLType(ggml_type)
    tr = get_type_traits(t)
    nb = n_elements // tr.block_size
    return DEQUANT[t](raw.reshape(-1)[:nb * tr.type_size].reshape(nb, tr.type_size)).reshape(-1)
