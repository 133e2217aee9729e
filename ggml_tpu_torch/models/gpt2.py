"""GGUF tensor-naming loader shared by GPT-2-style families (port of
ggml_tpu/models/gpt2.py:68 load_params; the GPT-2 model itself is not ported
yet, ROADMAP.md)."""

from __future__ import annotations

from typing import Any

import torch

from ..dtypes import GGMLType, is_quantized
from ..gguf import GGUFFile


def load_params(g: GGUFFile, dtype=torch.float32, device="cuda") -> dict:
    """Load GGUF tensors onto `device`, as the JAX load_params does with
    keep_quantized=True.

    2-D quantized matmul weights are repacked to planes
    (quant/planar.py) and stay packed in device memory, consumed by the fused
    kernels; the token embedding is additionally kept dense for the row
    gather.  Everything else is loaded as `dtype`.  Ported plane layouts:
    Q4_0, Q4_1, Q2_K, Q3_K, Q4_K (packed nibbles where (K/2) % G == 0, else
    int8), Q5_0, Q5_1, Q8_0, Q5_K, Q6_K (int8); any other quantized type (the
    IQ* and TQ* families) raises NotImplementedError.
    """
    from ..quant.planar import repack

    params: dict[str, Any] = {}
    for name, info in g.tensors.items():
        is_matmul_weight = (
            name.endswith(".weight")
            and len(info.shape) == 2
            and "norm" not in name
            and name != "position_embd.weight"
        )
        if is_matmul_weight and is_quantized(info.ggml_type):
            n, k = info.shape
            pw = repack(g.tensor_bytes(name), GGMLType(info.ggml_type), (int(n), int(k)))
            params[name] = pw.to(device)
            if name == "token_embd.weight":  # dense copy for the row gather
                params["token_embd.weight@dense"] = torch.from_numpy(g.to_float32(name)).to(device, dtype)
        else:
            params[name] = torch.from_numpy(g.to_float32(name)).to(device, dtype)
    return params
