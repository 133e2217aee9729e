"""Carry a parameter dict of the JAX package over to the port, as numpy.

The caller turns every array into numpy (np.asarray) and every PlanarWeight
into a dict of its fields, so the port never sees a JAX object and the same
numbers go through both packages:

    {"kind", "codes", "scales", "offsets", "supers", "group", "n", "k", "sb",
     "orig_type" (int)}
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import GGMLType
from .quant.planar import PlanarWeight


def _tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(params: dict, device="cuda") -> dict:
    """numpy parameter dict (PlanarWeights as field dicts) -> the port's
    parameters on `device`."""
    out = {}
    for name, v in params.items():
        if isinstance(v, dict):
            supers = v.get("supers")
            out[name] = PlanarWeight(
                kind=v["kind"], codes=_tensor(v["codes"], device), scales=_tensor(v["scales"], device),
                offsets=_tensor(v.get("offsets"), device), group=int(v["group"]), n=int(v["n"]),
                k=int(v["k"]), orig_type=GGMLType(int(v["orig_type"])), sb=int(v.get("sb", 8)),
                supers=None if supers is None else tuple(_tensor(s, device) for s in supers))
        else:
            out[name] = _tensor(v, device)
    return out
