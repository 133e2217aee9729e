"""A GGUF file of random weights for a family: its write_random_gguf names
the keys and the tensors, in the order llama.cpp's converter writes them,
and this module draws the values and writes the file.  Such a file runs the
GGUF path at any width without a checkpoint (tests, chip_smoke.py)."""

from __future__ import annotations

import numpy as np

from ..dtypes import GGMLType
from .gptj import _random_weight_blocks

# llama.cpp's fallback for a k-quant whose rows are not whole superblocks of
# 256 (llama_tensor_get_type)
_FALLBACK = {GGMLType.Q4_K: GGMLType.Q5_0, GGMLType.Q6_K: GGMLType.Q8_0}


def write_family_gguf(path, arch: str, keys: list, tensors: list, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K, arrays: dict | None = None):
    """keys: (key under the `arch.` prefix, value), written as a bool, a u32
    (an int), an f32 (a float) or a string by the value's type.  tensors:
    (name, numpy shape, kind) with kind "w" for a matmul weight (of
    types.get(name, default_type); a Q4_K or Q6_K weight whose K is not a
    multiple of 256 takes llama.cpp's fallback, Q5_0 or Q8_0), "ones" for a
    norm, or a float: F32 normal values of that std.  A quantized weight is
    random blocks of weights of std about 0.02 (models/gptj.
    _random_weight_blocks), an F32 one normal values of std 0.02; the
    values are drawn from default_rng(seed) in the list's order.  arrays:
    name -> an F32 array written as it is, after the listed tensors.
    tokenizer: GGUF tokenizer.ggml.* keys (without the prefix) -> values."""
    from ..gguf import GGUFWriter

    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    w.add_string("general.architecture", arch)
    for key, val in keys:
        add = (w.add_bool if isinstance(val, bool) else w.add_u32 if isinstance(val, int)
               else w.add_f32 if isinstance(val, float) else w.add_string)
        add(f"{arch}.{key}", val)
    for key, val in (tokenizer or {}).items():
        if isinstance(val, str):
            w.add_string(f"tokenizer.ggml.{key}", val)
        elif isinstance(val, int):
            w.add_u32(f"tokenizer.ggml.{key}", val)
        else:
            w.add_array(f"tokenizer.ggml.{key}", val)
    for name, shape, kind in tensors:
        if kind == "ones":
            w.add_tensor(name, np.ones(shape, np.float32))
            continue
        t = GGMLType((types or {}).get(name, default_type)) if kind == "w" else GGMLType.F32
        if t == GGMLType.F32:
            w.add_tensor(name, (rng.standard_normal(shape) * (0.02 if kind == "w" else kind)).astype(np.float32))
            continue
        if shape[-1] % 256 and t in _FALLBACK:
            t = _FALLBACK[t]
        w.add_tensor(name, _random_weight_blocks(t, int(np.prod(shape[:-1])), shape[-1], rng), t,
                     raw_shape_ne=tuple(reversed(shape)))
    for name, a in (arrays or {}).items():
        w.add_tensor(name, np.asarray(a, np.float32))
    w.write(path)
