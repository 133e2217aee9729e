"""Checkpoint and resume: training state in a GGUF file (port of
ggml_tpu/checkpoint.py).

The reference stores model weights as GGUF (src/gguf.cpp:1303) and leaves
optimizer momenta to the caller; this module writes the whole Optimizer
state (params, m, v, g_acc and the step counters) to one GGUF file, so a
training run can restart, and the file stays readable by every GGUF tool.

The layout is the JAX package's, so either package reads the other's files:
nested dict paths become '/'-joined tensor names (f32; bf16 state is
widened), general.architecture is ggml_tpu.checkpoint, and the counters ride
in the metadata (opt.t, opt.i_acc, opt.loss_type, opt.period).  A file is
written beside its name as <name>.tmp and renamed over it, so a process
killed while writing never leaves a truncated checkpoint.
"""

from __future__ import annotations

import os
import pathlib
import re

import numpy as np
import torch

from .gguf import GGUFFile, GGUFWriter

# I8, I16, I32, I64: read as they are, not as float32
_INT_TYPES = {24: np.int8, 25: np.int16, 26: np.int32, 27: np.int64}


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in k:
                raise ValueError(f"checkpoint keys may not contain '/': {k!r}")
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        cur = tree
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = arr
    return tree


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def save_params(path, params, metadata: dict | None = None) -> None:
    """Write a nested dict of tensors (or arrays) to a GGUF file, atomically."""
    w = GGUFWriter()
    w.add_string("general.architecture", "ggml_tpu.checkpoint")
    for k, v in (metadata or {}).items():
        if isinstance(v, str):
            w.add_string(k, v)
        elif isinstance(v, bool):
            w.add_bool(k, v)
        elif isinstance(v, float):
            w.add_f32(k, v)
        else:
            w.add_i32(k, int(v))
    for name, arr in _flatten(params).items():
        a = _to_numpy(arr)
        if a.ndim == 0:
            a = a.reshape(1)
        w.add_tensor(name, np.ascontiguousarray(a))
    tmp = f"{path}.tmp"
    w.write(tmp)
    os.replace(tmp, path)


def load_params(path, dtype=None, device="cuda") -> tuple[dict, dict]:
    """Read a GGUF checkpoint back into a nested dict of tensors on `device`
    (float32, or `dtype`) and its metadata."""
    flat = {}
    with GGUFFile(path) as g:
        for name, info in g.tensors.items():
            if info.ggml_type in _INT_TYPES:  # copied: no view of the file outlives it
                a = g.tensor_bytes(name).view(_INT_TYPES[info.ggml_type]).reshape(info.shape).copy()
            else:
                a = np.array(g.to_float32(name))
            t = torch.from_numpy(a).to(device)
            flat[name] = t.to(dtype) if dtype is not None else t
        md = dict(g.metadata)
    return _unflatten(flat), md


def save_optimizer(path, opt) -> None:
    """Checkpoint an ggml_tpu_torch.opt.Optimizer (params, momenta, counters)."""
    st = opt.state_dict()
    arrays = {k: v for k, v in st.items() if k not in ("t", "i_acc")}
    save_params(path, arrays, metadata={
        "opt.t": int(st["t"]),
        "opt.i_acc": int(st["i_acc"]),
        "opt.loss_type": opt.loss_type,
        "opt.period": opt.opt_period,
    })


def load_optimizer(path, opt) -> None:
    """Restore what save_optimizer wrote into an Optimizer of the same
    structure, on its device and in its state's types (training resumes
    exactly where it stopped)."""
    tree, md = load_params(path, device=opt.device)
    ref = opt.state_dict()

    def cast_like(saved, like):
        if isinstance(like, dict):
            if set(saved) != set(like):
                raise ValueError(f"{path}: the checkpoint holds {sorted(saved)}, the optimizer {sorted(like)}")
            return {k: cast_like(saved[k], v) for k, v in like.items()}
        return saved.to(like.dtype).reshape(like.shape)

    state = {key: cast_like(tree[key], ref[key]) for key in ("params", "m", "v", "g_acc")}
    for key in ("t", "i_acc"):
        state[key] = torch.tensor(int(md[f"opt.{key}"]), dtype=torch.int32, device=opt.device)
    opt.load_state_dict(state)


def latest_checkpoint(ckpt_dir, prefix: str = "step"):
    """The newest readable checkpoint among '<prefix>NNN.gguf' files in a
    directory: a file that does not parse (truncated or corrupt) is skipped,
    so the previous intact one is taken.  Returns (path, step) or (None, -1)."""
    best, best_step = None, -1
    for p in pathlib.Path(ckpt_dir).glob(f"{prefix}*.gguf"):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)\.gguf", p.name)
        if not m or int(m.group(1)) <= best_step:
            continue
        try:
            GGUFFile(p).close()
        except Exception:
            continue  # truncated or corrupt: fall back
        best, best_step = p, int(m.group(1))
    return best, best_step
