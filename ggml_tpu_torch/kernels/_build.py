"""Build and bind the port's CUDA kernels.

The sources under kernels/csrc/ are compiled with nvcc for sm_90a on first
use — never on import, so the CPU tests can import every module on a machine
without nvcc.  Each .cu file becomes an object in its own nvcc process (all
started together), and the objects are linked into one shared library with a
plain C interface, loaded with ctypes.  The library lands in
build/torch_kernels/<hash of sources and flags>/ at the repository root (git
ignores build/), so a changed source builds afresh and an unchanged one is
reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB_NAME = "libggml_tpu_torch_kernels.so"

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
# C entry points: name -> argument types (each returns an int: a cudaError_t,
# or for decode_attn_heads_per_block a count)
_SIGNATURES = {
    "q4k_gemv_qact": [P, P, P, P, P, P, I, P, I, I, I, P],
    "q4k_gemv_rows": [P, P, P, P, P, P, I, P, I, I, I, P],
    "q4k_gemv_i8": [P, P, P, P, P, P, I, P, I, I, P],
    "q4k_matmul": [P, P, P, P, P, P, I, I, P, I, I, I, P, P, P, I, P],
    "q4_gemv": [P, P, P, P, I, P, I, I, I, I, P],
    "q8_gemv": [P, P, P, P, P, P, I, P, I, I, I, I, I, P],
    "q8_matmul": [P, P, P, P, P, P, I, I, I, P, I, I, I, P, P, P, I, P],
    "decode_attn": [P, P, P, P, P, P, P, P, P, I, I, I, I, ctypes.c_float, P],
    "decode_attn_heads_per_block": [I, I],
    "flash_attn_f32": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, P],
    "flash_attn_sm90": [P, P, P, P, L, L, L, L, L, L, L, L, L, P, P, P, P, I, I, I, I, I, I, I, I, F, F, P],
    "flash_split": [P, P, I, I, I, L, L, L, I, P],
    "flash_mask_ranges": [P, P, I, I, P],
    "flash_attn_fwd_lse": [P, P, P, L, L, L, L, L, L, L, L, L, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "flash_attn_bwd_dq": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "flash_attn_bwd_dq_f32": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "flash_attn_bwd_dkv": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "flash_attn_bwd_dkv_f32": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
}

_lib = None
build_log = ""  # nvcc's output of the build this process loaded (ptxas register/spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build only on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this set of sources has not been built yet;
    return the path of the shared library."""
    global build_log
    out_dir = _BUILD_ROOT / _digest()
    lib_path = out_dir / _LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        tmp_lib = Path(tmp) / _LIB_NAME
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp_lib),
                               *(str(obj) for _, obj, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log_path.write_text(build_log)
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
