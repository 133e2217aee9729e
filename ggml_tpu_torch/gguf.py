"""GGUF v3 reader — the port's own copy of the reading half of
ggml_tpu/gguf.py (reference: src/gguf.cpp, spec docs/gguf.md).

The reader mmaps the file and exposes tensors as zero-copy numpy views over
the aligned data blob; `to_float32()` dequantizes through
ggml_tpu_torch.quant.reference (F32/F16/BF16/Q4_K in this slice).  Writing
GGUF files stays with the JAX package's tools.

Tensor shape convention: GGUF stores dims as ne[0..n) with ne[0] the
fastest-moving (contiguous) dimension — the REVERSE of numpy's C-order shape.
`shape_ne` is ggml order and `shape` numpy order.
"""

from __future__ import annotations

import enum
import mmap
import os
import struct
from dataclasses import dataclass

import numpy as np

from .dtypes import GGMLType, row_size
from .quant import reference as qref

GGUF_MAGIC = b"GGUF"
GGUF_DEFAULT_ALIGNMENT = 32  # reference: include/gguf.h:46


class GGUFValueType(enum.IntEnum):
    """reference: enum gguf_type, include/gguf.h:53-68."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<?", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape_ne: tuple[int, ...]  # ggml order: ne[0] contiguous
    ggml_type: GGMLType
    offset: int  # relative to data blob start

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(reversed(self.shape_ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape_ne:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        return row_size(self.ggml_type, self.shape_ne[0]) * (self.n_elements // max(self.shape_ne[0], 1))


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return out

    def scalar(self, fmt, size):
        return struct.unpack(fmt, self.read(size))[0]

    def u32(self):
        return self.scalar("<I", 4)

    def u64(self):
        return self.scalar("<Q", 8)

    def string(self):
        n = self.u64()
        return bytes(self.read(n)).decode("utf-8")

    def value(self, vt: GGUFValueType):
        if vt == GGUFValueType.STRING:
            return self.string()
        if vt == GGUFValueType.ARRAY:
            et = GGUFValueType(self.u32())
            n = self.u64()
            if et == GGUFValueType.STRING:
                return [self.string() for _ in range(n)]
            if et == GGUFValueType.ARRAY:
                raise ValueError("nested arrays are not allowed in GGUF")
            fmt, sz = _SCALAR_FMT[et]
            raw = self.read(n * sz)
            return np.frombuffer(raw, dtype=np.dtype(fmt)).copy()
        fmt, sz = _SCALAR_FMT[vt]
        return self.scalar(fmt, sz)


class GGUFFile:
    """Parsed GGUF file with lazy, zero-copy tensor access."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._f.close()
            raise ValueError(f"not a GGUF file: {self.path}")
        try:
            self._parse()
        except BaseException:
            self.close()
            raise

    def _parse(self):
        r = _Reader(memoryview(self._mm))
        if r.read(4) != GGUF_MAGIC:
            raise ValueError(f"bad GGUF magic in {self.path}")
        self.version = r.u32()
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = r.u64()
        n_kv = r.u64()
        self.metadata: dict[str, object] = {}
        for _ in range(n_kv):
            key = r.string()
            vt = GGUFValueType(r.u32())
            self.metadata[key] = r.value(vt)
        if int(self.metadata.get("split.count", 0) or 0) > 1:
            raise NotImplementedError("multi-shard GGUF files are not ported yet (ROADMAP.md)")
        self.tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = r.string()
            n_dims = r.u32()
            if n_dims > 4:
                raise ValueError(f"tensor {name}: n_dims {n_dims} > 4")
            ne = tuple(r.u64() for _ in range(n_dims))
            ttype = GGMLType(r.u32())
            offset = r.u64()
            if name in self.tensors:
                raise ValueError(f"duplicate tensor name {name}")
            self.tensors[name] = GGUFTensorInfo(name, ne, ttype, offset)
        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        self.data_offset = (r.pos + self.alignment - 1) // self.alignment * self.alignment
        for t in self.tensors.values():
            if t.offset % self.alignment != 0:
                raise ValueError(f"tensor {t.name}: misaligned offset {t.offset}")
            if self.data_offset + t.offset + t.n_bytes > len(self._mm):
                raise ValueError(f"tensor {t.name} extends past end of file")

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw packed bytes as a zero-copy uint8 view."""
        t = self.tensors[name]
        start = self.data_offset + t.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=t.n_bytes, offset=start)

    def to_float32(self, name: str) -> np.ndarray:
        """Dequantize to float32 in numpy (C-order) shape."""
        t = self.tensors[name]
        return qref.dequantize(self.tensor_bytes(name), t.ggml_type, t.n_elements).reshape(t.shape)
