"""GGUF v3 reader and writer — the port's own copy of ggml_tpu/gguf.py
(reference: src/gguf.cpp, spec docs/gguf.md).

The reader mmaps the file and exposes tensors as zero-copy numpy views over
the aligned data blob; `to_float32()` dequantizes through
ggml_tpu_torch.quant.reference.  Opening the first shard of a split model
(llama.cpp's gguf-split convention, <prefix>-00001-of-0000N.gguf) merges
the siblings' tensor tables, so every consumer sees one file.  The writer writes F32 and F16 tensors (what
finetuning saves) and blocks of any type already quantized (raw_shape_ne),
byte for byte as the JAX package's writer does.

Tensor shape convention: GGUF stores dims as ne[0..n) with ne[0] the
fastest-moving (contiguous) dimension — the REVERSE of numpy's C-order shape.
`shape_ne` is ggml order and `shape` numpy order.
"""

from __future__ import annotations

import enum
import io
import mmap
import os
import re
import struct
from dataclasses import dataclass

import numpy as np

from .dtypes import GGMLType, row_size
from .quant import reference as qref

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
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
        self._open_shards()

    def _open_shards(self):
        """Merge the tensor tables of a split model's other shards into the
        first shard's (ggml_tpu/gguf.py:178-202): siblings
        <prefix>-0000i-of-0000N.gguf with split.no i - 1; tensor_bytes reads
        each tensor from the shard that holds it."""
        self._shards: dict[str, GGUFFile] = {}
        self._shard_files: list[GGUFFile] = []
        n_split = int(self.metadata.get("split.count", 0) or 0)
        if n_split <= 1 or int(self.metadata.get("split.no", 0)) != 0:
            return
        m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", self.path)
        if m is None:
            raise ValueError(f"{self.path}: split.count={n_split} but the filename does not follow "
                             "<prefix>-00001-of-0000N.gguf")
        prefix, _, total = m.groups()
        for i in range(1, n_split):
            sib_path = f"{prefix}-{i + 1:05d}-of-{total}.gguf"
            sib = GGUFFile(sib_path)
            self._shard_files.append(sib)
            if int(sib.metadata.get("split.no", -1)) != i:
                raise ValueError(f"{sib_path}: unexpected split.no")
            for name, info in sib.tensors.items():
                if name in self.tensors:
                    raise ValueError(f"duplicate tensor {name} in {sib_path}")
                self.tensors[name] = info
                self._shards[name] = sib

    def close(self):
        for sib in getattr(self, "_shard_files", ()):
            sib.close()
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw packed bytes as a zero-copy uint8 view (from the shard that
        holds the tensor)."""
        if name in self._shards:
            return self._shards[name].tensor_bytes(name)
        t = self.tensors[name]
        start = self.data_offset + t.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=t.n_bytes, offset=start)

    def to_float32(self, name: str) -> np.ndarray:
        """Dequantize to float32 in numpy (C-order) shape."""
        t = self.tensors[name]
        return qref.dequantize(self.tensor_bytes(name), t.ggml_type, t.n_elements).reshape(t.shape)


class GGUFWriter:
    """Single-pass GGUF v3 writer (reference: gguf_write_to_file,
    src/gguf.cpp:1303) for F32 and F16 tensors and pre-quantized blocks."""

    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.kv: dict[str, tuple[GGUFValueType, object]] = {}
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_u32("general.alignment", alignment)

    def add_value(self, key, vt: GGUFValueType, val):
        self.kv[key] = (vt, val)

    def add_u32(self, key, val):
        self.add_value(key, GGUFValueType.UINT32, int(val))

    def add_i32(self, key, val):
        self.add_value(key, GGUFValueType.INT32, int(val))

    def add_u64(self, key, val):
        self.add_value(key, GGUFValueType.UINT64, int(val))

    def add_f32(self, key, val):
        self.add_value(key, GGUFValueType.FLOAT32, float(val))

    def add_bool(self, key, val):
        self.add_value(key, GGUFValueType.BOOL, bool(val))

    def add_string(self, key, val):
        self.add_value(key, GGUFValueType.STRING, str(val))

    def add_array(self, key, vals, elem_type: GGUFValueType | None = None):
        if elem_type is None:
            if len(vals) and isinstance(vals[0], str):
                elem_type = GGUFValueType.STRING
            elif len(vals) and isinstance(vals[0], float):
                elem_type = GGUFValueType.FLOAT32
            else:
                elem_type = GGUFValueType.INT32
        self.add_value(key, GGUFValueType.ARRAY, (elem_type, list(vals)))

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: GGMLType | None = None,
                   raw_shape_ne: tuple[int, ...] | None = None):
        """data: numpy array (C order), stored as F32 (the default for f32
        data) or F16; or, with raw_shape_ne (the stored ne, ggml order),
        uint8 blocks of `ggml_type` written as they are."""
        if raw_shape_ne is not None:
            if ggml_type is None:
                raise ValueError("raw blocks need their ggml_type")
            ggml_type = GGMLType(ggml_type)
            ne = tuple(int(d) for d in raw_shape_ne)
            blob = np.ascontiguousarray(data).tobytes()
            want = row_size(ggml_type, ne[0]) * int(np.prod(ne[1:], dtype=np.int64))
            if len(blob) != want:
                raise ValueError(f"{name}: {len(blob)} bytes, {ggml_type.name} {ne} holds {want}")
            self._tensors.append((name, ne, ggml_type, blob))
            return
        if data.dtype == np.uint8:
            raise ValueError("raw byte tensors need raw_shape_ne")
        if ggml_type is None:
            ggml_type = GGMLType.F16 if data.dtype == np.float16 else GGMLType.F32
        ggml_type = GGMLType(ggml_type)
        if ggml_type not in (GGMLType.F32, GGMLType.F16):
            raise NotImplementedError(f"quantizing to {ggml_type.name} is not ported yet (ROADMAP.md)")
        x = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
        blob = (x if ggml_type == GGMLType.F32 else x.astype(np.float16)).tobytes()
        ne = tuple(reversed(data.shape)) if data.ndim else (1,)
        self._tensors.append((name, ne, ggml_type, blob))

    def _write_str(self, out, s: str):
        b = s.encode("utf-8")
        out.write(struct.pack("<Q", len(b)))
        out.write(b)

    def _write_value(self, out, vt: GGUFValueType, val):
        if vt == GGUFValueType.STRING:
            self._write_str(out, val)
        elif vt == GGUFValueType.ARRAY:
            et, vals = val
            out.write(struct.pack("<I", int(et)))
            out.write(struct.pack("<Q", len(vals)))
            if et == GGUFValueType.STRING:
                for v in vals:
                    self._write_str(out, v)
            else:
                fmt, _ = _SCALAR_FMT[et]
                for v in vals:
                    out.write(struct.pack(fmt, v))
        else:
            fmt, _ = _SCALAR_FMT[vt]
            out.write(struct.pack(fmt, val))

    def write(self, path: str | os.PathLike):
        out = io.BytesIO()
        out.write(GGUF_MAGIC)
        out.write(struct.pack("<IQQ", GGUF_VERSION, len(self._tensors), len(self.kv)))
        for key, (vt, val) in self.kv.items():
            self._write_str(out, key)
            out.write(struct.pack("<I", int(vt)))
            self._write_value(out, vt, val)
        pad = lambda n: (-n) % self.alignment
        offset = 0
        for name, ne, ttype, blob in self._tensors:
            self._write_str(out, name)
            out.write(struct.pack("<I", len(ne)))
            for d in ne:
                out.write(struct.pack("<Q", d))
            out.write(struct.pack("<I", int(ttype)))
            out.write(struct.pack("<Q", offset))
            offset += len(blob) + pad(len(blob))
        out.write(b"\x00" * pad(out.tell()))
        with open(path, "wb") as f:
            f.write(out.getvalue())
            for *_, blob in self._tensors:
                f.write(blob)
                f.write(b"\x00" * pad(len(blob)))
