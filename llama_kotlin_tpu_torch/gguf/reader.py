"""GGUF v1-v3 reader (port of ``llama_kotlin_tpu/gguf/reader.py``).

Parses the container (magic, version, KV metadata, tensor index) and
memory-maps the data section.  ``tensor_data`` hands a tensor's wire bytes
to torch without a copy: ``torch.frombuffer`` over the mapped slice, which
the caller moves to its device with ``.to(device)``.

Wire layout (little-endian):
  u32 magic "GGUF" | u32 version | u64 n_tensors | u64 n_kv
  n_kv * { string key; u32 vtype; value }
  n_tensors * { string name; u32 n_dims; u64 dims[n_dims]; u32 ggml_type; u64 offset }
  padding to `general.alignment` (default 32)
  tensor data (offsets relative to the data section, aligned)

v1 uses u32 for all the u64 counts and lengths above.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType, row_byte_size

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
DEFAULT_ALIGNMENT = 32


class GGUFValueType:
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


SCALAR_FMT = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8, GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16, GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32, GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32, GGUFValueType.BOOL: np.bool_,
    GGUFValueType.UINT64: np.uint64, GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # ggml ne order (ne[0] innermost)
    ggml_type: GGMLQuantType
    offset: int  # relative to the data section
    n_bytes: int = 0

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def np_shape(self) -> tuple[int, ...]:
        """Row-major shape: ggml ne=(cols, rows, ...) -> (..., rows, cols)."""
        return tuple(reversed(self.shape))


class _Cursor:
    """Sequential little-endian reader over a bytes-like object."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return bytes(b)

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def scalar(self, vtype: int):
        fmt = SCALAR_FMT[vtype]
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]


class GGUFFile:
    """A parsed GGUF file with memory-mapped tensor data.

    ``metadata`` maps key -> python value (numeric arrays become numpy
    arrays, others lists); ``tensors`` maps name -> GGUFTensorInfo."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        # copy-on-write: torch.frombuffer wants a writable buffer; pages are
        # shared with the file until written, and nothing writes them
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self.alignment = DEFAULT_ALIGNMENT
        self.version = 0
        self.data_offset = 0
        self._parse()

    def _read_len(self, c: _Cursor) -> int:
        return c.u32() if self.version == 1 else c.u64()

    def _read_string(self, c: _Cursor) -> str:
        return c.read(self._read_len(c)).decode("utf-8", errors="replace")

    def _read_value(self, c: _Cursor, vtype: int):
        if vtype == GGUFValueType.STRING:
            return self._read_string(c)
        if vtype == GGUFValueType.ARRAY:
            itype = c.u32()
            n = self._read_len(c)
            if itype in SCALAR_NP and itype != GGUFValueType.BOOL:
                dt = np.dtype(SCALAR_NP[itype]).newbyteorder("<")
                return np.frombuffer(c.read(n * dt.itemsize), dtype=dt)
            return [self._read_value(c, itype) for _ in range(n)]
        return c.scalar(vtype)

    def _parse(self) -> None:
        c = _Cursor(self._mm)
        if c.u32() != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        self.version = c.u32()
        if self.version not in (1, 2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._read_len(c)
        n_kv = self._read_len(c)
        for _ in range(n_kv):
            key = self._read_string(c)
            self.metadata[key] = self._read_value(c, c.u32())
        align = self.metadata.get("general.alignment")
        if align:
            self.alignment = int(align)
        for _ in range(n_tensors):
            name = self._read_string(c)
            dims = tuple(self._read_len(c) for _ in range(c.u32()))
            info = GGUFTensorInfo(name=name, shape=dims, ggml_type=GGMLQuantType(c.u32()),
                                  offset=c.u64())
            info.n_bytes = tensor_nbytes(info.shape, info.ggml_type)
            self.tensors[name] = info
        self.data_offset = (c.pos + self.alignment - 1) // self.alignment * self.alignment

    def tensor_data(self, name: str) -> torch.Tensor:
        """A tensor's wire bytes as a uint8 CPU tensor over the mapping (no
        copy); ``.to(device)`` moves them."""
        info = self.tensors[name]
        return torch.frombuffer(self._mm, dtype=torch.uint8, count=info.n_bytes,
                                offset=self.data_offset + info.offset)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass  # tensors over the mapping are alive; it is freed with them
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self) -> str:
        return (f"GGUFFile({self.path.name!r}, v{self.version}, "
                f"{len(self.metadata)} kv, {len(self.tensors)} tensors)")


def tensor_nbytes(ne: tuple[int, ...], qtype: GGMLQuantType) -> int:
    """Wire bytes of a tensor: blocks run along ne[0], the innermost dim."""
    ne0 = ne[0] if ne else 1
    n = 1
    for d in ne:
        n *= d
    return n // max(ne0, 1) * row_byte_size(ne0, qtype)
