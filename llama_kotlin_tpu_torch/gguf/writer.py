"""GGUF v3 writer (port of ``llama_kotlin_tpu/gguf/writer.py``).

Takes tensors as raw wire bytes (any type, with the ggml shape) or as
F32/F16 float arrays.  Quantizing floats is the quantize tool's work and
not ported yet: a float array with a quantized type raises.

A tensor may also be given as a function that returns its wire bytes
(``add_tensor_stream``).  ``write`` lays out the header from the declared
sizes, then calls each function in turn and writes its bytes at once, so a
multi-GB model never sits whole in host memory.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Callable

import numpy as np

from llama_kotlin_tpu_torch.gguf.reader import (DEFAULT_ALIGNMENT, GGUF_MAGIC, SCALAR_FMT,
                                                GGUFValueType, tensor_nbytes)
from llama_kotlin_tpu_torch.quant.formats import TYPE_TRAITS, GGMLQuantType


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    return np.ascontiguousarray(data).tobytes()


class GGUFWriter:
    """add_kv / add_tensor / add_tensor_stream, then write(path)."""

    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: list[tuple[str, bytes]] = []
        # (name, ggml ne, type, () -> wire bytes)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLQuantType, Callable]] = []
        self.add_kv("general.alignment", np.uint32(alignment))

    # -- metadata ------------------------------------------------------------

    def _encode_value(self, v: Any) -> bytes:
        if isinstance(v, str):
            return struct.pack("<I", GGUFValueType.STRING) + _pack_string(v)
        if isinstance(v, (bool, np.bool_)):
            return struct.pack("<I?", GGUFValueType.BOOL, bool(v))
        if isinstance(v, np.generic):
            vtype = _NP_TO_VTYPE[v.dtype]
            return struct.pack("<I", vtype) + struct.pack(SCALAR_FMT[vtype], v)
        if isinstance(v, (list, tuple, np.ndarray)):
            return self._encode_array(v)
        if isinstance(v, int):
            vt = (GGUFValueType.INT64 if v < 0 else
                  GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64)
            return struct.pack("<I", vt) + struct.pack(SCALAR_FMT[vt], v)
        if isinstance(v, float):
            return struct.pack("<If", GGUFValueType.FLOAT32, v)
        raise TypeError(f"unsupported GGUF value {type(v)}")

    def _encode_array(self, v) -> bytes:
        if isinstance(v, np.ndarray) and v.dtype in _NP_TO_VTYPE:
            body = v.astype(v.dtype.newbyteorder("<")).tobytes()
            return struct.pack("<IIQ", GGUFValueType.ARRAY, _NP_TO_VTYPE[v.dtype], v.size) + body
        items = list(v)
        if not items:
            return struct.pack("<IIQ", GGUFValueType.ARRAY, GGUFValueType.UINT32, 0)
        if all(isinstance(x, str) for x in items):
            body = b"".join(_pack_string(x) for x in items)
            vt = GGUFValueType.STRING
        elif all(isinstance(x, (int, np.integer)) and not isinstance(x, bool) for x in items):
            body = b"".join(struct.pack("<i", int(x)) for x in items)
            vt = GGUFValueType.INT32
        elif all(isinstance(x, (float, np.floating)) for x in items):
            body = b"".join(struct.pack("<f", float(x)) for x in items)
            vt = GGUFValueType.FLOAT32
        else:
            raise TypeError("mixed-type GGUF arrays unsupported")
        return struct.pack("<IIQ", GGUFValueType.ARRAY, vt, len(items)) + body

    def add_kv(self, key: str, value: Any) -> None:
        self._kv.append((key, self._encode_value(value)))

    # -- tensors -------------------------------------------------------------

    def add_tensor(self, name: str, data, ggml_type: GGMLQuantType | None = None,
                   raw_shape: tuple[int, ...] | None = None) -> None:
        """Add a tensor: uint8 wire bytes with `raw_shape` (ggml ne order,
        innermost first) and `ggml_type`, or a float array [..., rows, cols]
        stored as F32 (default) or F16."""
        if raw_shape is not None:
            if ggml_type is None:
                raise ValueError("wire bytes need their ggml_type")
            blob = _as_bytes(data)
            self.add_tensor_stream(name, raw_shape, ggml_type, lambda: blob)
            return
        ggml_type = GGMLQuantType.F32 if ggml_type is None else GGMLQuantType(ggml_type)
        if TYPE_TRAITS[ggml_type].is_quantized:
            raise NotImplementedError(
                f"{name}: quantizing floats to {ggml_type.name} is not ported yet "
                "(the tools/quantize.py slice); pass wire bytes with raw_shape")
        if ggml_type not in (GGMLQuantType.F32, GGMLQuantType.F16):
            raise NotImplementedError(f"{name}: float tensors are written as F32 or F16")
        arr = np.ascontiguousarray(
            data, np.float32 if ggml_type == GGMLQuantType.F32 else np.float16)
        blob = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        self.add_tensor_stream(name, tuple(reversed(arr.shape)), ggml_type, lambda: blob)

    def add_tensor_stream(self, name: str, raw_shape: tuple[int, ...],
                          ggml_type: GGMLQuantType, produce: Callable[[], Any]) -> None:
        """Add a tensor whose wire bytes `produce()` returns at write time."""
        self._tensors.append((name, tuple(int(d) for d in raw_shape),
                              GGMLQuantType(ggml_type), produce))

    # -- output --------------------------------------------------------------

    def write(self, path: str | Path) -> None:
        align = self.alignment
        header = struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors), len(self._kv))
        kv_block = b"".join(_pack_string(k) + v for k, v in self._kv)
        infos, sizes, offset = [], [], 0
        for name, ne, ttype, _produce in self._tensors:
            nbytes = tensor_nbytes(ne, ttype)
            infos.append(_pack_string(name) + struct.pack("<I", len(ne))
                         + b"".join(struct.pack("<Q", d) for d in ne)
                         + struct.pack("<IQ", int(ttype), offset))
            sizes.append(nbytes)
            offset += nbytes + (-nbytes) % align
        head = header + kv_block + b"".join(infos)
        with open(path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * ((-len(head)) % align))
            for (name, _ne, _t, produce), nbytes in zip(self._tensors, sizes):
                blob = _as_bytes(produce())
                if len(blob) != nbytes:
                    raise ValueError(f"{name}: {len(blob)} wire bytes, expected {nbytes}")
                f.write(blob)
                f.write(b"\x00" * ((-nbytes) % align))
