"""Unified multi-sequence KV cell cache (port of
``llama_kotlin_tpu/runtime/kv_cache.py``: the bf16 and the int8 cache).

- Device side: dense K/V tensors [n_layer, n_kv_head, cells, head_dim],
  head-major, which is what the flash kernels read: bf16 rows, or int8 codes
  with one f32 scale per cached row in [n_layer, n_kv_head, cells] planes
  (``quantized="q8_0"``).  The forward pass writes new rows IN PLACE
  (``index_copy_``), where the JAX package threads a new array through the
  step.
- Host side: CellMetadata keeps (pos, seq-bitmask) per cell in numpy with
  the slot allocator and the sequence operations; each step ships two
  small int32 copies to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device


@dataclass
class KVCache:
    k: torch.Tensor  # [n_layer, n_kv_head, cells, head_dim] bf16, or int8 codes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [n_layer, n_kv_head, cells] f32
    v_scale: Optional[torch.Tensor] = None
    kv_bits: int = 8  # 8 for the bf16 cache too, as in the JAX package

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(n_layer: int, cells: int, n_kv_head: int, head_dim: int,
               device: DeviceLike = None, quantized=False) -> "KVCache":
        """A zeroed cache.  quantized: False = bf16 rows; True or "q8_0" =
        int8 codes with per-row f32 scales.  The packed int4 cache ("q4_0")
        is not ported yet (ROADMAP.md, the int4 KV cache item)."""
        if quantized == "q4_0":
            raise NotImplementedError(
                "the q4_0 (packed int4) KV cache is not ported yet: it comes with "
                "kernel 3's packed branch (ROADMAP.md, the int4 KV cache item)")
        if quantized not in (False, True, "q8_0"):
            raise ValueError(f"unknown KV cache type {quantized!r}")
        dev = resolve_device(device)
        shape = (n_layer, n_kv_head, cells, head_dim)
        dtype = torch.int8 if quantized else torch.bfloat16
        planes = (lambda: torch.zeros(shape[:3], dtype=torch.float32, device=dev)) \
            if quantized else (lambda: None)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev),
                       k_scale=planes(), v_scale=planes())


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the last axis: (codes int8
    [..., d], scale f32 [...]), bit for bit the JAX package's.  Both
    divisions take a tensor divisor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can differ in the last bit
    and so change a code on the card only.  torch.round, like jnp.round,
    rounds half to even."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    live = scale > 0
    safe = torch.where(live, scale, torch.ones_like(scale))
    inv = torch.where(live, torch.ones_like(scale) / safe, torch.zeros_like(scale))
    codes = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_cache_layer(codes: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """codes [KV, cells, D] int8 + scale [KV, cells] -> float [KV, cells, D]."""
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


class CellMetadata:
    """Host-side per-cell metadata + slot allocator.

    pos[c] = token position stored in cell c (-1 = empty)
    seq[c] = bitmask of sequence ids the cell belongs to
    """

    def __init__(self, n_cells: int, max_seqs: int = 32):
        self.n_cells = n_cells
        self.max_seqs = max_seqs
        self.pos = np.full(n_cells, -1, np.int32)
        self.seq = np.zeros(n_cells, np.int32)
        self._next = 0  # ring scan pointer

    def used_span(self) -> int:
        """1 + highest live cell index (attention window upper bound)."""
        live = np.nonzero(self.pos >= 0)[0]
        return int(live[-1]) + 1 if live.size else 0

    def device_view(self, n_vis: Optional[int] = None, device: DeviceLike = None):
        """(cell_pos, cell_seq) tensors for a step — always COPIES of the
        live metadata, so a later host mutation cannot reach a step still
        in flight on the device."""
        dev = resolve_device(device)
        n = self.n_cells if n_vis is None else n_vis
        return (torch.from_numpy(self.pos[:n].copy()).to(dev),
                torch.from_numpy(self.seq[:n].copy()).to(dev))

    def find_slots(self, n: int) -> Optional[np.ndarray]:
        """Allocate n cells; returns indices or None if the cache is full."""
        free = np.nonzero(self.pos < 0)[0]
        if free.size < n:
            return None
        order = np.argsort((free - self._next) % self.n_cells)
        slots = free[order[:n]]
        self._next = int((slots[-1] + 1) % self.n_cells)
        return slots.astype(np.int32)

    def commit(self, slots: np.ndarray, pos: np.ndarray, seq_ids: np.ndarray,
               seq_mask: Optional[np.ndarray] = None) -> None:
        self.pos[slots] = pos
        if seq_mask is not None:
            self.seq[slots] = seq_mask.astype(np.int32)
        else:
            self.seq[slots] = (1 << seq_ids.astype(np.int64)).astype(np.int32)

    @staticmethod
    def _bit(seq_id: int) -> np.int32:
        return np.uint32(1 << seq_id).astype(np.int32)

    def _range_mask(self, seq_id: int, p0: int, p1: int) -> np.ndarray:
        if p1 < 0:
            p1 = np.iinfo(np.int32).max
        has = (self.seq >> seq_id) & 1
        return (has == 1) & (self.pos >= p0) & (self.pos < p1)

    def seq_rm(self, seq_id: int, p0: int = 0, p1: int = -1) -> None:
        if seq_id < 0:
            if p1 < 0:
                p1 = np.iinfo(np.int32).max
            m = (self.pos >= p0) & (self.pos < p1)
            self.seq[m] = 0
            self.pos[m] = -1
            return
        m = self._range_mask(seq_id, p0, p1)
        self.seq[m] &= ~self._bit(seq_id)
        self.pos[m & (self.seq == 0)] = -1

    def seq_cp(self, src: int, dst: int, p0: int = 0, p1: int = -1) -> None:
        self.seq[self._range_mask(src, p0, p1)] |= self._bit(dst)

    def seq_pos_max(self, seq_id: int) -> int:
        has = ((self.seq >> seq_id) & 1) == 1
        return int(self.pos[has].max()) if has.any() else -1

    def clear(self) -> None:
        self.pos[:] = -1
        self.seq[:] = 0
        self._next = 0
