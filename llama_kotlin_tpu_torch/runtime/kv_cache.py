"""Unified multi-sequence KV cell cache (port of
``llama_kotlin_tpu/runtime/kv_cache.py``, the bf16 cache).

- Device side: dense K/V tensors [n_layer, n_kv_head, cells, head_dim],
  head-major, which is what the flash kernel reads.  The forward pass
  writes new rows IN PLACE (``index_copy_``), where the JAX package threads
  a new array through the step.
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
    k: torch.Tensor  # [n_layer, n_kv_head, cells, head_dim]
    v: torch.Tensor

    @staticmethod
    def create(n_layer: int, cells: int, n_kv_head: int, head_dim: int,
               device: DeviceLike = None) -> "KVCache":
        """A zeroed bf16 cache (the flash kernel reads bf16 K/V only)."""
        dev = resolve_device(device)
        shape = (n_layer, n_kv_head, cells, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                       v=torch.zeros(shape, dtype=torch.bfloat16, device=dev))


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
