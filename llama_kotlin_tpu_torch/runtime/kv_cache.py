"""Unified multi-sequence KV cell cache (port of
``llama_kotlin_tpu/runtime/kv_cache.py``: the bf16, int8 and packed int4
caches and the K-shift).

- Device side: dense K/V tensors [n_layer, n_kv_head, cells, head_dim],
  head-major, which is what the flash kernels read: bf16 rows; int8 codes
  (``quantized="q8_0"``); or packed int4 codes, two a byte, in
  [n_layer, n_kv_head, cells, head_dim / 2] uint8 (``quantized="q4_0"``,
  the JAX package's byte layout, so that state blobs cross-load).  Both
  quantized caches keep one f32 scale per cached row in
  [n_layer, n_kv_head, cells] planes.  The forward pass writes new rows IN
  PLACE (``index_copy_``) and ``apply_k_shift`` rotates K in place, where
  the JAX package threads a new array through.
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
from llama_kotlin_tpu_torch.ops.rope import (ROPE_TYPE_NEOX, ROPE_TYPE_NONE, RopeParams,
                                             rope_cos_sin)


@dataclass
class KVCache:
    # [n_layer, n_kv_head, cells, head_dim] bf16 or int8 codes, or
    # [.., head_dim / 2] uint8 packed int4 codes
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [n_layer, n_kv_head, cells] f32
    v_scale: Optional[torch.Tensor] = None
    kv_bits: int = 8  # 4 for the packed cache; 8 for the bf16 cache too, as in JAX

    @property
    def n_cells(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(n_layer: int, cells: int, n_kv_head: int, head_dim: int,
               device: DeviceLike = None, quantized=False) -> "KVCache":
        """A zeroed cache.  quantized: False = bf16 rows; True or "q8_0" =
        int8 codes with per-row f32 scales; "q4_0" = packed int4 codes
        (quantize_rows_q4) with per-row f32 scales, half the bytes of int8."""
        if quantized not in (False, True, "q8_0", "q4_0"):
            raise ValueError(f"unknown KV cache type {quantized!r}")
        dev = resolve_device(device)
        bits = 4 if quantized == "q4_0" else 8
        shape = (n_layer, n_kv_head, cells, head_dim // (8 // bits))
        dtype = {4: torch.uint8, 8: torch.int8}[bits] if quantized else torch.bfloat16
        planes = (lambda: torch.zeros(shape[:3], dtype=torch.float32, device=dev)) \
            if quantized else (lambda: None)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev),
                       k_scale=planes(), v_scale=planes(), kv_bits=bits)


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


def quantize_rows_q4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 quantization over the last axis, packed two
    codes a byte: (packed uint8 [..., d/2], scale f32 [...]), bit for bit
    the JAX package's.  Byte j holds dim j as code + 8 in the low nibble and
    dim j + d/2 as a two's-complement code in the high nibble.  Tensor
    divisors and half-to-even rounding, as in quantize_rows."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 7.0)
    live = scale > 0
    safe = torch.where(live, scale, torch.ones_like(scale))
    inv = torch.where(live, torch.ones_like(scale) / safe, torch.zeros_like(scale))
    codes = torch.clamp(torch.round(xf * inv[..., None]), -7, 7).to(torch.int32)
    lo = (codes[..., : d // 2] + 8).to(torch.uint8)
    hi = ((codes[..., d // 2:] & 0xF) << 4).to(torch.uint8)
    return lo | hi, scale


def unpack_q4_rows(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [..., d/2] -> codes f32 [..., d] (the inverse nibble map)."""
    lo = (packed & 0x0F).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1).to(torch.float32)


def dequantize_cache_layer(codes: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.float32, bits: int = 8) -> torch.Tensor:
    """codes [KV, cells, D] int8 (or [.., D/2] packed uint8 when bits=4) +
    scale [KV, cells] -> float [KV, cells, D]."""
    cf = unpack_q4_rows(codes) if bits == 4 else codes.to(torch.float32)
    return (cf * scale[..., None]).to(dtype)


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

    @property
    def used(self) -> int:
        return int((self.pos >= 0).sum())

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

    def seq_keep(self, seq_id: int) -> None:
        self.seq &= self._bit(seq_id)
        self.pos[self.seq == 0] = -1

    def seq_add(self, seq_id: int, p0: int, p1: int, delta: int) -> np.ndarray:
        """Shift positions; returns per-cell deltas for the K rotation.
        Cells shifted below position 0 are dropped."""
        m = self._range_mask(seq_id, p0, p1)
        deltas = np.zeros(self.n_cells, np.int32)
        deltas[m] = delta
        self.pos[m] += delta
        drop = m & (self.pos < 0)
        self.pos[drop] = -1
        self.seq[drop] = 0
        return deltas

    def seq_div(self, seq_id: int, p0: int, p1: int, d: int) -> np.ndarray:
        """Integer-divide positions by d; returns per-cell deltas."""
        m = self._range_mask(seq_id, p0, p1)
        deltas = np.zeros(self.n_cells, np.int32)
        new_pos = self.pos[m] // d
        deltas[m] = new_pos - self.pos[m]
        self.pos[m] = new_pos
        return deltas

    def seq_pos_max(self, seq_id: int) -> int:
        has = ((self.seq >> seq_id) & 1) == 1
        return int(self.pos[has].max()) if has.any() else -1

    def clear(self) -> None:
        self.pos[:] = -1
        self.seq[:] = 0
        self._next = 0


def _rotate_k(k: torch.Tensor, deltas: torch.Tensor, rope: RopeParams,
              freq_factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate cached (already roped) K [n_layer, n_kv_head, cells, head_dim]
    by per-cell position deltas [cells]; cells whose delta is 0 keep their
    rows exactly.  Returns a new tensor of k's dtype."""
    cos, sin = rope_cos_sin(deltas, rope, freq_factors)  # [cells, n_rot/2]
    cos, sin = cos[None, None], sin[None, None]
    rot = k[..., :rope.n_rot].to(torch.float32)
    rest = k[..., rope.n_rot:]
    if rope.rope_type == ROPE_TYPE_NEOX:
        half = rope.n_rot // 2
        a, b = rot[..., :half], rot[..., half:]
        out = torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)
    else:  # NORM: adjacent pairs
        a, b = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(rot.shape)
    out = torch.where((deltas != 0)[None, None, :, None], out, rot).to(k.dtype)
    return torch.cat([out, rest], dim=-1) if rest.numel() else out


def apply_k_shift(cache: KVCache, deltas: np.ndarray, rope: RopeParams,
                  freq_factors: Optional[torch.Tensor] = None) -> KVCache:
    """The device side of seq_add/seq_div: rotate every cached K row by its
    cell's position delta, IN PLACE (JAX returns a new cache; the result is
    the same).  A quantized cache (int8 or int4) is dequantized, rotated and
    requantized whole, since a rotation changes each row's amax.  The
    deltas are zero-padded over the context's scratch cell.  Plain torch
    ops: JAX runs this as XLA, with no Pallas kernel.  Returns the cache."""
    if rope.rope_type == ROPE_TYPE_NONE or not np.any(deltas):
        return cache
    # a copy: the caller's buffer may be the metadata's own, mutated later
    deltas = np.array(deltas, np.int32, copy=True)
    if deltas.shape[0] < cache.n_cells:
        deltas = np.pad(deltas, (0, cache.n_cells - deltas.shape[0]))
    dt = torch.from_numpy(deltas).to(cache.k.device)
    if cache.quantized:
        kf = dequantize_cache_layer(cache.k, cache.k_scale, bits=cache.kv_bits)
        qr = quantize_rows_q4 if cache.kv_bits == 4 else quantize_rows
        codes, scale = qr(_rotate_k(kf, dt, rope, freq_factors))
        cache.k.copy_(codes)
        cache.k_scale.copy_(scale)
    else:
        cache.k.copy_(_rotate_k(cache.k, dt, rope, freq_factors))
    return cache
