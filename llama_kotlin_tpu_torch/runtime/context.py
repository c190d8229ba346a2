"""LlamaContext: runs prefill and decode steps (port of
``llama_kotlin_tpu/runtime/context.py``).

Per ubatch: the host finds cache slots and commits the metadata, pads the
token arrays to a bucket size, picks the attended cell prefix from the
visibility buckets, and runs the forward pass on the device.  Logits stay
on the device until ``get_logits`` reads them.

As in the JAX package, the context stacks the layers by default
(``prefer_unrolled=False``) when they are uniform, and keeps them unrolled
otherwise; ``kv_quant`` picks the cache: False (bf16), True/"q8_0" (int8
codes with per-row scales) or "q4_0" (packed int4 codes with per-row
scales).  The sequence operations edit the cell metadata; ``seq_add`` and
``seq_div`` also rotate the cached K rows by each cell's position change
(``apply_k_shift``), as the CLI's context shift and self-extend need.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.runtime.batch import Batch, bucket_size
from llama_kotlin_tpu_torch.runtime.kv_cache import CellMetadata, KVCache, apply_k_shift

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


class LlamaContext:
    """Holds the KV cache and runs ubatch steps for one loaded model."""

    def __init__(self, cfg: ModelConfig, params: dict, *, n_cells: int = 4096,
                 n_ubatch: int = 512, n_seq_max: int = 32,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 kv_quant=False, prefer_unrolled: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prefer_unrolled = prefer_unrolled
        self.params = self._prepare_params(params)
        self.n_cells = n_cells
        self.n_ubatch = n_ubatch
        self.n_seq_max = n_seq_max
        self.buckets = tuple(sorted({b for b in buckets if b <= n_ubatch} | {n_ubatch}))
        self.meta = CellMetadata(n_cells, max_seqs=n_seq_max)
        # one scratch cell past the real ones receives the padded rows'
        # writes; attention never reads it (n_vis <= n_cells)
        self.cache = KVCache.create(cfg.n_layer, n_cells + 1, cfg.n_head_kv,
                                    cfg.head_dim, device=self.device, quantized=kv_quant)
        # used-prefix attention bucketing: attend over a bucketed prefix of
        # the cells instead of every allocated cell
        self.vis_buckets: tuple[int, ...] = (n_cells,)
        if n_cells % 128 == 0:
            vb = [b for b in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
                  if b < n_cells and n_cells % b == 0]
            self.vis_buckets = tuple(vb) + (n_cells,)
        self._logits: Optional[torch.Tensor] = None
        self._logits_rows: Optional[np.ndarray] = None

    def _prepare_params(self, params: dict) -> dict:
        """Stacked layers unless prefer_unrolled, or the layers are not
        uniform (the JAX package's rule and fallback)."""
        if self.prefer_unrolled:
            return params
        if "layers" in params and llama_model.can_stack(params, self.cfg):
            try:
                return llama_model.stack_layers(params)
            except (ValueError, TypeError):
                pass  # non-uniform layers: keep the unrolled path
        return params

    def n_vis_for_span(self) -> int:
        """Smallest visibility bucket covering every live cell."""
        span = self.meta.used_span()
        return next((b for b in self.vis_buckets if b >= span), self.n_cells)

    def decode(self, batch: Batch) -> int:
        """Process a batch; 0 on success, 1 if the KV cache is full."""
        all_logits, all_rows = [], []
        for base, ub in zip(range(0, len(batch), self.n_ubatch),
                            batch.split(self.n_ubatch)):
            rc = self._decode_ubatch(ub, all_logits, all_rows, row_base=base)
            if rc != 0:
                return rc
        if all_logits:
            self._logits = torch.cat(all_logits, dim=0)
            self._logits_rows = np.concatenate(all_rows)
        return 0

    def _decode_ubatch(self, ub: Batch, all_logits: list, all_rows: list,
                       row_base: int = 0) -> int:
        nt = len(ub)
        slots = self.meta.find_slots(nt)
        if slots is None:
            return 1
        self.meta.commit(slots, ub.pos, ub.seq_id, ub.seq_mask)
        nb = bucket_size(nt, self.buckets)
        tokens = np.zeros(nb, np.int32)
        pos = np.full(nb, -1, np.int32)
        seq = np.full(nb, self.n_seq_max - 1, np.int32)
        slot_arr = np.full(nb, self.n_cells, np.int32)  # scratch cell
        tokens[:nt] = ub.tokens
        pos[:nt] = ub.pos
        seq[:nt] = ub.seq_id
        slot_arr[:nt] = slots
        out_rows = np.nonzero(ub.output)[0].astype(np.int32)
        out_ids = np.zeros(max(1, len(out_rows)), np.int32)
        out_ids[:len(out_rows)] = out_rows
        dev = self.device
        logits, _embd = llama_model.forward(
            self.params, self.cfg,
            *(torch.from_numpy(a).to(dev) for a in (tokens, pos, seq, slot_arr)),
            self.cache, *self.meta.device_view(self.n_vis_for_span(), dev),
            torch.from_numpy(out_ids).to(dev))
        if len(out_rows):
            all_logits.append(logits[:len(out_rows)])
            all_rows.append(out_rows + row_base)
        return 0

    def logits_device(self) -> torch.Tensor:
        """The last decode's requested logits rows, left on the device."""
        if self._logits is None:
            raise RuntimeError("no logits: call decode with output flags first")
        return self._logits

    def get_logits(self) -> np.ndarray:
        """All logits rows requested by the last decode, [n_out, vocab]."""
        return self.logits_device().cpu().numpy()

    def seq_rm(self, seq_id: int, p0: int = 0, p1: int = -1) -> None:
        self.meta.seq_rm(seq_id, p0, p1)

    def seq_cp(self, src: int, dst: int, p0: int = 0, p1: int = -1) -> None:
        self.meta.seq_cp(src, dst, p0, p1)

    def seq_keep(self, seq_id: int) -> None:
        self.meta.seq_keep(seq_id)

    def seq_add(self, seq_id: int, p0: int, p1: int, delta: int) -> None:
        self._shift(self.meta.seq_add(seq_id, p0, p1, delta))

    def seq_div(self, seq_id: int, p0: int, p1: int, d: int) -> None:
        self._shift(self.meta.seq_div(seq_id, p0, p1, d))

    def seq_pos_max(self, seq_id: int) -> int:
        return self.meta.seq_pos_max(seq_id)

    def clear(self) -> None:
        self.meta.clear()

    def _shift(self, deltas: np.ndarray) -> None:
        apply_k_shift(self.cache, deltas, self.cfg.rope_params(), self.params.get("rope_freqs"))
