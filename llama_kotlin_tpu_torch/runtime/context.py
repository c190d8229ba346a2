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
``Timings`` keeps the host time of each decode call, as JAX's does (the
call returns before the device finishes; a caller that reads the logits
waits for it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.runtime.batch import Batch, bucket_size
from llama_kotlin_tpu_torch.runtime.kv_cache import CellMetadata, KVCache, apply_k_shift

# a one-token step runs at one row: the port compiles nothing per shape, so
# padding it to 8 rows (as JAX does to bound its compiled variants) would
# only move it onto another kernel route than generate_loop's one-row steps
DEFAULT_BUCKETS = (1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclass
class Timings:
    """Parity: llama_timings (llama.h:396); the JAX package's Timings."""

    t_start: float = field(default_factory=time.perf_counter)
    t_load_ms: float = 0.0
    t_p_eval_ms: float = 0.0  # prompt (multi-token ubatch) time
    t_eval_ms: float = 0.0  # single-token decode time
    n_p_eval: int = 0
    n_eval: int = 0

    def yaml(self) -> str:
        """YAML timing dump (parity: llama_dump_timing_info_yaml)."""
        d = self.summary()
        return "\n".join(f"{k}: {v}" for k, v in d.items()) + "\n"

    def summary(self) -> dict:
        return {
            "load_ms": round(self.t_load_ms, 2),
            "prompt_eval_ms": round(self.t_p_eval_ms, 2),
            "prompt_tokens": self.n_p_eval,
            "prompt_tps": round(self.n_p_eval / (self.t_p_eval_ms / 1e3), 2)
            if self.t_p_eval_ms
            else 0.0,
            "eval_ms": round(self.t_eval_ms, 2),
            "eval_tokens": self.n_eval,
            "eval_tps": round(self.n_eval / (self.t_eval_ms / 1e3), 2)
            if self.t_eval_ms
            else 0.0,
        }


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
                                    cfg.head_dim, device=self.device, quantized=kv_quant,
                                    v_head_dim=cfg.v_head_dim)
        # used-prefix attention bucketing: attend over a bucketed prefix of
        # the cells instead of every allocated cell
        self.vis_buckets: tuple[int, ...] = (n_cells,)
        if n_cells % 128 == 0:
            vb = [b for b in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
                  if b < n_cells and n_cells % b == 0]
            self.vis_buckets = tuple(vb) + (n_cells,)
        self.timings = Timings()
        self._logits: Optional[torch.Tensor] = None
        self._logits_rows: Optional[np.ndarray] = None
        self._embd: list[torch.Tensor] = []  # per-ubatch final-norm rows

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
        all_logits, all_rows, all_embd = [], [], []
        for base, ub in zip(range(0, len(batch), self.n_ubatch),
                            batch.split(self.n_ubatch)):
            rc = self._decode_ubatch(ub, all_logits, all_rows, all_embd, row_base=base)
            if rc != 0:
                return rc
        if all_logits:
            self._logits = torch.cat(all_logits, dim=0)
            self._logits_rows = np.concatenate(all_rows)
            self._embd = all_embd
        return 0

    def _decode_ubatch(self, ub: Batch, all_logits: list, all_rows: list,
                       all_embd: list, row_base: int = 0) -> int:
        nt = len(ub)
        t0 = time.perf_counter()
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
        logits, embd = llama_model.forward(
            self.params, self.cfg,
            *(torch.from_numpy(a).to(dev) for a in (tokens, pos, seq, slot_arr)),
            self.cache, *self.meta.device_view(self.n_vis_for_span(), dev),
            torch.from_numpy(out_ids).to(dev))
        if len(out_rows):
            all_logits.append(logits[:len(out_rows)])
            all_rows.append(out_rows + row_base)
            all_embd.append(embd[:len(out_rows)])
        dt = (time.perf_counter() - t0) * 1e3
        if nt == 1:
            self.timings.t_eval_ms += dt
            self.timings.n_eval += 1
        else:
            self.timings.t_p_eval_ms += dt
            self.timings.n_p_eval += nt
        return 0

    def logits_device(self) -> torch.Tensor:
        """The last decode's requested logits rows, left on the device."""
        if self._logits is None:
            raise RuntimeError("no logits: call decode with output flags first")
        return self._logits

    def get_logits(self) -> np.ndarray:
        """All logits rows requested by the last decode, [n_out, vocab]."""
        return self.logits_device().cpu().numpy()

    def get_topk(self, k: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Top-k (values, token ids) of the last decode's logits rows,
        computed on the device: [n_out, k] comes back instead of
        [n_out, vocab]."""
        v, i = torch.topk(self.logits_device(), k, dim=-1)
        return v.cpu().numpy(), i.to(torch.int32).cpu().numpy()

    def get_logits_ith(self, i: int = -1) -> np.ndarray:
        return self.get_logits()[i]

    def get_embeddings(self, pooling: str = "last") -> np.ndarray:
        """Final-norm hidden states of the last decode's output rows
        (parity: llama_get_embeddings + pooling NONE/MEAN/LAST/CLS).
        pooling: "none" -> [n_out, n_embd]; "mean"/"last"/"cls" -> [n_embd]."""
        if not self._embd:
            raise RuntimeError("no embeddings: decode with output flags first")
        e = torch.cat(self._embd, dim=0).cpu().numpy()
        if pooling == "none":
            return e
        if pooling == "mean":
            return e.mean(axis=0)
        if pooling == "cls":
            return e[0]
        return e[-1]

    def sample_rows_device(self, rows, sp, spv, pos, masks=None,
                           pen_window=None) -> np.ndarray:
        """Sample token ids from the last decode's logits rows on the
        device: the host grammar mask goes up packed to vocab/8 bytes
        (``np.packbits``, little bit order) and only the [n] ids come back,
        instead of the [n, vocab] f32 logits the host sampler needs.

        rows: logits-row indices.  masks: bool [n, vocab] (grammar-legal
        tokens) or None.  pen_window: [n, last_n] recent tokens (-1 =
        empty) when sp enables penalties.  spv/pos: per-row sampling arrays
        (temp, top_k, top_p, min_p, seed) and absolute positions, with
        generate_loop's reproducibility contract."""
        from llama_kotlin_tpu_torch.runtime.generate import sample_rows

        dev = self.device
        logits = self.logits_device()
        n = len(rows)
        to_dev = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev)  # noqa: E731
        use_mask = masks is not None
        mask_bits = to_dev(np.packbits(np.asarray(masks, bool), axis=-1, bitorder="little")
                           if use_mask else np.zeros((n, 1), np.uint8), torch.uint8)
        use_pen = pen_window is not None
        pw = to_dev(pen_window if use_pen else np.zeros((n, 1), np.int32), torch.int64)
        spv_t = {k: to_dev(v, torch.int64 if k in ("top_k", "seed") else torch.float32)
                 for k, v in spv.items()}
        ids = sample_rows(logits, to_dev(np.asarray(rows, np.int64), torch.int64), mask_bits,
                          pw, spv_t, to_dev(np.asarray(pos, np.int64), torch.int64), sp,
                          use_mask, use_pen)
        return ids.cpu().numpy()

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
