"""Flat token batches (the port's own copy of
``llama_kotlin_tpu/runtime/batch.py``; host numpy, no framework).

A Batch is a flat list of tokens, each with a position, a sequence id and
an output flag.  The context splits it into ubatches bounded by n_ubatch
and pads each to a bucket size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Batch:
    tokens: np.ndarray  # [n] int32
    pos: np.ndarray  # [n] int32
    seq_id: np.ndarray  # [n] int32 — primary seq per token
    output: np.ndarray  # [n] bool — request logits for this token
    seq_mask: np.ndarray | None = None  # [n] int32 bitmask (default 1 << seq_id)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        self.pos = np.asarray(self.pos, np.int32)
        self.seq_id = np.asarray(self.seq_id, np.int32)
        self.output = np.asarray(self.output, bool)
        if self.seq_mask is not None:
            self.seq_mask = np.asarray(self.seq_mask, np.int32)

    def __len__(self) -> int:
        return int(self.tokens.shape[0])

    @staticmethod
    def single(tokens, seq_id: int = 0, pos0: int = 0, logits_last_only: bool = True) -> "Batch":
        """One sequence's tokens at consecutive positions (llama_batch_get_one)."""
        tokens = np.asarray(tokens, np.int32)
        n = tokens.shape[0]
        out = np.zeros(n, bool)
        if logits_last_only:
            out[-1] = True
        else:
            out[:] = True
        return Batch(tokens=tokens, pos=np.arange(pos0, pos0 + n, dtype=np.int32),
                     seq_id=np.full(n, seq_id, np.int32), output=out)

    def split(self, n_ubatch: int) -> list["Batch"]:
        """Split into ubatches of at most n_ubatch tokens (split_simple)."""
        return [
            Batch(self.tokens[i: i + n_ubatch], self.pos[i: i + n_ubatch],
                  self.seq_id[i: i + n_ubatch], self.output[i: i + n_ubatch],
                  None if self.seq_mask is None else self.seq_mask[i: i + n_ubatch])
            for i in range(0, len(self), n_ubatch)
        ]


def bucket_size(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"ubatch of {n} tokens exceeds the largest bucket {buckets[-1]}")
