"""Greedy multi-step generation (port of
``llama_kotlin_tpu/runtime/generate.py``, greedy path).

The JAX package compiles the decode loop into one ``lax.fori_loop``.  Here
the loop is a Python loop of device work: each step updates the cell
metadata on the device, runs the forward pass and takes the argmax on the
device, so nothing waits for the host until the caller reads the tokens.
(Capturing a step in a CUDA graph is later work.)
"""

from __future__ import annotations

import numpy as np
import torch

from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.kv_cache import KVCache


def generate_loop(params: dict, cfg: ModelConfig, cache: KVCache,
                  cell_pos: torch.Tensor, cell_seq: torch.Tensor,
                  tokens0: torch.Tensor, pos0: torch.Tensor, seq_ids: torch.Tensor,
                  slots: torch.Tensor, n_steps: int):
    """Decode n_steps greedy tokens for B sequences on the device.

    cell_pos/cell_seq [n_vis] hold the metadata before the loop and are
    updated in place; slots [n_steps, B] are pre-allocated cells.  Returns
    (out_tokens [n_steps, B] int32, last logits [B, vocab] f32)."""
    B = tokens0.shape[0]
    dev = tokens0.device
    out_ids = torch.arange(B, dtype=torch.int32, device=dev)
    out = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
    seq_bits = (1 << seq_ids.to(torch.int64)).to(cell_seq.dtype)
    slots = slots.to(torch.long)
    tokens, pos, logits = tokens0, pos0, None
    for i in range(n_steps):
        cell_pos[slots[i]] = pos
        cell_seq[slots[i]] = seq_bits
        logits, _ = llama_model.forward(params, cfg, tokens, pos, seq_ids, slots[i], cache,
                                        cell_pos, cell_seq, out_ids)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        out[i] = tokens
        pos = pos + 1
    return out, logits


def generate(ctx, prompt_tokens, n_steps: int, seq_id: int = 0) -> list[int]:
    """Prefill through the context, then greedy-decode n_steps tokens
    (the first comes from the prefill's logits).  Returns the token ids."""
    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    if ctx.decode(Batch.single(prompt_tokens, seq_id=seq_id)) != 0:
        raise RuntimeError("KV cache full during prefill")
    first = torch.argmax(ctx.logits_device()[:1], dim=-1).to(torch.int32)
    n_prompt = len(prompt_tokens)
    slots_flat = ctx.meta.find_slots(n_steps)
    if slots_flat is None:
        raise RuntimeError("KV cache full for generation")
    pos = np.arange(n_prompt, n_prompt + n_steps, dtype=np.int32)
    ctx.meta.commit(slots_flat, pos, np.full(n_steps, seq_id, np.int32))
    dev = ctx.device
    cell_pos, cell_seq = ctx.meta.device_view(ctx.n_vis_for_span(), dev)
    out, _ = generate_loop(
        ctx.params, ctx.cfg, ctx.cache, cell_pos, cell_seq, first,
        torch.tensor([n_prompt], dtype=torch.int32, device=dev),
        torch.tensor([seq_id], dtype=torch.int32, device=dev),
        torch.from_numpy(slots_flat.reshape(n_steps, 1)).to(dev), n_steps)
    return [int(first[0])] + [int(t) for t in out[:, 0].cpu().numpy()][:-1]
