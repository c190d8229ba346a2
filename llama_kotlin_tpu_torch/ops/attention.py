"""Attention over the unified KV cell cache (port of
``llama_kotlin_tpu/ops/attention.py``, llama family).

Each query token carries (pos, seq) and each cache cell (pos, seq-bitmask);
visibility is computed on the device from that metadata:

    visible[t, c] = (cell_seq[c] >> token_seq[t]) & 1
                    and cell_pos[c] >= 0 and cell_pos[c] <= token_pos[t]

The forward pass attends through kernel 3 (``ops/cuda/flash.py::
flash_attention``, which takes CPU tensors to its plain version);
``attention_reference`` is the plain masked softmax that version is built
on.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def visibility_mask(token_pos: torch.Tensor, token_seq: torch.Tensor,
                    cell_pos: torch.Tensor, cell_seq: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Boolean [nt, cells] visibility from cache-cell metadata."""
    seq_ok = ((cell_seq[None, :] >> token_seq[:, None]) & 1) != 0
    vis = seq_ok & (cell_pos[None, :] >= 0)
    if causal:
        vis = vis & (cell_pos[None, :] <= token_pos[:, None])
    return vis


def attention_reference(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        mask: torch.Tensor, *, scale: float,
                        logit_softcap: float = 0.0) -> torch.Tensor:
    """q [nt, H, D], k/v [KV, cells, D], mask [nt, cells] -> [nt, H, D] in
    q's dtype; scores in f32, fully masked rows give 0."""
    nt, n_head, head_dim = q.shape
    n_kv = k_cache.shape[0]
    rep = n_head // n_kv
    qg = q.to(torch.float32).reshape(nt, n_kv, rep, head_dim)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("tgrd,gcd->tgrc", qg, kf) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    vis = (mask != 0)[:, None, None, :]
    scores = torch.where(vis, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    any_visible = vis.any(dim=-1, keepdim=True)
    probs = torch.where(any_visible, probs, torch.zeros_like(probs))
    out = torch.einsum("tgrc,gcd->tgrd", probs, vf)
    return out.reshape(nt, n_head, v_cache.shape[-1]).to(q.dtype)

