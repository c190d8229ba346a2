"""Attention over the unified KV cell cache (port of
``llama_kotlin_tpu/ops/attention.py``, llama family).

Each query token carries (pos, seq) and each cache cell (pos, seq-bitmask);
visibility is computed on the device from that metadata:

    visible[t, c] = (cell_seq[c] >> token_seq[t]) & 1
                    and cell_pos[c] >= 0 and cell_pos[c] <= token_pos[t]

The forward pass attends through kernel 3 (``ops/cuda/flash.py::
flash_attention``) or kernel 9 (``ops/cuda/flash_stacked.py``), which take
CPU tensors to their plain versions; ``attention_reference`` is the plain
masked softmax those are built on, and ``cache_attention_reference`` the
JAX package's route over a bf16, int8 or packed int4 cache (dequantize,
then the reference).
"""

from __future__ import annotations

from typing import Optional

import torch

from llama_kotlin_tpu_torch.runtime.kv_cache import dequantize_cache_layer

NEG_INF = -1e30


def visibility_mask(token_pos: torch.Tensor, token_seq: torch.Tensor,
                    cell_pos: torch.Tensor, cell_seq: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Boolean [nt, cells] visibility from cache-cell metadata; window > 0
    keeps only the cells fewer than `window` positions back (gemma2's
    sliding window, JAX ``ops/attention.py:49-61``)."""
    seq_ok = ((cell_seq[None, :] >> token_seq[:, None]) & 1) != 0
    vis = seq_ok & (cell_pos[None, :] >= 0)
    if causal:
        vis = vis & (cell_pos[None, :] <= token_pos[:, None])
    if window > 0:
        vis = vis & (token_pos[:, None] - cell_pos[None, :] < window)
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


def cache_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor, *, scale: float, logit_softcap: float = 0.0,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              layer: Optional[int] = None, kv_bits: int = 8) -> torch.Tensor:
    """The plain route over the cell cache: the layer's visible prefix
    (mask [nt, n_vis]), dequantized to f32 when k_scale/v_scale mark a
    quantized cache (int8 codes, or packed int4 codes [.., D/2] with
    kv_bits=4), then attention_reference.  k/v [L, KV, cells, D] with
    `layer` (scales [L, KV, cells]), or [KV, cells, D] without."""
    n_vis = mask.shape[1]
    if layer is not None:
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    k, v = k[:, :n_vis], v[:, :n_vis]
    if k_scale is not None:
        k = dequantize_cache_layer(k, k_scale[:, :n_vis], bits=kv_bits)
        v = dequantize_cache_layer(v, v_scale[:, :n_vis], bits=kv_bits)
    return attention_reference(q, k, v, mask, scale=scale, logit_softcap=logit_softcap)

