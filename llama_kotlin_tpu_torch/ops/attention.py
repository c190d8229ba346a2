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
then the reference).  Where JAX declines its Pallas kernel by a static
predicate (``flash_declines``: ALiBi, or a head dim outside {64, 128, 192,
256}, ``llama_kotlin_tpu/ops/attention.py:109`` and ``ops/pallas/flash.py:
185-193``), the port takes that plain route on every device, as JAX's XLA
does; ALiBi's bias (``alibi_slopes``) lives only there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llama_kotlin_tpu_torch.runtime.kv_cache import dequantize_cache_layer

NEG_INF = -1e30
FLASH_HEAD_DIMS = (64, 128, 192, 256)  # the head dims JAX's Pallas kernel takes


def flash_declines(head_dim: int, v_head_dim: int, max_alibi_bias: float) -> bool:
    """JAX's static refusal of its flash kernel (``ops/attention.py:109``,
    ``ops/pallas/flash.py:185-193``): ALiBi, or a K or V head dim outside
    FLASH_HEAD_DIMS (phi3's 96).  The forward then attends by
    cache_attention_reference, plain torch ops on every device."""
    return (max_alibi_bias > 0 or head_dim not in FLASH_HEAD_DIMS
            or v_head_dim not in FLASH_HEAD_DIMS)


def alibi_slopes(n_head: int, max_bias: float, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [n_head] f32, ggml's soft_max_ext schedule
    (JAX ``ops/attention.py:33-46``): heads below the largest power of two
    n0 get m0^(h+1), the rest m1^(2(h - n0) + 1)."""
    n0 = 2 ** math.floor(math.log2(n_head))
    m0 = 2.0 ** (-max_bias / n0)
    m1 = 2.0 ** (-max_bias / 2.0 / n0)
    heads = torch.arange(n_head, device=device)
    lo = m0 ** (heads + 1).to(torch.float32)
    hi = m1 ** (2 * (heads - n0) + 1).to(torch.float32)
    return torch.where(heads < n0, lo, hi).to(torch.float32)


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
                        mask: torch.Tensor, *, scale: float, logit_softcap: float = 0.0,
                        alibi: Optional[torch.Tensor] = None,
                        token_pos: Optional[torch.Tensor] = None,
                        cell_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [nt, H, D], k/v [KV, cells, D], mask [nt, cells] -> [nt, H, D] in
    q's dtype; scores in f32, fully masked rows give 0.  alibi [H] slopes
    add -slope |token_pos - cell_pos| to each score (JAX ``:222-227``)."""
    nt, n_head, head_dim = q.shape
    n_kv = k_cache.shape[0]
    rep = n_head // n_kv
    qg = q.to(torch.float32).reshape(nt, n_kv, rep, head_dim)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("tgrd,gcd->tgrc", qg, kf) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if alibi is not None:
        bias = -(token_pos[:, None] - cell_pos[None, :]).abs().to(torch.float32)
        scores = scores + alibi.reshape(1, n_kv, rep, 1) * bias[:, None, None, :]
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
                              layer: Optional[int] = None, kv_bits: int = 8,
                              alibi: Optional[torch.Tensor] = None,
                              token_pos: Optional[torch.Tensor] = None,
                              cell_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain route over the cell cache: the layer's visible prefix
    (mask [nt, n_vis]), dequantized to f32 when k_scale/v_scale mark a
    quantized cache (int8 codes, or packed int4 codes [.., D/2] with
    kv_bits=4), then attention_reference (with ALiBi where alibi slopes
    come, over token_pos and the n_vis cells' cell_pos).  k/v [L, KV,
    cells, D] with `layer` (scales [L, KV, cells]), or [KV, cells, D]
    without."""
    n_vis = mask.shape[1]
    if layer is not None:
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    k, v = k[:, :n_vis], v[:, :n_vis]
    if k_scale is not None:
        k = dequantize_cache_layer(k, k_scale[:, :n_vis], bits=kv_bits)
        v = dequantize_cache_layer(v, v_scale[:, :n_vis], bits=kv_bits)
    return attention_reference(q, k, v, mask, scale=scale, logit_softcap=logit_softcap,
                               alibi=alibi, token_pos=token_pos, cell_pos=cell_pos)

