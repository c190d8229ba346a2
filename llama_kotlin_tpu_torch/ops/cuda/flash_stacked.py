"""Kernel 9: attention over one layer of the stacked cell cache with the
ubatch's fresh K/V rows merged in (``csrc/flash_stacked.cu``, kernel 3's
tensor-core tile in ``csrc/flash_mma.cuh``).

Replaces ``llama_kotlin_tpu/ops/pallas/flash_stacked.py::
flash_attention_stacked``, which the stacked-layer forward pass calls for a
bf16 cache and for an int8 one: q [nt, H, D]; the whole cache
[L, KV, cells, D] with a layer index (int8 codes with [L, KV, cells] f32
scales, or bf16); the fresh rows new_k/new_v [nt, KV, D]; mask_cells
[nt, n_vis] over the cache cells (the caller has masked out the cells the
fresh rows go to) and mask_new [nt, nt] over the fresh rows.  A row that
sees nothing gives 0.  As in JAX, a packed int4 (q4_0) cache is not
kernel 9's (``llama_kotlin_tpu/models/llama.py:569-573``): the stacked
forward attends over it by ``models/llama.py::attend_stacked_plain``, and a
packed cache given here raises.  Head dims 64 and 128, any 1 <= n_vis <=
cells, any nt.  Bound on the H100: bytes (one read of the visible K/V
prefix, its scales and the fresh rows).  Design: kernel 3's bf16
tensor-core tile with its cache splits (dead tiles skipped), plus one
split over the fresh rows, merged in a fixed order.

``flash_attention_stacked`` launches the kernel for CUDA tensors and runs
``flash_attention_stacked_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.attention import attention_reference
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda.flash import ROW_TILE, check_cache, n_splits, tile_mask
from llama_kotlin_tpu_torch.runtime.kv_cache import dequantize_cache_layer

LAUNCHES = 0  # kernel launches made by flash_attention_stacked


def flash_attention_stacked_plain(q, k, v, layer: int, new_k, new_v, mask_cells, mask_new, *,
                                  scale: float, logit_softcap: float = 0.0,
                                  k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version, the JAX stacked path's own route (models/llama.py:
    588-606): the layer's visible prefix, dequantized to f32 for an int8
    cache, then the fresh rows, under the two masks side by side, through
    attention_reference."""
    n_vis = mask_cells.shape[1]
    k_old, v_old = k[layer, :, :n_vis], v[layer, :, :n_vis]
    if k_scale is not None:
        k_old = dequantize_cache_layer(k_old, k_scale[layer, :, :n_vis])
        v_old = dequantize_cache_layer(v_old, v_scale[layer, :, :n_vis])
    k_cat = torch.cat([k_old.to(torch.float32), new_k.transpose(0, 1).to(torch.float32)], dim=1)
    v_cat = torch.cat([v_old.to(torch.float32), new_v.transpose(0, 1).to(torch.float32)], dim=1)
    m_cat = torch.cat([mask_cells != 0, mask_new != 0], dim=1)
    return attention_reference(q, k_cat, v_cat, m_cat, scale=scale, logit_softcap=logit_softcap)


def flash_attention_stacked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layer: int,
                            new_k: torch.Tensor, new_v: torch.Tensor, mask_cells: torch.Tensor,
                            mask_new: torch.Tensor, *, scale: float, logit_softcap: float = 0.0,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [nt, H, D] bf16; k/v [L, KV, cells, D] bf16, or int8 codes with
    k_scale/v_scale [L, KV, cells] f32; new_k/new_v [nt, KV, D] bf16;
    mask_cells [nt, n_vis] (any n_vis up to cells) and mask_new [nt, nt],
    bool or int8 -> [nt, H, D] bf16."""
    global LAUNCHES
    require(k.dtype != torch.uint8,
            "kernel 9 takes bf16 and int8 caches only, as in JAX: a packed int4 (q4_0) "
            "cache attends by models/llama.py::attend_stacked_plain")
    require(k.dim() == 4 and k.shape == v.shape, "k/v are the whole [L, KV, cells, D] cache")
    require((k_scale is None) == (v_scale is None), "k_scale and v_scale come together")
    nt, H, D = q.shape
    _, KV, cells, _ = k.shape
    n_vis = mask_cells.shape[1]
    require(k.shape[-1] == D and H % KV == 0, "q does not fit the cache")
    require(new_k.shape == new_v.shape == (nt, KV, D), "fresh rows are [nt, KV, D]")
    require(mask_cells.shape[0] == nt and n_vis <= cells, "mask_cells does not fit")
    require(mask_new.shape == (nt, nt), "mask_new is [nt, nt]")
    if not is_cuda(q):
        return flash_attention_stacked_plain(q, k, v, layer, new_k, new_v, mask_cells, mask_new,
                                             scale=scale, logit_softcap=logit_softcap,
                                             k_scale=k_scale, v_scale=v_scale)
    check_cache(q, k, v, n_vis, layer, k_scale, v_scale)
    require(new_k.dtype == new_v.dtype == torch.bfloat16, "fresh rows are bf16")
    require(all(is_cuda(t) for t in (new_k, new_v, mask_cells, mask_new)), "inputs on the card")
    q, new_k, new_v = q.contiguous(), new_k.contiguous(), new_v.contiguous()
    require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0, "cache not 16-byte aligned")
    m_cells = tile_mask(mask_cells)
    m_new = mask_new.to(torch.int8).contiguous()
    rows = (H // KV) * nt
    nsplit = n_splits(KV, rows, n_vis, ROW_TILE)
    part_o = torch.empty((nsplit + 1, KV * rows, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((nsplit + 1, KV * rows, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.check(_build.lib().lk_flash_stacked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scale), _build.ptr(v_scale),
        m_cells.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), m_new.data_ptr(),
        out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), nt, H, KV, D, cells, n_vis,
        m_cells.shape[1], int(layer), float(scale), float(logit_softcap), nsplit, _build.stream()),
        "lk_flash_stacked")
    LAUNCHES += 1
    return out
