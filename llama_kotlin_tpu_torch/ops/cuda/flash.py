"""Kernel 3: masked GQA flash attention over the bf16 cell cache
(``csrc/flash.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/flash.py::flash_attention`` for a
bf16 cache: q [nt, H, D], the whole cache [L, KV, cells, D] with a layer
index, an int8 mask [nt, n_vis] bounding the cells read, a logit softcap,
and 0 for fully masked rows.  Bound on the H100: bytes (one read of the
visible K/V prefix).  The wrapper splits the visible cells over blocks
(flash-decoding) so a decode step fills the card; see the CUDA source.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.attention import attention_reference
from llama_kotlin_tpu_torch.ops.cuda import _build

HEAD_DIM = 128  # the kernel's head dim
CELL_TILE = 64  # cells per kernel tile; n_vis must be a multiple
ROW_TILE = 16  # query rows per block
TARGET_BLOCKS = 264  # two blocks per SM of an H100
LAUNCHES = 0  # kernel launches made by flash_attention


def flash_attention_plain(q, k, v, mask, *, scale: float, logit_softcap: float = 0.0,
                          layer: Optional[int] = None) -> torch.Tensor:
    """Plain version: attention_reference over the layer's visible prefix."""
    n_vis = mask.shape[1]
    if layer is not None:
        k, v = k[layer], v[layer]
    return attention_reference(q, k[:, :n_vis], v[:, :n_vis], mask, scale=scale,
                               logit_softcap=logit_softcap)


def n_splits(kv: int, rows: int, n_vis: int) -> int:
    """Cell splits per (kv head, row tile): enough blocks to fill the card,
    each split a whole number of cell tiles."""
    tiles = n_vis // CELL_TILE
    blocks = kv * -(-rows // ROW_TILE)
    want = max(1, -(-TARGET_BLOCKS // blocks))
    return max(d for d in range(1, tiles + 1) if tiles % d == 0 and d <= want)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    *, scale: float, logit_softcap: float = 0.0,
                    layer: Optional[int] = None) -> torch.Tensor:
    """q [nt, H, D] bf16; k/v [L, KV, cells, D] with `layer`, or
    [KV, cells, D] without; mask [nt, n_vis] (bool or int8, n_vis a multiple
    of 64) -> [nt, H, D] bf16."""
    global LAUNCHES
    require((layer is not None) == (k.dim() == 4), "layer index iff a 4D cache")
    nt, H, D = q.shape
    KV, cells = k.shape[-3], k.shape[-2]
    n_vis = mask.shape[1]
    require(k.shape == v.shape and k.shape[-1] == D, "k/v/q head dims differ")
    require(H % KV == 0, f"{H} heads over {KV} kv heads")
    require(mask.shape[0] == nt and n_vis <= cells, "mask does not fit q and the cache")
    if not is_cuda(q):
        return flash_attention_plain(q, k, v, mask, scale=scale,
                                     logit_softcap=logit_softcap, layer=layer)
    require(D == HEAD_DIM, f"kernel 3 takes head_dim {HEAD_DIM}, not {D}")
    require(n_vis % CELL_TILE == 0, f"n_vis {n_vis} is not a multiple of {CELL_TILE}")
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16, "kernel 3 takes bf16 q/k/v")
    require(k.is_cuda and v.is_cuda and mask.is_cuda, "q, cache and mask on the card")
    require(k.is_contiguous() and v.is_contiguous(), "cache must be contiguous")
    q = q.contiguous()
    mask_i8 = mask.to(torch.int8).contiguous()
    L = k.shape[0] if layer is not None else 1
    li = layer if layer is not None else 0
    require(0 <= li < L, f"layer {li} out of range")
    rows = (H // KV) * nt
    nsplit = n_splits(KV, rows, n_vis)
    part_o = torch.empty((nsplit, KV * rows, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((nsplit, KV * rows, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.check(_build.lib().lk_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i8.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), nt, H, KV, cells, n_vis, li,
        float(scale), float(logit_softcap), nsplit, _build.stream()), "lk_flash")
    LAUNCHES += 1
    return out
