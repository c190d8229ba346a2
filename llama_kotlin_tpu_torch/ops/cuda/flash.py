"""Kernel 3: masked GQA flash attention over the cell cache
(``csrc/flash.cu``, its bf16 tensor-core tile in ``csrc/flash_mma.cuh``).

Replaces ``llama_kotlin_tpu/ops/pallas/flash.py::flash_attention`` for a
bf16 cache, an int8 cache with per-row f32 scales and a packed int4 cache
(``kv_bits=4``: [.., D/2] uint8, two codes a byte, with per-row f32
scales): q [nt, H, D] at head dims 64 and 128, the whole cache
[L, KV, cells, D] with a layer index, an int8 mask [nt, n_vis] bounding
the cells read (any 1 <= n_vis <= cells), a logit softcap, and 0 for fully
masked rows.  Bound on the H100: bytes (one read of the visible K/V prefix
and its scales).  Every row count takes bf16 tensor cores, which skip the
64-cell tiles that no row of a block sees.  The wrapper splits the visible
cells over blocks (flash-decoding) so a decode step fills the card, and
pads a ragged mask to whole tiles with zeros; see the CUDA source.
``n_splits``, ``check_cache`` and ``tile_mask`` serve kernel 9 too
(``ops/cuda/flash_stacked.py``).  Head dims 192 and 256, which the JAX
kernel also takes, raise on the card.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.attention import cache_attention_reference
from llama_kotlin_tpu_torch.ops.cuda import _build

HEAD_DIMS = (64, 128)  # the tile's head dims
CELL_TILE = 64  # cells per kernel tile
ROW_TILE = 64  # query rows per block of the tile
TARGET_BLOCKS = 264  # two blocks per SM of an H100
LAUNCHES = 0  # kernel launches made by flash_attention
LAUNCHES_INT8 = 0  # of those, launches on an int8 cache
LAUNCHES_INT4 = 0  # of those, launches on a packed int4 cache

# Plain version: the JAX package's route over the cache (attention.py:128-142)
flash_attention_plain = cache_attention_reference


def n_splits(kv: int, rows: int, n_vis: int, row_tile: int) -> int:
    """Cell splits per (kv head, tile of row_tile rows): enough blocks to
    fill the card, each split a whole number of the ceil(n_vis / 64) cell
    tiles (the last one ragged where n_vis is not a multiple of 64)."""
    tiles = -(-n_vis // CELL_TILE)
    blocks = kv * -(-rows // row_tile)
    want = max(1, -(-TARGET_BLOCKS // blocks))
    return max(d for d in range(1, tiles + 1) if tiles % d == 0 and d <= want)


def check_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_vis: int, layer: int,
                k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                kv_bits: int = 8, mask: Optional[torch.Tensor] = None) -> None:
    """The kernels' rules for q and a [L, KV, cells, D] cache on the card
    (kernels 3 and 9): head_dim 64 or 128, 1 <= n_vis <= cells, a
    contiguous bf16 cache, or int8 codes with contiguous f32 scale planes;
    kernel 3 also takes packed int4 codes [L, KV, cells, D/2] (kv_bits=4)
    with such planes, and its mask on the card."""
    require(q.shape[-1] in HEAD_DIMS,
            f"the kernels take head dims {HEAD_DIMS}, not {q.shape[-1]}")
    require(1 <= n_vis <= k.shape[2], f"n_vis {n_vis} outside 1..{k.shape[2]}")
    require(0 <= layer < k.shape[0], f"layer {layer} out of range")
    require(q.dtype == torch.bfloat16, "the kernels take bf16 q")
    require(k.is_cuda and v.is_cuda, "q and the cache on the card")
    require(k.is_contiguous() and v.is_contiguous(), "cache must be contiguous")
    require(mask is None or mask.is_cuda, "mask on the card")
    if k_scale is None:
        require(kv_bits == 8 and k.dtype == v.dtype == torch.bfloat16,
                "a cache without scales is bf16")
    else:
        codes = torch.uint8 if kv_bits == 4 else torch.int8
        require(k.dtype == v.dtype == codes, f"a {kv_bits}-bit cache holds {codes} codes")
        for s in (k_scale, v_scale):
            require(s.dtype == torch.float32 and s.shape == k.shape[:3] and s.is_contiguous()
                    and s.is_cuda, "scales are contiguous f32 [L, KV, cells] on the card")


def tile_mask(mask: torch.Tensor) -> torch.Tensor:
    """The int8 mask [nt, n_vis] as the tile reads it: contiguous, its rows
    padded with zeros to whole 64-cell tiles (the padded cells are dead),
    so every 8-byte read of a row is aligned and inside the buffer."""
    m = mask.to(torch.int8)
    pad = -m.shape[1] % CELL_TILE
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.contiguous()
    require(m.data_ptr() % 8 == 0, "mask not 8-byte aligned")
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    *, scale: float, logit_softcap: float = 0.0,
                    layer: Optional[int] = None, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None, kv_bits: int = 8) -> torch.Tensor:
    """q [nt, H, D] bf16; k/v [L, KV, cells, D] with `layer`, or
    [KV, cells, D] without: bf16, or int8 codes with k_scale/v_scale
    ([L, KV, cells] or [KV, cells] f32), or with kv_bits=4 packed int4
    codes [.., D/2] uint8 with such scales; mask [nt, n_vis] (bool or int8,
    any n_vis up to cells) -> [nt, H, D] bf16."""
    global LAUNCHES, LAUNCHES_INT8, LAUNCHES_INT4
    require((layer is not None) == (k.dim() == 4), "layer index iff a 4D cache")
    require((k_scale is None) == (v_scale is None), "k_scale and v_scale come together")
    require(kv_bits in (4, 8), f"kv_bits {kv_bits}: 8 (bf16 or int8 cache) or 4 (packed)")
    require(kv_bits == 8 or k_scale is not None, "a packed int4 cache carries row scales")
    nt, H, D = q.shape
    KV, cells = k.shape[-3], k.shape[-2]
    n_vis = mask.shape[1]
    require(k.shape == v.shape and k.shape[-1] * (8 // kv_bits) == D, "k/v/q head dims differ")
    require(H % KV == 0, f"{H} heads over {KV} kv heads")
    require(mask.shape[0] == nt and n_vis <= cells, "mask does not fit q and the cache")
    if not is_cuda(q):
        return flash_attention_plain(q, k, v, mask, scale=scale, logit_softcap=logit_softcap,
                                     k_scale=k_scale, v_scale=v_scale, layer=layer,
                                     kv_bits=kv_bits)
    if layer is None:  # one layer of a cache: a view with L = 1
        k, v, layer = k[None], v[None], 0
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    check_cache(q, k, v, n_vis, layer, k_scale, v_scale, kv_bits, mask)
    q = q.contiguous()
    # the tile copies cache rows 16 bytes at a time and reads mask rows 8
    require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0, "cache not 16-byte aligned")
    mask_i8 = tile_mask(mask)
    rows = (H // KV) * nt
    nsplit = n_splits(KV, rows, n_vis, ROW_TILE)
    part_o = torch.empty((nsplit, KV * rows, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((nsplit, KV * rows, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.check(_build.lib().lk_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scale), _build.ptr(v_scale),
        mask_i8.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), nt, H, KV, D,
        cells, n_vis, mask_i8.shape[1], layer, float(scale), float(logit_softcap), nsplit, kv_bits,
        _build.stream()), "lk_flash")
    LAUNCHES += 1
    if kv_bits == 4:
        LAUNCHES_INT4 += 1
    elif k_scale is not None:
        LAUNCHES_INT8 += 1
    return out
