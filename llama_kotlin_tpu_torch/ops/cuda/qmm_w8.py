"""Kernel 5: W8A8 matmul for decode rows over the W8 fold
(``csrc/qmm_w8.cu``, prologue ``csrc/q8.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w8.py::qmm_w8`` (entry
``qmm_w8_matmul``): raw f32 activations are quantized to int8 per
256-element superblock by the same quantizer as kernel 1, multiplied
against the fold's int8 codes with exact integer partials per 16- or
32-group, and each partial is scaled as (p * s_eff[n, g]) * sx[b, s] in
f32.  Formats with mins subtract x_g . m_eff outside the kernel with one
``torch.matmul`` over the sx-scaled group sums, as the JAX entry does.
Bound on the H100: bytes (the weight stream, 10 bits per weight at
group 16); see the CUDA source for the design.  Rows up to
``MMA_MIN_ROWS`` take the warp-per-row walk, more rows int8 tensor cores
(``csrc/w8_mma.cuh``) with K split in whole superblocks as kernel 4's
``plan`` says (``use_mma``).

The precise branch (W8X folds, the W4X mode's q6_K tensors; the JAX
entry's ``precise`` branch, ``qmm_w8.py:117-133``) quantizes the
activations in two planes (``quantize_q8_2p``), runs the same kernel over
both planes' rows in one pass over the codes (summing the planes in the
kernel), and subtracts the min term of both planes outside the kernel.

``qmm_w8_matmul`` launches the kernel for CUDA tensors and runs
``qmm_w8_plain`` — the same function in plain PyTorch — for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda.qmm import plan, sm_count, split_workspace
from llama_kotlin_tpu_torch.ops.cuda._checks import check_int8_on
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (MAX_ROWS, quantize_q8, quantize_q8_2p,
                                                    quantize_q8_2p_cuda, quantize_q8_cuda)
from llama_kotlin_tpu_torch.quant.fold import is_w8, is_w8x
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

LAUNCHES = 0  # kernel launches of qmm_w8_matmul on W8 folds (single plane)
LAUNCHES_2P = 0  # and on W8X folds (the precise, dual-plane branch)
LAUNCHES_MMA = 0  # of the W8 launches, those that took the tensor cores
LAUNCHES_2P_MMA = 0  # and of the W8X ones
PLAIN_CHUNK = 8192  # output rows per step of the plain version
# T5: rows above it take the tensor-core GEMM, rows up to it the walk
# (csrc/qmm_w8.cu's W8_WALK_ROWS, which refuses the walk above it).  The
# crossover on the H100 (scripts/qmm_ab.py, the parent walking every row
# count; PERF.md, kernel 5): the walk is faster at 2 rows on every shape
# and branch but W8X ffn_down, the tensor cores from 4 rows on every one
# but the W8 lm_head, whose loss there the other projections outweigh
MMA_MIN_ROWS = 2
MMA_BM = 64  # the GEMM's one row tile: both planes of up to 32 rows
UNIT = 256  # K elements a split unit: one superblock, the span of an sx


def use_mma(b: int) -> bool:
    """Whether b rows take the tensor-core GEMM (else the walk)."""
    return b > MMA_MIN_ROWS


def w8_dot_plain(x8: torch.Tensor, sx: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The kernel's arithmetic on quantized activations: y [b, n] =
    sum_g (P_g * s_g) * sx, P_g the exact integer partial of group g."""
    b, k_pad = x8.shape
    gs = w.group_size
    G = k_pad // gs
    xg = x8.to(torch.float32).reshape(b, G, gs).transpose(0, 1)  # [G, b, gs]
    sxg = sx.repeat_interleave(SPAN // gs, dim=1).T[:, :, None]  # [G, b, 1]
    outs = []
    for r0 in range(0, w.n, PLAIN_CHUNK):
        rows = slice(r0, min(r0 + PLAIN_CHUNK, w.n))
        q = w.codes[rows].to(torch.float32)
        q = q.reshape(q.shape[0], G, gs).permute(1, 2, 0)  # [G, gs, r]
        p = torch.bmm(xg, q)  # [G, b, r] exact integers (< 2^24)
        outs.append((p * w.g_scale[rows].T[:, None, :] * sxg).sum(dim=0))
    return torch.cat(outs, dim=1)


def min_term(x8: torch.Tensor, sx: torch.Tensor, w: QTensor) -> torch.Tensor:
    """sum_g (sx * sum_{c in g} x8) * m_eff[n, g]: the mins' share, one
    matmul outside the kernel (formats with mins only)."""
    b, k_pad = x8.shape
    gs = w.group_size
    xg = x8.reshape(b, k_pad // gs, gs).sum(dim=-1, dtype=torch.int32).to(torch.float32)
    xg = xg * sx.repeat_interleave(SPAN // gs, dim=1)
    return torch.matmul(xg, w.g_min.T)


def qmm_w8_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version of the whole wrapper: x [b, k_pad] f32 -> [b, n] f32.
    A W8X fold takes both activation planes (each plane's whole product
    and min term, then their sum, in the JAX entry's order)."""
    b = x.shape[0]
    x8, sx, _ = quantize_q8_2p(x) if is_w8x(w) else quantize_q8(x)
    y = w8_dot_plain(x8, sx, w)
    if w.g_min is not None:
        y = y - min_term(x8, sx, w)
    return y[:b] + y[b:] if is_w8x(w) else y


def qmm_w8_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] (float) @ W8 or W8X w^T -> [..., n] f32, for at most 32
    rows."""
    global LAUNCHES, LAUNCHES_2P, LAUNCHES_MMA, LAUNCHES_2P_MMA
    precise = is_w8x(w)
    require(is_w8(w) or precise, "qmm_w8_matmul needs a W8 or W8X fold")
    n, k = w.shape
    k_pad = w.k_pad
    lead = x.shape[:-1]
    b = math.prod(lead)
    require(x.shape[-1] == k, f"x has k={x.shape[-1]}, weight k={k}")
    require(1 <= b <= MAX_ROWS, f"{b} rows: kernel 5 takes 1..{MAX_ROWS}")
    x2 = x.reshape(b, k).to(torch.float32)
    if k_pad != k:
        x2 = torch.nn.functional.pad(x2, (0, k_pad - k))
    if not is_cuda(x2):
        return qmm_w8_plain(x2, w).reshape(*lead, n)
    x2 = x2.contiguous()
    check_int8_on(w, x2.device)
    x8, sx, _ = quantize_q8_2p_cuda(x2) if precise else quantize_q8_cuda(x2)
    y = torch.empty((b, n), dtype=torch.float32, device=x2.device)
    splits, ws, cnt = 0, None, None
    if use_mma(b):
        p = plan(1, n, k_pad, UNIT, sm_count(x2.device.index or 0), bms=(MMA_BM,))
        splits = p.splits
        ws, cnt = split_workspace(p, b, n, x2.device)
    _build.check(_build.lib().lk_w8_gemv(
        x8.data_ptr(), sx.data_ptr(), b, w.codes.data_ptr(), w.g_scale.data_ptr(),
        n, k_pad, w.group_size, 2 if precise else 1, y.data_ptr(), splits, _build.ptr(ws),
        _build.ptr(cnt), _build.stream()), "lk_w8_gemv")
    if precise:
        LAUNCHES_2P += 1
        LAUNCHES_2P_MMA += int(splits > 0)
    else:
        LAUNCHES += 1
        LAUNCHES_MMA += int(splits > 0)
    if w.g_min is not None:
        mt = min_term(x8, sx, w)
        y = y - (mt[:b] + mt[b:] if precise else mt)
    return y.reshape(*lead, n)
