"""Kernel 7: the W4X matmul for decode rows over a precise W4 fold
(``csrc/qmm_w4x.cu``, prologue ``csrc/q8.cu``'s dual-plane quantizer).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4`` as the W4X
dispatch reaches it (entry ``qmm_w4_matmul`` on a fold with
``aux["precise"]``): raw f32 activations are quantized in two int8 planes
(``quantize_q8_2p``: x, then the residual), both planes are multiplied
against the fold's codes with integer per-32-group partials, the f32
s_eff/m_adj planes apply per group (the min term in the kernel, as the
Pallas kernel's ``madj_t``/sym branch does), and the planes' results are
summed.  Bound on the H100: bytes (the weight stream, 6.0 bits per
weight); see the CUDA source for the design.  Rows up to ``MMA_MIN_ROWS``
take the warp-per-row walk, more rows int8 tensor cores with K split as
kernel 4's ``plan`` says (``use_mma``).

``qmm_w4x_matmul`` launches the kernel for CUDA tensors and runs
``qmm_w4x_plain`` — the same function in plain PyTorch — for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_W4, plan, sm_count, split_workspace
from llama_kotlin_tpu_torch.ops.cuda._checks import check_w4_on
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (MAX_ROWS, quantize_q8_2p, quantize_q8_2p_cuda,
                                                    w4_dot_plain)
from llama_kotlin_tpu_torch.quant.fold import is_w4x
from llama_kotlin_tpu_torch.quant.qtensor import QTensor

LAUNCHES = 0  # kernel launches made by qmm_w4x_matmul
# T: rows above it take the tensor-core GEMM, rows up to it the walk.  The
# crossover on the H100 (scripts/qmm_ab.py, the walk at every row count
# against this wrapper; PERF.md, kernel 7): from 2 rows the GEMM is faster
# on a layer's four projections together (0.145 vs 0.152 ms a layer at 2
# rows; qkv and o alone still walk faster there) and on each of them from
# 4 rows (gate|up 0.058 vs 0.101 ms); one row keeps the walk, where the
# GEMM's 64-row tile would hold 2 rows
MMA_MIN_ROWS = 1
MMA_BM = 64  # the GEMM's one row tile: both planes of up to 32 rows


def use_mma(b: int) -> bool:
    """Whether b rows take the tensor-core GEMM (else the walk)."""
    return b > MMA_MIN_ROWS


def qmm_w4x_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version of the whole wrapper: x [b, k_pad] f32 -> [b, n] f32,
    the JAX entry's order: each plane's whole product, then their sum."""
    b = x.shape[0]
    y = w4_dot_plain(*quantize_q8_2p(x), w)
    return y[:b] + y[b:]


def qmm_w4x_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] (float) @ W4X w^T -> [..., n] f32, for at most 32 rows."""
    global LAUNCHES
    require(is_w4x(w), "qmm_w4x_matmul needs a precise W4 (W4X) fold")
    n, k = w.shape
    k_pad = w.k_pad
    lead = x.shape[:-1]
    b = math.prod(lead)
    require(x.shape[-1] == k, f"x has k={x.shape[-1]}, weight k={k}")
    require(1 <= b <= MAX_ROWS, f"{b} rows: kernel 7 takes 1..{MAX_ROWS}")
    x2 = x.reshape(b, k).to(torch.float32)
    if k_pad != k:
        x2 = torch.nn.functional.pad(x2, (0, k_pad - k))
    if not is_cuda(x2):
        return qmm_w4x_plain(x2, w).reshape(*lead, n)
    x2 = x2.contiguous()
    check_w4_on(w, x2.device)
    x8, sx, xsum = quantize_q8_2p_cuda(x2)
    y = torch.empty((b, n), dtype=torch.float32, device=x2.device)
    splits, ws, cnt = 0, None, None
    if use_mma(b):
        p = plan(1, n, k_pad, UNIT_W4, sm_count(x2.device.index or 0), bms=(MMA_BM,))
        splits = p.splits
        ws, cnt = split_workspace(p, b, n, x2.device)
    _build.check(_build.lib().lk_w4x_gemv(
        x8.data_ptr(), sx.data_ptr(), xsum.data_ptr(), b, w.codes.data_ptr(),
        w.g_scale.data_ptr(), w.g_min.data_ptr(), n, k_pad // 2, y.data_ptr(), splits,
        _build.ptr(ws), _build.ptr(cnt), _build.stream()), "lk_w4x_gemv")
    LAUNCHES += 1
    return y.reshape(*lead, n)
