"""Kernel 6: the Q8F matmul of the int8 fast mode, at any row count
(``csrc/qmm_int8.cu``, its tensor-core tile in ``csrc/w8_mma.cuh``,
prologue ``csrc/q8.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_int8.py::qmm_int8``:
y[b, n] = sum_s (sx[b, s] * sw[n, s]) * P[b, n, s], with P the exact
integer product of the int8 weight codes and the per-256 int8 activation
codes over superblock s.  Rows up to ``MMA_MIN_ROWS`` (T6) take a __dp4a
walk, more rows int8 tensor cores (mma.sync) with row tiles and K split in
whole superblocks as kernel 4's ``plan`` says (``use_mma``, ``row_tile``).
Bound on the H100: bytes up to a 64-row prefill; see the CUDA source.

``qmm_int8`` launches the kernel for CUDA tensors and runs
``qmm_int8_plain`` for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda._checks import check_int8_on
from llama_kotlin_tpu_torch.ops.cuda.qmm import plan, sm_count, split_workspace
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import quantize_q8, quantize_q8_cuda
from llama_kotlin_tpu_torch.quant.fold import is_q8f
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

LAUNCHES = 0  # kernel launches made by qmm_int8
LAUNCHES_MMA = 0  # of those, the ones that took the tensor cores
PLAIN_CHUNK = 8192  # output rows per step of the plain version
# T6: rows above it take the tensor-core tile, rows up to it the walk
# (csrc/qmm_int8.cu's Q8F_WALK_ROWS, which refuses the walk above it)
MMA_MIN_ROWS = 2
MMA_BMS = (64,)  # the row tiles plan() may choose above 32 rows
UNIT = 256  # K elements a split unit: one superblock


def row_tile(m: int, bm: int) -> int:
    """The tile's rows a block: the plan's row tile, or the least m16
    multiple (16 or 32) that holds m rows when m is smaller."""
    return next(t for t in (16, 32, bm) if t >= min(m, bm))


def use_mma(m: int) -> bool:
    """Whether m rows take the tensor-core tile (else the walk)."""
    return m > MMA_MIN_ROWS


def q8f_partials(x8: torch.Tensor, w: QTensor, rows: slice = slice(None)) -> torch.Tensor:
    """The exact integer partials P [S, b, r] of weight rows `rows`, one a
    superblock, as f32 (each < 2^22 in magnitude)."""
    b, k_pad = x8.shape
    S = k_pad // SPAN
    xs = x8.to(torch.float32).reshape(b, S, SPAN).transpose(0, 1)  # [S, b, 256]
    q = w.codes[rows].to(torch.float32)
    return torch.bmm(xs, q.reshape(q.shape[0], S, SPAN).permute(1, 2, 0))


def q8f_dot_plain(x8: torch.Tensor, sx: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The kernel's arithmetic on quantized activations: y [b, n] =
    sum_s P_s * (sx * sw), P_s the exact integer partial of superblock s."""
    outs = []
    for r0 in range(0, w.n, PLAIN_CHUNK):
        rows = slice(r0, min(r0 + PLAIN_CHUNK, w.n))
        p = q8f_partials(x8, w, rows)
        scale = sx.T[:, :, None] * w.g_scale[rows].T[:, None, :]
        outs.append((p * scale).sum(dim=0))
    return torch.cat(outs, dim=1)


def qmm_int8_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version of the whole wrapper: x [m, k_pad] f32 -> [m, n] f32."""
    x8, sx, _ = quantize_q8(x)
    return q8f_dot_plain(x8, sx, w)


def qmm_int8(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] (float) @ Q8F w^T -> [..., n] f32, any number of rows."""
    global LAUNCHES, LAUNCHES_MMA
    require(is_q8f(w), "qmm_int8 needs a Q8F tensor")
    n, k = w.shape
    k_pad = w.k_pad
    lead = x.shape[:-1]
    m = math.prod(lead)
    require(x.shape[-1] == k and m >= 1, f"x {tuple(x.shape)} does not fit weight k={k}")
    x2 = x.reshape(m, k).to(torch.float32)
    if k_pad != k:
        x2 = torch.nn.functional.pad(x2, (0, k_pad - k))
    if not is_cuda(x2):
        return qmm_int8_plain(x2, w).reshape(*lead, n)
    x2 = x2.contiguous()
    check_int8_on(w, x2.device)
    x8, sx, _ = quantize_q8_cuda(x2)
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    bm, splits, ws, cnt = 0, 0, None, None
    if use_mma(m):
        p = plan(m, n, k_pad, UNIT, sm_count(x2.device.index or 0), bms=MMA_BMS)
        bm, splits = row_tile(m, p.bm), p.splits
        ws, cnt = split_workspace(p, m, n, x2.device)
    _build.check(_build.lib().lk_q8f_matmul(
        x8.data_ptr(), sx.data_ptr(), m, w.codes.data_ptr(), w.g_scale.data_ptr(),
        n, k_pad, y.data_ptr(), bm, splits, _build.ptr(ws), _build.ptr(cnt), _build.stream()),
        "lk_q8f_matmul")
    LAUNCHES += 1
    LAUNCHES_MMA += int(splits > 0)
    return y.reshape(*lead, n)
