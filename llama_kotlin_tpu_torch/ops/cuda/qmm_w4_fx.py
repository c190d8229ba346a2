"""Kernel 8: W4A8 matmul for decode rows with the activation quantization
inside the one launch (``csrc/qmm_w4_fx.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4_fx``, which
``qmm_w4_matmul`` reaches under ``LKTPU_W4_FX=1`` on sym (Q4_0 class) and
legacy W4 folds: raw f32 rows in, y out, no prologue launch.  It computes
kernel 1's function (``ops/cuda/qmm_w4.py``): x quantized to int8 per
256-element superblock with the exact quantize_q8 formula, exact integer
per-32-group partials, the group scales and the min term in f32 (on a
sym fold formed from the scale, so g_min is not read).  Bound on the H100:
bytes (the weight stream); see the CUDA source for the design.  Rows up
to ``MMA_MIN_ROWS`` take the walk, more rows kernel 7's int8 tensor-core
tile with one plane (``csrc/w4_mma.cuh``), which quantizes x inside each
block, with K split as kernel 4's ``plan`` says (``use_mma``).

``qmm_w4_fx_matmul`` launches the kernel for CUDA tensors and runs
``qmm_w4_fx_plain`` for CPU tensors.  Compact folds are not its: under
``LKTPU_W4_FX=1`` the JAX dispatch sends them to kernel 4
(``ops/qmatmul.py``).
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_W4, plan, sm_count, split_workspace
from llama_kotlin_tpu_torch.ops.cuda._checks import check_w4_on
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import MAX_ROWS, quantize_q8, w4_dot_plain
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import QTensor

LAUNCHES = 0  # kernel launches made by qmm_w4_fx_matmul
LAUNCHES_MMA = 0  # of which took the tensor cores
# T8: rows above it take the tensor-core GEMM, rows up to it the walk
# (csrc/qmm_w4_fx.cu's FX_WALK_ROWS, which refuses the walk above it).  The
# crossover on the H100 (scripts/qmm_ab.py, the parent walking every row
# count; PERF.md, kernel 8): at 4 rows the walk takes a sym layer's four
# projections in less time than the GEMM (which quantizes 16 rows of x in
# every block), at 8 rows the GEMM does
MMA_MIN_ROWS = 4
MMA_BM = 64  # the plan's row tile (one tile: at most 32 rows)


def use_mma(b: int) -> bool:
    """Whether b rows take the tensor-core GEMM (else the walk)."""
    return b > MMA_MIN_ROWS


def fx_eligible(w) -> bool:
    """Kernel 8 takes this weight: a W4 fold of the sym or legacy flavor
    (the JAX fx kernel's non-compact, non-precise folds)."""
    return is_w4(w) and w.flavor != "compact"


def qmm_w4_fx_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version: x [b, k_pad] f32 -> [b, n] f32, kernel 1's arithmetic
    after quantize_q8."""
    return w4_dot_plain(*quantize_q8(x), w)


def qmm_w4_fx_matmul(x: torch.Tensor, w: QTensor, codes_out: bool = False):
    """x [..., k] (float) @ W4 w^T -> [..., n] f32, for at most 32 rows of a
    sym or legacy fold.  codes_out=True (CUDA tensors, tensor-core path
    only) also returns the launch's own activation codes, scales and group
    sums (x8, sx, xsum) in quantize_q8's layout, for a check against the
    prologue's."""
    global LAUNCHES, LAUNCHES_MMA
    require(fx_eligible(w), "qmm_w4_fx_matmul needs a sym or legacy W4 fold")
    n, k = w.shape
    lead = x.shape[:-1]
    b = math.prod(lead)
    require(x.shape[-1] == k, f"x has k={x.shape[-1]}, weight k={k}")
    require(1 <= b <= MAX_ROWS, f"{b} rows: kernel 8 takes 1..{MAX_ROWS}")
    x2 = x.reshape(b, k).to(torch.float32)
    if w.k_pad != k:
        x2 = torch.nn.functional.pad(x2, (0, w.k_pad - k))
    if not is_cuda(x2):
        require(not codes_out, "codes_out needs CUDA tensors")
        return qmm_w4_fx_plain(x2, w).reshape(*lead, n)
    x2 = x2.contiguous()
    check_w4_on(w, x2.device)
    y = torch.empty((b, n), dtype=torch.float32, device=x2.device)
    splits, ws, cnt = 0, None, None
    if use_mma(b):
        p = plan(1, n, w.k_pad, UNIT_W4, sm_count(x2.device.index or 0), bms=(MMA_BM,))
        splits = p.splits
        ws, cnt = split_workspace(p, b, n, x2.device)
    q = (None, None, None)
    if codes_out:
        require(splits >= 1, f"codes_out: {b} rows take the walk, which keeps its codes")
        kp = w.k_pad
        q = (torch.empty((b, kp), dtype=torch.int8, device=x2.device),
             torch.empty((b, kp // 256), dtype=torch.float32, device=x2.device),
             torch.empty((b, kp // 32), dtype=torch.int32, device=x2.device))
    sym = w.flavor == "sym"
    _build.check(_build.lib().lk_w4_fx_gemv(
        x2.data_ptr(), b, w.codes.data_ptr(), w.g_scale.data_ptr(),
        None if sym else w.g_min.data_ptr(), int(sym), n, w.k_pad // 2, y.data_ptr(), splits,
        _build.ptr(ws), _build.ptr(cnt), *(_build.ptr(t) for t in q), _build.stream()),
        "lk_w4_fx_gemv")
    LAUNCHES += 1
    LAUNCHES_MMA += int(splits > 0)
    y = y.reshape(*lead, n)
    return (y, q) if codes_out else y
