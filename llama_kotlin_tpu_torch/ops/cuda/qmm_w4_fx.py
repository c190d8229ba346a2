"""Kernel 8: W4A8 matmul for decode rows with the activation quantization
inside the one launch (``csrc/qmm_w4_fx.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4_fx``, which
``qmm_w4_matmul`` reaches under ``LKTPU_W4_FX=1`` on sym (Q4_0 class) and
legacy W4 folds: raw f32 rows in, y out, no prologue launch.  It computes
kernel 1's function (``ops/cuda/qmm_w4.py``): x quantized to int8 per
256-element superblock with the exact quantize_q8 formula, exact integer
per-32-group partials, the group scales and the min term in f32 (on a
sym fold formed from the scale, so g_min is not read).  Bound on the H100:
bytes (the weight stream); see the CUDA source for the design.

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
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (MAX_ROWS, check_w4_on, quantize_q8,
                                                    w4_dot_plain)
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import QTensor

LAUNCHES = 0  # kernel launches made by qmm_w4_fx_matmul


def fx_eligible(w) -> bool:
    """Kernel 8 takes this weight: a W4 fold of the sym or legacy flavor
    (the JAX fx kernel's non-compact, non-precise folds)."""
    return is_w4(w) and w.flavor != "compact"


def qmm_w4_fx_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version: x [b, k_pad] f32 -> [b, n] f32, kernel 1's arithmetic
    after quantize_q8."""
    return w4_dot_plain(*quantize_q8(x), w)


def qmm_w4_fx_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] (float) @ W4 w^T -> [..., n] f32, for at most 32 rows of a
    sym or legacy fold."""
    global LAUNCHES
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
        return qmm_w4_fx_plain(x2, w).reshape(*lead, n)
    x2 = x2.contiguous()
    check_w4_on(w, x2.device)
    y = torch.empty((b, n), dtype=torch.float32, device=x2.device)
    _build.check(_build.lib().lk_w4_fx_gemv(
        x2.data_ptr(), b, w.codes.data_ptr(), w.g_scale.data_ptr(), w.g_min.data_ptr(),
        int(w.flavor == "sym"), n, w.k_pad // 2, y.data_ptr(), _build.stream()),
        "lk_w4_fx_gemv")
    LAUNCHES += 1
    return y.reshape(*lead, n)
