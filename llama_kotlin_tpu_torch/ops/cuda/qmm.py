"""Kernel 4: fused dequantize-matmul for prefill rows over a W4 fold
(``csrc/qmm.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm.py::qmm`` on the W4 fold (entry
``qmm_pallas_or_none``): y = x W^T with w = plane * g_scale - g_min formed
in f32 and rounded to bf16, x in bf16, f32 accumulation — the operands the
Pallas kernel feeds its dot.  Bound on the H100: bytes at 64 rows; the
dequantized tile lives only in shared memory.  See the CUDA source.

``qmm`` launches the kernel for CUDA tensors and runs ``qmm_plain`` for CPU
tensors.
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import check_w4_on
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, dequantize

LAUNCHES = 0  # kernel launches made by qmm
PLAIN_CHUNK = 8192  # output rows per step of the plain version


def dequantize_bf16(w: QTensor, rows: slice = slice(None)) -> torch.Tensor:
    """The kernel's weight operand: dequantized rows rounded to bf16."""
    sub = w.rows(torch.arange(w.n, device=w.device)[rows])
    return dequantize(sub, torch.float32).to(torch.bfloat16)


def qmm_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version: x [m, k] -> [m, n] f32 from bf16 operands."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    outs = []
    for r0 in range(0, w.n, PLAIN_CHUNK):
        wb = dequantize_bf16(w, slice(r0, min(r0 + PLAIN_CHUNK, w.n)))
        outs.append(xb @ wb.to(torch.float32).T)
    return torch.cat(outs, dim=1)


def qmm(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] @ W4 w^T -> [..., n] f32 (any number of rows)."""
    global LAUNCHES
    require(is_w4(w), "qmm needs a W4 fold")
    n, k = w.shape
    lead = x.shape[:-1]
    m = math.prod(lead)
    require(x.shape[-1] == k and m >= 1, f"x {tuple(x.shape)} does not fit weight k={k}")
    x2 = x.reshape(m, k)
    if not is_cuda(x2):
        return qmm_plain(x2, w).reshape(*lead, n)
    check_w4_on(w, x2.device)
    xb = x2.to(torch.bfloat16)
    if w.k_pad != k:
        xb = torch.nn.functional.pad(xb, (0, w.k_pad - k))
    xb = xb.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    _build.check(_build.lib().lk_w4_dequant_gemm(
        xb.data_ptr(), w.codes.data_ptr(), w.g_scale.data_ptr(), w.g_min.data_ptr(),
        y.data_ptr(), m, n, w.k_pad, _build.stream()), "lk_w4_dequant_gemm")
    LAUNCHES += 1
    return y.reshape(*lead, n)
