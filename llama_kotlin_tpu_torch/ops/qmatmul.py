"""Quantized matmul y = x @ W^T for the port's W4 folds (port of
``llama_kotlin_tpu/ops/qmatmul.py``, the single-device W4 branches).

Routing is by shape: at most 32 rows go to kernel 1 (W4A8,
``ops/cuda/qmm_w4.py``), more rows to kernel 4 (dequant GEMM,
``ops/cuda/qmm.py``).  ``qmm_ffn`` sends decode rows through kernel 2.
Any other weight raises: the port has no library stand-in.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llama_kotlin_tpu_torch.ops.cuda.qmm import qmm
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import MAX_ROWS, qmm_w4_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import qmm_w4_ffn_matmul
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, dequantize


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def qmatmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] @ w[n, k]^T -> [..., n] f32."""
    if not is_w4(w):
        raise TypeError(f"qmatmul serves W4 folds only, got {type(w).__name__}")
    if _rows(x) <= MAX_ROWS:
        return qmm_w4_matmul(x, w)
    return qmm(x, w)


def qmm_ffn(x: torch.Tensor, gu: QTensor, dn: QTensor,
            act: str = "silu") -> Optional[torch.Tensor]:
    """Fused gated FFN on kernel 2 for decode rows; None for more rows (the
    caller then runs gate|up and down through qmatmul)."""
    if _rows(x) > MAX_ROWS:
        return None
    return qmm_w4_ffn_matmul(x, gu, dn, act=act)


def take_rows(w: QTensor, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Embedding lookup: gather the packed rows, dequantize only those."""
    return dequantize(w.rows(ids), dtype=dtype)
