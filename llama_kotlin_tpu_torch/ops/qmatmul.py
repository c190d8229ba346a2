"""Quantized matmul y = x @ W^T for the port's served layouts (port of
``llama_kotlin_tpu/ops/qmatmul.py``, the single-device kernel dispatch of
``_pallas_dispatch``).

Routing is by layout and rows:

* W4 fold: at most 32 rows -> kernel 1 (``ops/cuda/qmm_w4.py``), more rows
  -> kernel 4 (``ops/cuda/qmm.py``);
* W4X (precise W4) fold: at most 32 rows -> kernel 7
  (``ops/cuda/qmm_w4x.py``, dual-plane activations), more -> kernel 4;
* W8 fold: at most 32 rows -> kernel 5 (``ops/cuda/qmm_w8.py``), more rows
  -> kernel 4's 8-bit branch; a W8X (precise W8) fold the same, on kernel
  5's dual-plane branch;
* Q8F: kernel 6 (``ops/cuda/qmm_int8.py``) at every row count;
* a dense bf16 matrix (an F32, F16 or BF16 tensor of the file): a plain
  matmul, bf16 operands into an f32 result, as JAX's ``jnp.dot`` with
  ``preferred_element_type=f32`` outside any Pallas kernel
  (``llama_kotlin_tpu/ops/qmatmul.py:433-437``).

``qmm_ffn`` sends decode rows through kernel 2 when gate|up and down are
both W4 folds it takes (never precise ones).  Any other weight raises: the
port has no library stand-in for a kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llama_kotlin_tpu_torch.ops.cuda.qmm import qmm
from llama_kotlin_tpu_torch.ops.cuda.qmm_int8 import qmm_int8
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import MAX_ROWS, qmm_w4_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import ffn_eligible, qmm_w4_ffn_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4x import qmm_w4x_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w8 import qmm_w8_matmul
from llama_kotlin_tpu_torch.quant.fold import is_q8f, is_w4, is_w4x, is_w8, is_w8x
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, dequantize


DENSE_CPU_ROWS = 4096  # weight rows widened to f32 at a time by the CPU dense product


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., k] @ w[n, k]^T -> [..., n] f32 for a dense bf16 weight: x
    rounded to bf16, products summed in f32.  On the card one bf16 GEMM
    with an f32 output (``out_dtype``); the CPU has no such GEMM, so it
    widens w to f32 a block of rows at a time, never the whole matrix."""
    xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    if xb.is_cuda:
        y = torch.mm(xb, w.T, out_dtype=torch.float32)
    else:
        xf = xb.to(torch.float32)
        y = torch.cat([xf @ wc.to(torch.float32).T for wc in w.split(DENSE_CPU_ROWS)], dim=1)
    return y.reshape(*x.shape[:-1], w.shape[0])


def qmatmul(x: torch.Tensor, w: QTensor | torch.Tensor) -> torch.Tensor:
    """x [..., k] @ w[n, k]^T -> [..., n] f32."""
    if isinstance(w, torch.Tensor):
        return dense_matmul(x, w)
    if is_w4(w):
        return qmm_w4_matmul(x, w) if _rows(x) <= MAX_ROWS else qmm(x, w)
    if is_w4x(w):
        return qmm_w4x_matmul(x, w) if _rows(x) <= MAX_ROWS else qmm(x, w)
    if is_w8(w) or is_w8x(w):
        return qmm_w8_matmul(x, w) if _rows(x) <= MAX_ROWS else qmm(x, w)
    if is_q8f(w):
        return qmm_int8(x, w)
    raise TypeError(f"no kernel serves this weight ({type(w).__name__}, "
                    f"layout {getattr(w, 'flavor', None)!r})")


def qmm_ffn(x: torch.Tensor, gu: QTensor, dn: QTensor,
            act: str = "silu") -> Optional[torch.Tensor]:
    """Fused gated FFN on kernel 2 for decode rows; None when the rows or
    the layouts are not kernel 2's (the caller then runs gate|up and down
    through qmatmul).  A W8 or Q8F down projection declines: kernel 2
    would read its int8 codes as nibbles."""
    if _rows(x) > MAX_ROWS or not ffn_eligible(gu, dn, act):
        return None
    return qmm_w4_ffn_matmul(x, gu, dn, act=act)


def take_rows(w: QTensor | torch.Tensor, ids: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """Embedding lookup: gather the packed rows, dequantize only those (a
    dense matrix: gather its rows, as JAX's ``w[ids]``)."""
    if isinstance(w, torch.Tensor):
        return w[ids.to(torch.long)].to(dtype)
    return dequantize(w.rows(ids), dtype=dtype)
