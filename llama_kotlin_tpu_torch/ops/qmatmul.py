"""Quantized matmul y = x @ W^T for the port's served layouts (port of
``llama_kotlin_tpu/ops/qmatmul.py``, the single-device kernel dispatch of
``_pallas_dispatch``).

Routing is by layout and rows.  The decode kernels of the W4, W4X and W8
folds (1, 5, 7, 8) take a matrix whose output rows JAX's kernels can
block: JAX plans n in blocks of 512, 256 or 128 and declines a matrix
none of them divides (``llama_kotlin_tpu/ops/pallas/qmm_w4.py::_plan``,
``qmm_w8.py::_plan``; the folds already pad k to those kernels' column
chunks), and such a matrix takes kernel 4 at every row count, as in JAX
(DeepSeek-V2-Lite's ``attn_kv_a_mqa``, 576 rows, and its dense lead
layer's unfused gate and up, 10944 rows):

* W4 fold: at most 32 rows -> the JAX ``qmm_w4_matmul`` site that
  ``LKTPU_W4_FX`` selects (read per call, JAX's defaults and comparisons,
  ``llama_kotlin_tpu/ops/pallas/qmm_w4.py:210-231``): unset or ``"2"`` ->
  kernel 1 (``ops/cuda/qmm_w4.py``, the fx2 site); ``"1"`` -> kernel 8
  (``ops/cuda/qmm_w4_fx.py``) on sym and legacy folds; any other value ->
  the standard ``qmm_w4`` site, kernel 1's function, which kernel 1 serves
  on sym and legacy folds.  Off the fx2 site JAX declines a compact fold,
  which then takes kernel 4 (``ops/cuda/qmm.py``), as do more than 32 rows;
  A W4 fold that carries a Q8F shadow (``LKTPU_DUAL_FOLD=1``,
  ``quant/fold.py::attach_q8``) sends more than ``LKTPU_W4_BMAX`` rows
  (read per call, default 8) and at most 256 to kernel 6 on the shadow,
  JAX's high-batch switch (``llama_kotlin_tpu/ops/qmatmul.py:55-99``);
  fewer rows take the W4 route above bit for bit, more take kernel 4;
* W4X (precise W4) fold: at most 32 rows -> kernel 7
  (``ops/cuda/qmm_w4x.py``, dual-plane activations), more -> kernel 4;
* W8 fold: at most 32 rows -> kernel 5 (``ops/cuda/qmm_w8.py``), more rows
  -> kernel 4's 8-bit branch; a W8X (precise W8) fold the same, on kernel
  5's dual-plane branch;
* Q8F: kernel 6 (``ops/cuda/qmm_int8.py``) at every row count;
* an exact repack (the exact-dequant mode, ``fast_mode=None``): routed by
  JAX's layout rules (``llama_kotlin_tpu/ops/qmatmul.py:110-119``), not by
  a flavor.  int8 codes at group 256 with one scale a superblock and no
  mins (a Q8_K repack) -> kernel 6 at every row count, as Q8F; every other
  exact repack of group 16 or 32 (8-bit codes, 4- or 2-bit planes) ->
  kernel 4's exact branches (``ops/cuda/qmm.py``) at every row count,
  decode included.  A layout neither takes raises;
* a dense bf16 matrix (an F32, F16 or BF16 tensor of the file): a plain
  matmul, bf16 operands into an f32 result, as JAX's ``jnp.dot`` with
  ``preferred_element_type=f32`` outside any Pallas kernel
  (``llama_kotlin_tpu/ops/qmatmul.py:433-437``).

``qmm_ffn`` sends decode rows through kernel 2 when gate|up (fused, or
gate and up apart) and down are W4 folds it takes (never precise ones,
never exact repacks: those run gate, up and down through ``qmatmul``, as
JAX's kernels 2 and 10 decline them), unless ``LKTPU_FFN_FUSED`` is "0"
(JAX's A/B knob, read per call), or the gate carries a shadow and the rows
exceed ``LKTPU_W4_BMAX`` (the caller's two-launch path then takes kernel 6).
``qmm_layer`` runs the whole post-attention half of a layer on kernel 10
(``ops/cuda/qmm_w4_layer.py``) under ``LKTPU_LAYER_FUSED=1`` when it
takes the operands, and declines above ``LKTPU_W4_BMAX`` rows as kernel 2
does when the gate carries a shadow.  Any other weight
raises: the port has no library stand-in for a kernel.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from llama_kotlin_tpu_torch.ops.cuda.qmm import qmm
from llama_kotlin_tpu_torch.ops.cuda.qmm_int8 import qmm_int8
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import MAX_ROWS, qmm_w4_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import ffn_eligible, qmm_w4_ffn_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_fx import qmm_w4_fx_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_layer import fused_layer, layer_eligible
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4x import qmm_w4x_matmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w8 import qmm_w8_matmul
from llama_kotlin_tpu_torch.quant.fold import (has_shadow, is_exact, is_q8_sb, is_w4, is_w4x,
                                               is_w8, is_w8x, q8_shadow)
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, dequantize


DENSE_CPU_ROWS = 4096  # weight rows widened to f32 at a time by the CPU dense product
ROW_BLOCK = 128  # the smallest output-row block of JAX's W4/W8 decode kernels' plans
SHADOW_MAX_ROWS = 256  # rows above it keep kernel 4 on the W4 fold, shadow or not


def w4_bmax() -> int:
    """``LKTPU_W4_BMAX``: the rows above which a W4 fold with a Q8F shadow
    switches to the shadow (JAX's ``_w4_bmax``, default 8)."""
    return int(os.environ.get("LKTPU_W4_BMAX", "8"))


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def _decode(x: torch.Tensor, w: QTensor) -> bool:
    """Whether a W4, W4X or W8 fold takes its decode kernel for x: at
    most 32 rows, and output rows that JAX's kernel plans (module
    docstring); else kernel 4."""
    return _rows(x) <= MAX_ROWS and w.shape[0] % ROW_BLOCK == 0


def takes_shadow(x: torch.Tensor, w) -> bool:
    """Whether x's rows run on the Q8F shadow of w: a shadow, more than
    LKTPU_W4_BMAX rows and at most 256, and output rows kernel 6 blocks
    (JAX's kernel 6 declines others; its W4 kernel too, so kernel 4)."""
    return (has_shadow(w) and w4_bmax() < _rows(x) <= SHADOW_MAX_ROWS
            and w.shape[0] % ROW_BLOCK == 0)


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
        if takes_shadow(x, w):
            return qmm_int8(x, q8_shadow(w))
        return _w4_decode(x, w) if _decode(x, w) else qmm(x, w)
    if is_w4x(w):
        return qmm_w4x_matmul(x, w) if _decode(x, w) else qmm(x, w)
    if is_w8(w) or is_w8x(w):
        return qmm_w8_matmul(x, w) if _decode(x, w) else qmm(x, w)
    if is_q8_sb(w):
        return qmm_int8(x, w)
    if is_exact(w):
        return qmm(x, w)
    raise TypeError(f"no kernel serves this weight ({type(w).__name__}, "
                    f"layout {getattr(w, 'flavor', None)!r}, bits {getattr(w, 'bits', None)}, "
                    f"group {getattr(w, 'group_size', None)})")


def _w4_decode(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Decode rows of a W4 fold, at the site LKTPU_W4_FX selects."""
    fx = os.environ.get("LKTPU_W4_FX", "2")
    if fx == "2":
        return qmm_w4_matmul(x, w)  # the fx2 site: every W4 flavor
    if w.flavor == "compact":
        return qmm(x, w)  # JAX's fx and standard sites decline a compact fold
    if fx == "1":
        return qmm_w4_fx_matmul(x, w)
    return qmm_w4_matmul(x, w)


def qmm_ffn(x: torch.Tensor, gu: QTensor, dn: QTensor, act: str = "silu",
            up: Optional[QTensor] = None) -> Optional[torch.Tensor]:
    """Fused gated FFN on kernel 2 for decode rows (gu the fused [gate; up],
    or the gate with `up` apart, as JAX's ``qmm_ffn``); None when
    LKTPU_FFN_FUSED is "0" or the rows or the layouts are not kernel 2's
    (the caller then runs gate, up and down through qmatmul).  A W8 or Q8F
    down projection declines: kernel 2 would read its int8 codes as
    nibbles."""
    if os.environ.get("LKTPU_FFN_FUSED", "1") == "0":
        return None
    if has_shadow(gu) and _rows(x) > w4_bmax():
        return None
    if _rows(x) > MAX_ROWS or not ffn_eligible(gu, dn, act, up):
        return None
    return qmm_w4_ffn_matmul(x, gu, dn, act=act, up=up)


def qmm_layer(attn: torch.Tensor, h: torch.Tensor, wo, gu, dn, norm_w: torch.Tensor, *,
              eps: float, act: str = "silu", offset: float = 0.0) -> Optional[torch.Tensor]:
    """The post-attention half of a layer, h3 = h2 + FFN(rms_norm(h2)) with
    h2 = h + attn @ Wo^T, on kernel 10 when LKTPU_LAYER_FUSED is "1" (read
    per call; off by default, as in JAX) and the kernel takes the operands;
    else None, and the caller runs o, the norm and the FFN apart."""
    if os.environ.get("LKTPU_LAYER_FUSED", "0") != "1":
        return None
    if has_shadow(gu) and _rows(attn) > w4_bmax():
        return None
    if not layer_eligible(attn, h, wo, gu, dn, act):
        return None
    return fused_layer(attn, h, wo, gu, dn, norm_w, eps=eps, act=act, offset=offset)


def take_rows(w: QTensor | torch.Tensor, ids: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """Embedding lookup: gather the packed rows, dequantize only those (a
    dense matrix: gather its rows, as JAX's ``w[ids]``)."""
    if isinstance(w, torch.Tensor):
        return w[ids.to(torch.long)].to(dtype)
    return dequantize(w.rows(ids), dtype=dtype)
