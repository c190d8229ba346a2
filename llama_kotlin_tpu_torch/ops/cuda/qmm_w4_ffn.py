"""Kernel 2: the decode-row gated FFN in one pass over its weights
(``csrc/qmm_w4_ffn.cu``, prologue ``csrc/q8.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::qmm_w4_ffn`` (entry
``qmm_w4_ffn_matmul``) for the fused [gate; up] layout:
y = (act(x Wg^T) * (x Wu^T)) Wd^T with x quantized per 256, h rounded to
bf16 and re-quantized per 256 before the down product.  Bound on the H100:
bytes (the three weight matrices); the intermediate h stays in shared
memory.  See the CUDA source for the design.

``qmm_w4_ffn_matmul`` launches the kernel for CUDA tensors and runs
``qmm_w4_ffn_plain`` for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda._checks import check_w4_on
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (MAX_ROWS, gemv_args, qmm_w4_plain,
                                                    quantize_q8_cuda)
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

ACTS = {"silu": 0, "gelu": 1}  # the kernel's activation codes
LAUNCHES = 0  # kernel launches made by qmm_w4_ffn_matmul


def qmm_w4_ffn_plain(x: torch.Tensor, gu: QTensor, dn: QTensor, act: str) -> torch.Tensor:
    """Plain version: x [b, E] f32 -> [b, E] f32."""
    F = dn.k
    gate_up = qmm_w4_plain(x, gu)
    g, u = gate_up[:, :F], gate_up[:, F:]
    h = (ACTIVATIONS[act](g) * u).to(torch.bfloat16).to(torch.float32)
    return qmm_w4_plain(h, dn)


def ffn_eligible(gu, dn, act: str) -> bool:
    """Kernel 2 takes these weights: both W4 folds of the same
    compact / non-compact flavor, at shapes it tiles (mirrors the JAX
    qmm_w4_ffn_or_none's refusals).  Precise (W4X) folds are declined, as
    the JAX megakernel declines them (``qmm_w4_ffn.py:101``): kernel 2's
    single-plane activations would serve them at W4 fidelity."""
    try:
        _check_shapes(gu, dn, act)
    except ValueError:
        return False
    return True


def _check_shapes(gu: QTensor, dn: QTensor, act: str) -> None:
    require(is_w4(gu) and is_w4(dn), "qmm_w4_ffn_matmul needs W4 folds")
    require(act in ACTS, f"activation {act!r} not in {sorted(ACTS)}")
    E, F = dn.shape
    require(gu.shape == (2 * F, E), f"gate|up {gu.shape} does not match down {dn.shape}")
    require(gu.k_pad == E and E % 1024 == 0, "E must be a multiple of 1024, unpadded")
    require(dn.k_pad == F and F % SPAN == 0, "F must be a multiple of 256, unpadded")
    require((gu.aux["flavor"] == "compact") == (dn.aux["flavor"] == "compact"),
            "gate|up and down must share the compact / non-compact flavor")


def qmm_w4_ffn_matmul(x: torch.Tensor, gu: QTensor, dn: QTensor, *,
                      act: str = "silu") -> torch.Tensor:
    """x [..., E] -> act(x gate^T) * (x up^T) @ down^T as [..., E] f32, for
    at most 32 rows; gu is the fused [gate; up] fold [2F, E]."""
    global LAUNCHES
    _check_shapes(gu, dn, act)
    E, F = dn.shape
    lead = x.shape[:-1]
    b = math.prod(lead)
    require(x.shape[-1] == E, f"x has k={x.shape[-1]}, FFN E={E}")
    require(1 <= b <= MAX_ROWS, f"{b} rows: kernel 2 takes 1..{MAX_ROWS}")
    x2 = x.reshape(b, E).to(torch.float32)
    if not is_cuda(x2):
        return qmm_w4_ffn_plain(x2, gu, dn, act).reshape(*lead, E)
    x2 = x2.contiguous()
    check_w4_on(gu, x2.device)
    check_w4_on(dn, x2.device)
    x8, sx, xsum = quantize_q8_cuda(x2)
    partial = torch.empty((F // SPAN, b, E), dtype=torch.float32, device=x2.device)
    y = torch.empty((b, E), dtype=torch.float32, device=x2.device)
    g_codes, g_q6, g_dd, g_gs, g_gm, compact = gemv_args(gu)
    d_codes, d_q6, d_dd, d_gs, d_gm, _ = gemv_args(dn)
    _build.check(_build.lib().lk_w4_ffn(
        x8.data_ptr(), sx.data_ptr(), xsum.data_ptr(), b,
        g_codes, g_q6, g_dd, g_gs, g_gm, d_codes, d_q6, d_dd, d_gs, d_gm,
        E, F, compact, ACTS[act], partial.data_ptr(), y.data_ptr(),
        _build.stream()), "lk_w4_ffn")
    LAUNCHES += 1
    return y.reshape(*lead, E)
