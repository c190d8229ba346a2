"""Kernel 10: the post-attention half of a llama layer in one launch, for
decode rows (``csrc/qmm_w4_layer.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::_qmm_w4_layer``
(entry ``qmm_w4_layer_matmul``, reached through ``ops/qmatmul.py::
qmm_layer`` under ``LKTPU_LAYER_FUSED=1``):

    h2 = h + bf16(W4A8(attn) Wo^T)
    h3 = h2 + bf16(FFN(rms_norm(h2)))

with the o projection as kernel 1 computes it, the norm op for op as
``ops/norms.rms_norm`` (1/sqrt, two products, the output rounded to h's
dtype) and the FFN as kernel 2 computes it.  Bound on the H100: bytes (Wo,
gate|up and down once); the CUDA source runs it as one cooperative launch
with grid-wide barriers between the stages.

``layer_eligible`` mirrors the JAX entry's refusals (``qmm_w4_ffn.py:
603-646``); an ineligible layer takes the unfused route, which is the
JAX package's own semantics.  ``qmm_w4_layer_matmul`` raises on what
``layer_eligible`` refuses; ``fused_layer`` is the same call for operands
already checked (``ops/qmatmul.py::qmm_layer``).  Both launch the kernel
for CUDA tensors and run ``qmm_w4_layer_plain`` for CPU tensors.
"""

from __future__ import annotations

import math
import os

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda._checks import check_w4_on
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import gemv_args, qmm_w4_plain
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import (ACTS, coop_fits, qmm_w4_ffn_plain,
                                                        workspace_bytes)
from llama_kotlin_tpu_torch.ops.norms import rms_norm
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import QTensor

MAX_ROWS = 8  # the JAX entry's max_rows
LAUNCHES = 0  # kernel launches made by qmm_w4_layer_matmul


def _refusal(attn: torch.Tensor, h: torch.Tensor, wo, gu, dn, act: str):
    """Why kernel 10 does not take these operands (None when it does), in
    the order of the JAX entry's checks."""
    if act not in ACTS:
        return f"activation {act!r}"
    if not all(is_w4(w) for w in (wo, gu, dn)):
        return "every weight must be a (non-precise) W4 fold"
    E = wo.shape[1]
    if wo.shape != (E, E) or wo.k_pad != E:
        return f"o {wo.shape} is not square and unpadded"
    if gu.shape[1] != E or dn.shape[0] != E:
        return "gate|up and down do not match o's width"
    if E % 2048 or E < 2048:
        return f"E={E} is not a multiple of 2048"
    F = dn.k_pad
    if gu.n != 2 * F:
        return "gate|up is not the fused [gate; up] of down's width"
    compact = wo.flavor == "compact"
    if (gu.flavor == "compact") != compact or (dn.flavor == "compact") != compact:
        return "o, gate|up and down mix compact and non-compact folds"
    if (wo.flavor == "sym") != (gu.flavor == "sym"):
        return "o and gate|up differ in the sym flavor"
    if os.environ.get("LKTPU_W4_BCAST", "0") == "1":
        return "LKTPU_W4_BCAST=1"
    if F % 1024:
        return f"F={F} is not a multiple of 1024"
    b = math.prod(attn.shape[:-1])
    if attn.shape[-1] != E or h.shape != attn.shape or b > MAX_ROWS:
        return f"{b} rows of width {attn.shape[-1]} (at most {MAX_ROWS} of {E}, h alike)"
    if not coop_fits(b, E, F):  # the port's own limit, past every llama3 width
        return f"{b} rows of E={E}, F={F} overflow a block's shared memory"
    return None


def layer_eligible(attn: torch.Tensor, h: torch.Tensor, wo, gu, dn, act: str = "silu") -> bool:
    """Kernel 10 takes these operands: wo [E, E], the fused gate|up
    [2F, E] and down [E, F] W4 folds, all compact or none, o's sym flavor
    equal to gate|up's, E % 2048 == 0, F % 1024 == 0, at most 8 rows and
    silu or gelu (the JAX entry's refusals; precise folds are not W4
    folds, and the port has no stacked or sharded QTensor); and rows and
    widths whose activations fit a block's shared memory (coop_fits: all
    8 rows up to F ~ 23K, so every llama3-8B layer)."""
    return _refusal(attn, h, wo, gu, dn, act) is None


def qmm_w4_layer_plain(attn: torch.Tensor, h: torch.Tensor, wo: QTensor, gu: QTensor,
                       dn: QTensor, norm_w: torch.Tensor, eps: float, act: str,
                       offset: float = 0.0) -> torch.Tensor:
    """Plain version: the port's plain o, norm and FFN in the kernel's
    arithmetic; attn, h [b, E] -> h3 [b, E] in h's dtype."""
    o = qmm_w4_plain(attn.to(torch.float32), wo)
    h2 = h + o.to(h.dtype)
    r = rms_norm(h2, norm_w, eps, offset)
    return h2 + qmm_w4_ffn_plain(r.to(torch.float32), gu, dn, act).to(h.dtype)


def qmm_w4_layer_matmul(attn: torch.Tensor, h: torch.Tensor, wo: QTensor, gu: QTensor,
                        dn: QTensor, norm_w: torch.Tensor, *, eps: float, act: str = "silu",
                        offset: float = 0.0) -> torch.Tensor:
    """h3 = h2 + FFN(rms_norm(h2)), h2 = h + attn @ Wo^T, for at most 8 rows
    (attn, h [..., E]); h3 in h's dtype.  Raises on operands that
    layer_eligible refuses."""
    why = _refusal(attn, h, wo, gu, dn, act)
    require(why is None, f"qmm_w4_layer_matmul: {why}")
    return fused_layer(attn, h, wo, gu, dn, norm_w, eps=eps, act=act, offset=offset)


def fused_layer(attn: torch.Tensor, h: torch.Tensor, wo: QTensor, gu: QTensor, dn: QTensor,
                norm_w: torch.Tensor, *, eps: float, act: str = "silu",
                offset: float = 0.0) -> torch.Tensor:
    """qmm_w4_layer_matmul for operands that layer_eligible has taken."""
    global LAUNCHES
    E, F = dn.shape[0], dn.k_pad
    lead = attn.shape[:-1]
    b = math.prod(lead)
    a2, h2d = attn.reshape(b, E), h.reshape(b, E)
    if not is_cuda(a2):
        return qmm_w4_layer_plain(a2, h2d, wo, gu, dn, norm_w, eps, act,
                                  offset).reshape(*lead, E)
    require(a2.dtype == torch.bfloat16 and h2d.dtype == torch.bfloat16,
            "kernel 10 takes bf16 attn and h")
    a2, h2d = a2.contiguous(), h2d.contiguous()
    nw = norm_w.to(device=a2.device, dtype=torch.float32).contiguous()
    require(nw.shape == (E,), f"norm weight {tuple(nw.shape)}, expected ({E},)")
    for w in (wo, gu, dn):
        check_w4_on(w, a2.device)
    dev = a2.device
    h2 = torch.empty((b, E), dtype=torch.bfloat16, device=dev)
    work = torch.empty(workspace_bytes(b, E, F, 0, 0), dtype=torch.uint8, device=dev)
    out = torch.empty((b, E), dtype=torch.bfloat16, device=dev)
    folds = (wo, gu.row_slice(0, F), gu.row_slice(F, 2 * F), dn)  # o, gate, up, down
    _build.check(_build.lib().lk_w4_layer(
        a2.data_ptr(), h2d.data_ptr(), nw.data_ptr(), b,
        *(p for w in folds for p in gemv_args(w)[:5]), E, F,
        int(wo.flavor == "compact"), int(all(w.flavor == "sym" for w in (wo, gu, dn))),
        ACTS[act], float(eps), float(offset), h2.data_ptr(), work.data_ptr(), out.data_ptr(),
        _build.stream()),
        "lk_w4_layer")
    LAUNCHES += 1
    return out.reshape(*lead, E)
