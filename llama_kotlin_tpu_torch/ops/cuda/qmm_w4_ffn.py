"""Kernel 2: the decode-row gated FFN (``csrc/qmm_w4_ffn.cu``, its
cooperative stages ``csrc/w4_coop.cuh``, above T2 kernel 1's tile
``csrc/w4_mma.cuh``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::qmm_w4_ffn`` (entry
``qmm_w4_ffn_matmul``) in both of its layouts: the fused [gate; up] fold
[2F, E], or (``up=``) separate gate [F, E] and up [F, E] folds:
y = (act(x Wg^T) * (x Wu^T)) Wd^T with x quantized per 256, h rounded to
bf16 and re-quantized per 256 before the down product.  Bound on the
H100: bytes (the three weight matrices).  Up to ``MMA_MIN_ROWS`` (T2)
rows one cooperative launch runs the whole FFN; more rows take kernel 1's
int8 tile for gate|up (h formed in its epilogue) and for down.  See the
CUDA source for the design.

``qmm_w4_ffn_matmul`` launches the kernel for CUDA tensors and runs
``qmm_w4_ffn_plain`` for CPU tensors; it raises on operands that
``ffn_eligible`` refuses (the JAX entry's refusals).
"""

from __future__ import annotations

import functools
import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda._checks import check_w4_on
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_W4, plan, sm_count
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import MAX_ROWS, MMA_BM, gemv_args, qmm_w4_plain
from llama_kotlin_tpu_torch.quant.fold import is_w4
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

ACTS = {"silu": 0, "gelu": 1}  # the kernel's activation codes
LAUNCHES = 0  # calls of qmm_w4_ffn_matmul that launched kernel 2
LAUNCHES_MMA = 0  # of which took kernel 1's tile (above T2)
# T2: rows up to it take the cooperative launch, more rows kernel 1's tile
# (csrc/qmm_w4_ffn.cu's FFN_COOP_ROWS, which refuses the launch above it)
MMA_MIN_ROWS = 8
# T10: the cooperative stages of kernels 2 and 10 walk up to this many rows
# and run more on int8 tensor cores (csrc/w4_coop.cuh's WALK_ROWS)
COOP_WALK_ROWS = 1
COOP_MAX_ROWS = 8  # the cooperative stages' rows (the mma's n)
SMEM_MAX = 232448  # the H100's shared memory a block can opt into


def qmm_w4_ffn_plain(x: torch.Tensor, gu: QTensor, dn: QTensor, act: str,
                     up: QTensor | None = None) -> torch.Tensor:
    """Plain version: x [b, E] f32 -> [b, E] f32 (gu the fused [gate; up],
    or the gate when up is given)."""
    F = dn.k
    if up is None:
        gate_up = qmm_w4_plain(x, gu)
        g, u = gate_up[:, :F], gate_up[:, F:]
    else:
        g, u = qmm_w4_plain(x, gu), qmm_w4_plain(x, up)
    h = (ACTIVATIONS[act](g) * u).to(torch.bfloat16).to(torch.float32)
    return qmm_w4_plain(h, dn)


def _refusal(gu, dn, act: str, up=None) -> str | None:
    """Why kernel 2 does not take these weights (None when it does), in the
    order of the JAX entry's checks (``qmm_w4_ffn.py:97-151``)."""
    if act not in ACTS:
        return f"activation {act!r} not in {sorted(ACTS)}"
    if not all(is_w4(w) for w in (gu, dn) + (() if up is None else (up,))):
        return "every weight must be a (non-precise) W4 fold"
    E, F = gu.shape[1], dn.k_pad
    if dn.shape[0] != E:
        return f"gate|up {gu.shape} and down {dn.shape} differ in E"
    if gu.k_pad != E or E % 1024:
        return f"E={E} must be a multiple of 1024, unpadded"
    if up is None and gu.n != 2 * F:
        return f"gate|up {gu.shape} is not the fused [gate; up] of down's width {F}"
    if up is not None and (gu.n != F or up.n != F or up.shape != gu.shape):
        return f"gate {gu.shape} and up {up.shape} are not [{F}, {E}] each"
    compact = gu.flavor == "compact"
    if (dn.flavor == "compact") != compact or (up is not None and
                                               (up.flavor == "compact") != compact):
        return "gate, up and down mix compact and non-compact folds"
    if compact and E < 2048:
        return f"compact E={E} is under 2048"
    if F % 1024:
        return f"F={F} is not a multiple of 1024"
    if up is not None and (up.flavor == "sym") != (gu.flavor == "sym"):
        return "gate and up differ in the sym flavor"
    return None


def ffn_eligible(gu, dn, act: str = "silu", up=None) -> bool:
    """Kernel 2 takes these weights: W4 folds (never precise ones: the JAX
    megakernel declines them, ``qmm_w4_ffn.py:101``), all compact or none,
    E % 1024 == 0 unpadded (compact: E >= 2048), F % 1024 == 0, gate|up the
    fused [2F, E] or gate and up [F, E] each of one sym flavor, silu or gelu
    (the JAX entry's refusals)."""
    return _refusal(gu, dn, act, up) is None


def use_mma(b: int) -> bool:
    """Whether b rows take kernel 1's tile (else the cooperative launch)."""
    return b > MMA_MIN_ROWS


def coop_smem(b: int, E: int, F: int) -> int:
    """Shared memory of a cooperative block (``w4_coop.cuh::Smem::bytes``)
    for b rows: the activations of the wider of E and F, the tensor cores'
    reduction buffers above T10, the norm sums."""
    mma = b > COOP_WALK_ROWS
    # the walk's batch-row bucket (csrc/w4_dot.cuh::nb_bucket), or the mma's 8 rows
    nr, pad, spad = (COOP_MAX_ROWS, 32, 4) if mma else (1 << (b - 1).bit_length(), 0, 0)
    k = max(E, F)
    return (nr * (k + pad) + nr * (k // SPAN + spad) * 4 + nr * (k // 32 + spad) * 4
            + (2 * 16 * 128 * 4 if mma else 0) + (16 * nr + nr) * 4)


def coop_fits(b: int, E: int, F: int) -> bool:
    """The cooperative stages take b rows at these widths."""
    return b <= COOP_MAX_ROWS and coop_smem(b, E, F) <= SMEM_MAX


@functools.lru_cache(maxsize=None)
def workspace_bytes(b: int, E: int, F: int, splits_gu: int, splits_dn: int) -> int:
    """Scratch bytes of one launch (the C entry's own count)."""
    n = _build.lib().lk_w4_ffn_workspace(b, E, F, splits_gu, splits_dn)
    require(n > 0, f"lk_w4_ffn takes no {b} rows of E={E} F={F}")
    return n


def qmm_w4_ffn_matmul(x: torch.Tensor, gu: QTensor, dn: QTensor, *, act: str = "silu",
                      up: QTensor | None = None) -> torch.Tensor:
    """x [..., E] -> act(x gate^T) * (x up^T) @ down^T as [..., E] f32, for
    at most 32 rows; gu is the fused [gate; up] fold [2F, E], or the gate
    [F, E] when up is given."""
    global LAUNCHES, LAUNCHES_MMA
    why = _refusal(gu, dn, act, up)
    require(why is None, f"qmm_w4_ffn_matmul: {why}")
    E, F = dn.shape
    lead = x.shape[:-1]
    b = math.prod(lead)
    require(x.shape[-1] == E, f"x has k={x.shape[-1]}, FFN E={E}")
    require(1 <= b <= MAX_ROWS, f"{b} rows: kernel 2 takes 1..{MAX_ROWS}")
    x2 = x.reshape(b, E).to(torch.float32)
    if not is_cuda(x2):
        return qmm_w4_ffn_plain(x2, gu, dn, act, up).reshape(*lead, E)
    x2 = x2.contiguous()
    dev = x2.device
    for w in (gu, dn) + (() if up is None else (up,)):
        check_w4_on(w, dev)
    gate, upp = (gu.row_slice(0, F), gu.row_slice(F, 2 * F)) if up is None else (gu, up)
    tile = use_mma(b) or not coop_fits(b, E, F)
    splits_gu = splits_dn = 0
    cnt = None
    if tile:
        sms = sm_count(dev.index or 0)
        splits_gu = plan(1, 2 * F, E, UNIT_W4, sms, bms=(MMA_BM,)).splits
        splits_dn = plan(1, E, F, UNIT_W4, sms, bms=(MMA_BM,)).splits
        cnt = _build.split_counters(dev, max(2 * F, E) // 128)
    work = torch.empty(workspace_bytes(b, E, F, splits_gu, splits_dn), dtype=torch.uint8,
                       device=dev)
    y = torch.empty((b, E), dtype=torch.float32, device=dev)
    folds = (gu, dn) + (() if up is None else (up,))
    _build.check(_build.lib().lk_w4_ffn(
        x2.data_ptr(), b, *gemv_args(gate)[:5], *gemv_args(upp)[:5], *gemv_args(dn)[:5], E, F,
        int(gu.flavor == "compact"), int(all(w.flavor == "sym" for w in folds)), ACTS[act],
        splits_gu, splits_dn, work.data_ptr(), _build.ptr(cnt), y.data_ptr(),
        _build.stream()), "lk_w4_ffn")
    LAUNCHES += 1
    LAUNCHES_MMA += int(tile)
    return y.reshape(*lead, E)
