"""Kernel 4: fused dequantize-matmul for prefill rows over a W4 or W8 fold
(``csrc/qmm.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm.py::qmm`` on the W4 fold and,
in its ``bits == 8`` branch, on the W8 fold (entry ``qmm_pallas_or_none``);
the W4X mode's precise folds take the same branches with their f32 scales
read as stored (``qmm.py:201`` takes any hi_signed W4 layout):
y = x W^T with w = plane * g_scale - g_min (W4) or code * s_eff (- m_eff)
(W8) formed in f32 and rounded to bf16, x in bf16, f32 accumulation — the
operands the Pallas kernel feeds its dot.  Bound on the H100: bytes at 64
rows; the dequantized tile lives only in registers.  See the CUDA source.

``plan`` chooses the kernel's tiling on the host: the row tile, and how
many ranges K is split into so that every projection fills the card's
SMs; ``split_bounds`` is the K range of each split, as the kernel computes
it.  Kernel 7's tensor-core path (``ops/cuda/qmm_w4x.py``) takes the same
plan.

``qmm`` launches the kernel for CUDA tensors and runs ``qmm_plain`` for CPU
tensors.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.ops.cuda._checks import check_int8_on, check_w4_on
from llama_kotlin_tpu_torch.quant.fold import is_w4, is_w4x, is_w8, is_w8x
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, dequantize

LAUNCHES = 0  # kernel launches made by qmm (both branches)
LAUNCHES_W8 = 0  # of which on the 8-bit branch
PLAIN_CHUNK = 8192  # output rows per step of the plain version
BN = 128  # weight rows (output columns) a block
BMS = (32, 64, 128)  # the row tiles the kernel takes
UNIT_W4, UNIT_W8 = 256, 64  # K elements a split unit: a W4 span, a W8 step of whole groups
# the split choice's cost model: a block of 64 rows spends ~4.8 us a
# 256-element unit, the last block's sum ~1 us a split, and an SM runs 2
# blocks at once (the launch bounds' floor at 64 rows, the row tile that
# splits K at 33-100 rows; 3 at 32 rows, 1 at 128).  Set by hand on the
# H100; scripts/qmm_ab.py times its choice against the least split count
# that fills the card and twice that (PERF.md, kernel 4: 7-31% faster than
# the least at qkv, o and down, never slower than either)
UNIT_US, SUM_US, RESIDENT = 4.8, 1.0, 2


@dataclass(frozen=True)
class Plan:
    bm: int  # rows a block
    splits: int  # K ranges, each summed by its own blocks
    units: int  # K / unit
    tiles: int  # output tiles (row tiles x column tiles)

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def plan(m: int, n: int, k: int, unit: int, sms: int, bms=BMS) -> Plan:
    """The kernel's tiling for y[m, n] = x[m, k] @ W^T on a card with `sms`
    SMs.  Row tiles of 128 where the rows fill the card with them (long
    prompts reuse each dequantized weight tile over more rows), else 64;
    32 for at most 32 rows, or where 64 leaves SMs idle with K split in
    every unit (a W4 matrix of 1024 rows).  Where the tiles alone leave SMs
    idle, K is split in whole units (``UNIT_W4``/``UNIT_W8``) into at
    least enough ranges for a block on every SM, the count chosen by a
    cost model of the slowest SM's units and the last block's sum."""
    require(m >= 1 and n >= 1 and sms >= 1, f"bad plan request m={m} n={n} sms={sms}")
    require(k >= unit and k % unit == 0, f"k={k} is not a multiple of the {unit}-element unit")
    col, units = -(-n // BN), k // unit
    tiles = lambda bm: -(-m // bm) * col
    big, mid, small = max(bms), sorted(bms)[len(bms) // 2], min(bms)
    if m >= 2 * big and tiles(big) >= sms:
        bm = big
    elif m > small and tiles(mid) * units >= sms:
        bm = mid
    else:
        bm = small
    splits = 1
    if tiles(bm) < sms and n % 4 == 0:  # the fixed-order sum reads float4 rows
        # the slowest SM walks ceil(blocks / sms) blocks of ceil(units /
        # splits) units, all of them resident; each split adds to the last
        # block's sum
        cost = lambda s: (-(-tiles(bm) * s // sms) * -(-units // s) * unit / 256 * UNIT_US
                          + s * SUM_US)
        need = -(-sms // tiles(bm))
        fits = [s for s in range(need, units + 1) if tiles(bm) * s <= RESIDENT * sms]
        splits = min(fits, key=cost) if fits else min(need, units)
    return Plan(bm=bm, splits=splits, units=units, tiles=tiles(bm))


def split_bounds(units: int, splits: int) -> list[tuple[int, int]]:
    """[u0, u1) of each split, in units: the kernel's split_range."""
    return [(z * units // splits, (z + 1) * units // splits) for z in range(splits)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_workspace(p: Plan, rows: int, n: int, device: torch.device):
    """(ws, counters) for a plan: the f32 partials [splits, rows, n] and the
    tiles' arrival counters, or (None, None) when K is not split."""
    if p.splits == 1:
        return None, None
    ws = torch.empty((p.splits, rows, n), dtype=torch.float32, device=device)
    return ws, _build.split_counters(device, p.tiles)


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
    """x [..., k] @ (W4, W4X, W8 or W8X) w^T -> [..., n] f32 (any number
    of rows)."""
    global LAUNCHES, LAUNCHES_W8
    w8 = is_w8(w) or is_w8x(w)
    require(is_w4(w) or is_w4x(w) or w8, "qmm needs a W4 or W8 fold, plain or precise")
    n, k = w.shape
    lead = x.shape[:-1]
    m = math.prod(lead)
    require(x.shape[-1] == k and m >= 1, f"x {tuple(x.shape)} does not fit weight k={k}")
    x2 = x.reshape(m, k)
    if not is_cuda(x2):
        return qmm_plain(x2, w).reshape(*lead, n)
    (check_int8_on if w8 else check_w4_on)(w, x2.device)
    xb = x2.to(torch.bfloat16)
    if w.k_pad != k:
        xb = torch.nn.functional.pad(xb, (0, w.k_pad - k))
    xb = xb.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    p = plan(m, n, w.k_pad, UNIT_W8 if w8 else UNIT_W4, sm_count(x2.device.index or 0))
    ws, cnt = split_workspace(p, m, n, x2.device)
    if w8:
        _build.check(_build.lib().lk_w8_dequant_gemm(
            xb.data_ptr(), w.codes.data_ptr(), w.g_scale.data_ptr(), _build.ptr(w.g_min),
            y.data_ptr(), m, n, w.k_pad, w.group_size, p.bm, p.splits, _build.ptr(ws),
            _build.ptr(cnt), _build.stream()), "lk_w8_dequant_gemm")
        LAUNCHES_W8 += 1
    else:
        _build.check(_build.lib().lk_w4_dequant_gemm(
            xb.data_ptr(), w.codes.data_ptr(), w.g_scale.data_ptr(), w.g_min.data_ptr(),
            y.data_ptr(), m, n, w.k_pad, p.bm, p.splits, _build.ptr(ws), _build.ptr(cnt),
            _build.stream()), "lk_w4_dequant_gemm")
    LAUNCHES += 1
    return y.reshape(*lead, n)
