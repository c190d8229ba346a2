"""Kernel 1: W4A8 matmul for decode rows (``csrc/qmm_w4.cu``, prologue
``csrc/q8.cu``).

Replaces ``llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4_fx2`` (entry
``qmm_w4_matmul``): raw f32 activations are quantized to int8 per
256-element superblock (amax/127, round-half-to-even), multiplied against
the W4 fold's codes with integer per-32-group partials, and the group
scales and mins apply in f32.  Bound on the H100: bytes (the weight
stream); see the CUDA source for the design.

``qmm_w4_matmul`` launches the kernel for CUDA tensors and runs
``qmm_w4_plain`` — the same function in plain PyTorch — for CPU tensors.
Nothing on the CUDA path calls the plain version.
"""

from __future__ import annotations

import math

import torch

from llama_kotlin_tpu_torch.device import is_cuda, require
from llama_kotlin_tpu_torch.ops.cuda import _build
from llama_kotlin_tpu_torch.quant.fold import GROUP, is_w4
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

MAX_ROWS = 32  # decode rows; prefill rows go to kernel 4 (ops/cuda/qmm.py)
LAUNCHES = 0  # kernel launches made by qmm_w4_matmul
PLAIN_CHUNK = 8192  # output rows per step of the plain version


# -- plain PyTorch version ---------------------------------------------------

def quantize_q8(x: torch.Tensor):
    """x [b, k] f32 (k % 256 == 0) -> (x8 int8 [b, k], sx f32 [b, k/256],
    xsum int32 [b, k/32]): the JAX package's quantize_activations plus the
    per-32-group code sums."""
    b, k = x.shape
    xr = x.to(torch.float32).reshape(b, k // SPAN, SPAN)
    amax = xr.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true division the codes need
    sx = amax / torch.full_like(amax, 127.0)
    safe = torch.where(sx > 0, sx, torch.ones_like(sx))
    x8 = torch.clamp(torch.round(xr / safe[..., None]), -127, 127).to(torch.int8)
    x8 = x8.reshape(b, k)
    xsum = x8.reshape(b, k // GROUP, GROUP).sum(dim=-1, dtype=torch.int32)
    return x8, sx, xsum


def raw_codes(w: QTensor, rows: slice) -> torch.Tensor:
    """Unsigned 4-bit codes (0..15) of w's rows, int32 [r, k_pad] in element
    order (the stored high nibble is (q-8) & 0xF, so q = nibble ^ 8)."""
    c = w.codes[rows]
    r, kc = c.shape
    b = c.reshape(r, kc // 128, 128).to(torch.int32)
    return torch.cat([b & 0x0F, (b >> 4) ^ 8], dim=-1).reshape(r, 2 * kc)


def group_scale_min(w: QTensor, rows: slice):
    """(s, m) f32 [r, G] with w = q * s - m for raw codes q: compact folds
    decode the streamed 6-bit codes (s = d*sc6, m = dmin*m6); legacy and
    sym folds take g_scale/g_min and undo the hi groups' nibble bias."""
    if w.aux["flavor"] == "compact":
        q6 = w.aux["q6"][rows].to(torch.float32)  # [r, S, 16]
        dd = w.aux["dd"][rows]  # [r, S, 2]
        r = q6.shape[0]
        s = (q6[..., :8] * dd[..., 0:1]).reshape(r, -1)
        m = (q6[..., 8:] * dd[..., 1:2]).reshape(r, -1)
        return s, m
    s = w.g_scale[rows]
    hi = (torch.arange(s.shape[1], device=s.device) % 8) >= 4
    m = w.g_min[rows] + torch.where(hi, 8.0 * s, torch.zeros_like(s))
    return s, m


def w4_dot_plain(x8, sx, xsum, w: QTensor) -> torch.Tensor:
    """The kernel's arithmetic on quantized activations: y [b, n] =
    sum_g sx * (s_g * P_g - m_g * xsum_g), P_g the exact integer partial."""
    b, k_pad = x8.shape
    G = k_pad // GROUP
    xg = x8.to(torch.float32).reshape(b, G, GROUP).transpose(0, 1)  # [G, b, 32]
    sxg = sx.repeat_interleave(SPAN // GROUP, dim=1).T[:, :, None]  # [G, b, 1]
    xs = xsum.to(torch.float32).T[:, :, None]  # [G, b, 1]
    outs = []
    for r0 in range(0, w.n, PLAIN_CHUNK):
        rows = slice(r0, min(r0 + PLAIN_CHUNK, w.n))
        q = raw_codes(w, rows).to(torch.float32)
        r = q.shape[0]
        q = q.reshape(r, G, GROUP).permute(1, 2, 0)  # [G, 32, r]
        s, m = group_scale_min(w, rows)
        p = torch.bmm(xg, q)  # [G, b, r] exact integers
        t = p * s.T[:, None, :] - xs * m.T[:, None, :]
        outs.append((t * sxg).sum(dim=0))
    return torch.cat(outs, dim=1)


def qmm_w4_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version of the whole wrapper: x [b, k_pad] f32 -> [b, n] f32."""
    return w4_dot_plain(*quantize_q8(x), w)


# -- kernel ------------------------------------------------------------------

def quantize_q8_cuda(x: torch.Tensor):
    """Prologue kernel: x [b, k] f32 contiguous on the card -> (x8, sx, xsum)."""
    b, k = x.shape
    x8 = torch.empty((b, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((b, k // SPAN), dtype=torch.float32, device=x.device)
    xsum = torch.empty((b, k // GROUP), dtype=torch.int32, device=x.device)
    _build.check(_build.lib().lk_quantize_q8(
        x.data_ptr(), x8.data_ptr(), sx.data_ptr(), xsum.data_ptr(), b, k,
        _build.stream()), "lk_quantize_q8")
    return x8, sx, xsum


def check_w4_on(w: QTensor, device: torch.device) -> None:
    """Every tensor of the fold lies on `device`, contiguous, in the dtypes
    the kernels read."""
    for name, t in w.tensors().items():
        require(t.device == device, f"W4 {name} on {t.device}, not {device}")
        require(t.is_contiguous(), f"W4 {name} is not contiguous")
    require(w.codes.dtype == torch.uint8, "W4 codes must be uint8")
    require(w.g_scale.dtype == torch.float32 and w.g_min.dtype == torch.float32,
            "W4 g_scale/g_min must be f32")
    if w.aux["flavor"] == "compact":
        require(w.aux["q6"].dtype == torch.uint8 and w.aux["dd"].dtype == torch.float32,
                "compact planes must be uint8 q6 and f32 dd")


def gemv_args(w: QTensor):
    """(codes, q6, dd, g_scale, g_min, compact) pointers for a fold."""
    compact = w.aux["flavor"] == "compact"
    return (w.codes.data_ptr(),
            _build.ptr(w.aux["q6"]) if compact else None,
            _build.ptr(w.aux["dd"]) if compact else None,
            w.g_scale.data_ptr(), w.g_min.data_ptr(), int(compact))


def qmm_w4_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., k] (float) @ W4 w^T -> [..., n] f32, for at most 32 rows."""
    global LAUNCHES
    require(is_w4(w), "qmm_w4_matmul needs a W4 fold")
    n, k = w.shape
    k_pad = w.k_pad
    lead = x.shape[:-1]
    b = math.prod(lead)
    require(x.shape[-1] == k, f"x has k={x.shape[-1]}, weight k={k}")
    require(1 <= b <= MAX_ROWS, f"{b} rows: kernel 1 takes 1..{MAX_ROWS}")
    x2 = x.reshape(b, k).to(torch.float32)
    if k_pad != k:
        x2 = torch.nn.functional.pad(x2, (0, k_pad - k))
    if not is_cuda(x2):
        return qmm_w4_plain(x2, w).reshape(*lead, n)
    x2 = x2.contiguous()
    check_w4_on(w, x2.device)
    x8, sx, xsum = quantize_q8_cuda(x2)
    y = torch.empty((b, n), dtype=torch.float32, device=x2.device)
    codes, q6, dd, gs, gm, compact = gemv_args(w)
    _build.check(_build.lib().lk_w4_gemv(
        x8.data_ptr(), sx.data_ptr(), xsum.data_ptr(), b, codes, q6, dd, gs, gm,
        n, k_pad // 2, compact, y.data_ptr(), _build.stream()), "lk_w4_gemv")
    LAUNCHES += 1
    return y.reshape(*lead, n)
