"""Wire format -> QTensor repacking, in torch (port of
``llama_kotlin_tpu/quant/repack.py`` and the matching decoders of
``quant/numpy_ref.py``).

Everything here runs on the device the wire bytes are on: on the card a
whole 8B file repacks in seconds, on the CPU the tests' files do.  The bit
logic and the f32 operation order are the JAX package's, so both give the
same codes and scales bit for bit.

Ported formats: F32, F16, BF16 (float decode), Q8_0, Q4_K and Q6_K.  The
other wire formats raise NotImplementedError until their item of
ROADMAP.md (section 1, item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llama_kotlin_tpu_torch.quant.formats import QK_K, TYPE_TRAITS, GGMLQuantType
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor, dequantize

NOT_PORTED = ("not ported yet (the wire formats beyond Q8_0/Q4_K/Q6_K come with "
              "ROADMAP.md section 1, item 6)")


def _wire_blocks(data: torch.Tensor, qtype: GGMLQuantType, n: int, k: int) -> torch.Tensor:
    """Flat uint8 wire bytes -> [n, k / block_size, type_size]."""
    tr = TYPE_TRAITS[qtype]
    data = data.reshape(-1)
    expect = n * (k // tr.block_size) * tr.type_size
    if data.dtype != torch.uint8 or data.numel() != expect or k % tr.block_size:
        raise ValueError(f"wire bytes {tuple(data.shape)} {data.dtype} do not hold "
                         f"{tr.name} [{n},{k}] ({expect} bytes)")
    return data.reshape(n, k // tr.block_size, tr.type_size)


def _f16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian byte pairs [..., 2] -> f32 [...].  The pair sits inside
    a block, so it is made contiguous before the dtype view."""
    return b.contiguous().view(torch.float16).squeeze(-1).to(torch.float32)


def _k_pad_of(k: int) -> int:
    return (k + SPAN - 1) // SPAN * SPAN


def _pad_k(a: torch.Tensor, cols: int) -> torch.Tensor:
    """Zero-pad the trailing axis to `cols` columns."""
    return a if a.shape[-1] == cols else F.pad(a, (0, cols - a.shape[-1]))


def _pack4(codes: torch.Tensor) -> torch.Tensor:
    """uint4 codes [n, k_pad] -> plane-packed bytes [n, k_pad // 2]: byte j
    of span s holds element 256s+j low and element 256s+128+j high."""
    n, k = codes.shape
    c = codes.reshape(n, k // SPAN, 2, SPAN // 2).to(torch.uint8)
    return (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, k // 2)


def _make(qtype, codes, bits, group_size, n, k, g_scale, g_min=None,
          sb_scale=None, sb_min=None) -> QTensor:
    k_pad = _k_pad_of(k)
    packed = _pack4(_pad_k(codes, k_pad)) if bits == 4 else _pad_k(codes, k_pad)
    pad = lambda a, g: None if a is None else _pad_k(a, k_pad // g)
    return QTensor(codes=packed.contiguous(), g_scale=pad(g_scale, group_size),
                   g_min=pad(g_min, group_size), sb_scale=pad(sb_scale, SPAN),
                   sb_min=pad(sb_min, SPAN), qtype=qtype, bits=bits,
                   group_size=group_size, code_offset=0, shape=(n, k))


def unpack_scale_min_k4(s: torch.Tensor):
    """12 packed bytes [..., 12] -> (8 six-bit scales, 8 six-bit mins) as
    uint8 [..., 8] (get_scale_min_k4)."""
    sc = torch.cat([s[..., 0:4] & 63, (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)], -1)
    mn = torch.cat([s[..., 4:8] & 63, (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)], -1)
    return sc, mn


def repack_q8_0(data, n: int, k: int) -> QTensor:
    b = _wire_blocks(data, GGMLQuantType.Q8_0, n, k)
    d = _f16(b[:, :, 0:2])  # [n, k/32]
    codes = b[:, :, 2:34].contiguous().view(torch.int8).reshape(n, k)
    return _make(GGMLQuantType.Q8_0, codes, 8, 32, n, k, g_scale=d)


def repack_q4_k(data, n: int, k: int) -> QTensor:
    b = _wire_blocks(data, GGMLQuantType.Q4_K, n, k)
    nsb = k // QK_K
    d = _f16(b[:, :, 0:2])  # [n, nsb]
    dmin = _f16(b[:, :, 2:4])
    sc, mn = unpack_scale_min_k4(b[:, :, 4:16])  # [n, nsb, 8]
    qs = b[:, :, 16:144].reshape(n, nsb, 4, 1, 32)
    # 32-byte chunk j -> elements 64j..64j+31 (low nibbles), +32.. (high)
    codes = torch.cat([qs & 0x0F, qs >> 4], dim=3).reshape(n, k)
    return _make(GGMLQuantType.Q4_K, codes, 4, 32, n, k, g_scale=sc.reshape(n, -1),
                 g_min=mn.reshape(n, -1), sb_scale=d, sb_min=dmin)


def repack_q6_k(data, n: int, k: int) -> QTensor:
    b = _wire_blocks(data, GGMLQuantType.Q6_K, n, k)
    nsb = k // QK_K
    ql = b[:, :, 0:128].reshape(n, nsb, 2, 2, 32)  # [half, lo/hi 32 bytes]
    qh = b[:, :, 128:192].reshape(n, nsb, 2, 32)
    scales = b[:, :, 192:208].contiguous().view(torch.int8)
    d = _f16(b[:, :, 208:210])
    q = torch.stack([
        (ql[:, :, :, 0] & 0x0F) | ((qh & 0x03) << 4),
        (ql[:, :, :, 1] & 0x0F) | (((qh >> 2) & 0x03) << 4),
        (ql[:, :, :, 0] >> 4) | (((qh >> 4) & 0x03) << 4),
        (ql[:, :, :, 1] >> 4) | (((qh >> 6) & 0x03) << 4),
    ], dim=3)  # [n, nsb, half, 4, 32] -> element 128*half + 32*i + l
    codes = (q.to(torch.int16) - 32).to(torch.int8).reshape(n, k)
    return _make(GGMLQuantType.Q6_K, codes, 8, 16, n, k, g_scale=scales.reshape(n, -1),
                 sb_scale=d)


REPACKERS = {
    GGMLQuantType.Q8_0: repack_q8_0,
    GGMLQuantType.Q4_K: repack_q4_k,
    GGMLQuantType.Q6_K: repack_q6_k,
}


def repack(data: torch.Tensor, qtype: GGMLQuantType, n: int, k: int) -> QTensor:
    """Wire bytes of an [n, k] row-major tensor -> a QTensor on their device."""
    if qtype not in REPACKERS:
        raise NotImplementedError(f"repack of {GGMLQuantType(qtype).name}: {NOT_PORTED}")
    return REPACKERS[qtype](data, n, k)


def dequantize_wire(data: torch.Tensor, qtype: GGMLQuantType, shape: tuple) -> torch.Tensor:
    """Wire bytes -> f32 tensor of `shape` (row-major, innermost = ggml ne[0]).
    Quantized formats decode through their repack: the same f32 products
    (and differences) as the wire decoders, in the same order."""
    data = data.reshape(-1)
    if qtype == GGMLQuantType.F32:
        return data.contiguous().view(torch.float32).reshape(shape).clone()
    if qtype == GGMLQuantType.F16:
        return data.contiguous().view(torch.float16).to(torch.float32).reshape(shape)
    if qtype == GGMLQuantType.BF16:
        return data.contiguous().view(torch.bfloat16).to(torch.float32).reshape(shape)
    k = shape[-1]
    n = data.numel() // (k // TYPE_TRAITS[qtype].block_size * TYPE_TRAITS[qtype].type_size)
    return dequantize(repack(data, qtype, n, k)).reshape(shape)


# -- Q8F fast-mode conversion ------------------------------------------------

def float_to_q8flat(x: torch.Tensor) -> QTensor:
    """float [n, k] -> flat int8 codes with one f32 scale per 256-superblock
    (the int8 fast mode's layout, served by kernel 6)."""
    n, k = x.shape
    k_pad = _k_pad_of(k)
    xr = _pad_k(x.to(torch.float32), k_pad).reshape(n, k_pad // SPAN, SPAN)
    amax = xr.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true division the codes need
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(xr / safe[..., None]), -127, 127).to(torch.int8)
    return QTensor(codes=codes.reshape(n, k_pad), g_scale=scale, g_min=None,
                   sb_scale=None, sb_min=None, qtype=GGMLQuantType.Q8_0, bits=8,
                   group_size=SPAN, code_offset=0, shape=(n, k), aux={"flavor": "q8f"})


def repack_q8flat(data: torch.Tensor, qtype: GGMLQuantType, n: int, k: int) -> QTensor:
    """Wire format -> Q8F: decode to f32, then requantize flat int8."""
    return float_to_q8flat(dequantize_wire(data, qtype, (n, k)))
