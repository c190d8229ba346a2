"""QTensor: the quantized [n, k] weight, as torch tensors.

Same fields and formula as ``llama_kotlin_tpu/quant/qtensor.py``:

    value[n, k] = (codes[n, k] - code_offset) * eff_scale[n, g] - eff_min[n, g]

The port serves the W4 fold only (``quant/fold.py``): 4-bit plane-packed
codes where byte j of span s holds element 256s+j in its low nibble (raw
code 0..15) and element 256s+128+j in its high nibble stored pre-signed
(q-8, two's complement) — ``hi_signed``.  ``g_scale``/``g_min`` hold the
f32 effective scale and the adjusted min m_adj per 32-group (hi groups
carry m_eff - 8*s_eff, so that (q-8)*s - m_adj = q*s - m_eff).

``aux`` holds the port's own streamed planes for the decode kernels; see
``quant/fold.py`` for their layout.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType

SPAN = 256  # elements per packing span (= QK_K superblock)


@dataclass
class QTensor:
    """Quantized 2-D tensor [n, k] (row-major; k is the contraction axis)."""

    codes: torch.Tensor  # [n, k_pad // 2] uint8 plane-packed nibbles
    g_scale: torch.Tensor  # [n, k_pad // group_size] f32
    g_min: Optional[torch.Tensor]  # [n, k_pad // group_size] f32 or None
    sb_scale: Optional[torch.Tensor]  # unused by the W4 fold (None)
    sb_min: Optional[torch.Tensor]
    qtype: GGMLQuantType
    bits: int
    group_size: int
    code_offset: int
    shape: tuple[int, int]  # logical (n, k)
    hi_signed: bool = False
    tp_axis: Optional[int] = None
    aux: Optional[dict] = None

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def k_pad(self) -> int:
        return self.codes.shape[-1] * (8 // self.bits)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def tensors(self) -> dict:
        """Every tensor this QTensor holds (fields and aux), by name."""
        out = {k: getattr(self, k) for k in
               ("codes", "g_scale", "g_min", "sb_scale", "sb_min")}
        for k, v in (self.aux or {}).items():
            out["aux." + k] = v
        return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}

    def to(self, device) -> "QTensor":
        mv = lambda t: t.to(device) if isinstance(t, torch.Tensor) else t
        aux = None if self.aux is None else {k: mv(v) for k, v in self.aux.items()}
        return replace(self, codes=mv(self.codes), g_scale=mv(self.g_scale),
                       g_min=mv(self.g_min), sb_scale=mv(self.sb_scale),
                       sb_min=mv(self.sb_min), aux=aux)

    def rows(self, ids: torch.Tensor) -> "QTensor":
        """Gathered rows, without aux (the embedding path dequantizes them)."""
        pick = lambda t: None if t is None else t[ids]
        return replace(self, codes=self.codes[ids], g_scale=self.g_scale[ids],
                       g_min=pick(self.g_min), sb_scale=pick(self.sb_scale),
                       sb_min=pick(self.sb_min), shape=(int(ids.shape[0]), self.k),
                       aux=None)


def unpack_codes(qt: QTensor) -> torch.Tensor:
    """Unpack the W4 fold's plane codes to int32 [n, k_pad] in element order
    (lo plane 0..15, hi plane q-8)."""
    if not (qt.bits == 4 and qt.hi_signed):
        raise ValueError("the port serves the hi_signed 4-bit W4 fold only")
    c = qt.codes
    n = c.shape[0]
    half = SPAN // 2
    spans = c.shape[-1] // half
    b = c.reshape(n, spans, half)
    lo = (b & 0x0F).to(torch.int32)
    # high nibble holds (q-8) in two's complement: arithmetic shift on
    # int8 sign-extends it to [-8, 7]
    hi = (b.view(torch.int8) >> 4).to(torch.int32)
    return torch.cat([lo, hi], dim=-1).reshape(n, spans * SPAN)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization to [n, k] (reference path; kernels fuse this).
    Same f32 operation order as the JAX package: (q - off) * s, then - m.
    The W4 fold has no superblock scales, so s and m are g_scale, g_min."""
    codes = unpack_codes(qt)
    g = qt.group_size
    w = (codes - qt.code_offset).to(torch.float32) * qt.g_scale.repeat_interleave(g, dim=-1)
    w = w - qt.g_min.repeat_interleave(g, dim=-1)
    return w[:, : qt.k].to(dtype)
