"""QTensor: the quantized [n, k] weight, as torch tensors.

Same fields and formula as ``llama_kotlin_tpu/quant/qtensor.py``:

    value[n, k] = (codes[n, k] - code_offset) * eff_scale[n, g] - eff_min[n, g]
    eff_scale   = g_scale[n, g] * sb_scale[n, k // 256]   (two-level), or g_scale
    eff_min     = g_min[n, g] * sb_min[n, k // 256]       (two-level), or g_min

A repacked wire tensor (``quant/repack.py``), the exact-dequant mode's
layout, keeps the wire's codes (8-bit, or 4- and 2-bit planes) and its
integer group scales under f32 superblock scales, with no flavor.  The layouts the port's kernels
serve carry ``aux["flavor"]``:

* W4 (``compact``/``legacy``/``sym``, ``quant/fold.py``): 4-bit
  plane-packed codes where byte j of span s holds element 256s+j in its low
  nibble (raw code 0..15) and element 256s+128+j in its high nibble stored
  pre-signed (q-8, two's complement) — ``hi_signed``.  ``g_scale``/``g_min``
  hold the f32 effective scale and the adjusted min m_adj per 32-group (hi
  groups carry m_eff - 8*s_eff, so that (q-8)*s - m_adj = q*s - m_eff).
* W4X (``w4x``/``w4x_sym``, ``fold_to_w4(precise=True)``): the legacy/sym
  W4 storage with ``g_scale``/``g_min`` the f32 s_eff and m_adj as
  computed (no bf16 rounding), so ``dequantize`` gives the source's values
  bit for bit; served with dual-plane activations.
* W8 (``w8``): int8 element-order codes, f32 s_eff per 16- or 32-group
  laid per output row ([n, G]), optional f32 m_eff.  ``w8x`` is the same
  fold marked precise (dual-plane activations).
* Q8F (``q8f``): int8 codes with one f32 scale per 256-element superblock.

The flavor is part of the layout: ``concat_qtensors`` refuses to fuse two
flavors (a precise and a plain fold among them) and the stacked path keeps
it on the stack and on every layer view.

A MoE expert stack (``stack_qtensors``) carries a leading E axis on every
plane, with ``shape`` the per-expert (n, k); ``qt[e]`` views one expert
and ``dequantize`` takes the stack whole ([E, n, k]).
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

    codes: torch.Tensor  # [n, k_pad * bits / 8] uint8 planes or int8 codes
    g_scale: torch.Tensor  # [n, k_pad // group_size] integer codes or f32
    g_min: Optional[torch.Tensor]  # same layout, or None
    sb_scale: Optional[torch.Tensor]  # [n, k_pad // 256] f32 superblock scale or None
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
    def is_stacked(self) -> bool:
        """A MoE expert stack: every plane has a leading E axis."""
        return self.codes.dim() == 3

    def __len__(self) -> int:
        if not self.is_stacked:
            raise TypeError("len() on a QTensor that is no expert stack")
        return self.codes.shape[0]

    def __getitem__(self, e):
        """Expert e (an int) of a stack as views of its planes, or the
        experts `e` (an index tensor) as a smaller stack."""
        if not self.is_stacked:
            raise TypeError("indexing a QTensor that is no expert stack")
        pick = lambda t: t[e] if isinstance(t, torch.Tensor) else t
        aux = None if self.aux is None else {k: pick(v) for k, v in self.aux.items()}
        return replace(self, codes=self.codes[e], g_scale=self.g_scale[e],
                       g_min=pick(self.g_min), sb_scale=pick(self.sb_scale),
                       sb_min=pick(self.sb_min), aux=aux)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def flavor(self) -> Optional[str]:
        """The served layout (W4 flavors, "w8", "q8f"), None for a repack."""
        return (self.aux or {}).get("flavor")

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

    def row_slice(self, lo: int, hi: int) -> "QTensor":
        """Rows lo..hi-1 as views of every plane, the kernels' aux planes
        included (a part of a fused fold: gate or up of [gate; up])."""
        cut = lambda t: t[lo:hi] if isinstance(t, torch.Tensor) else t
        aux = None if self.aux is None else {k: cut(v) for k, v in self.aux.items()}
        return replace(self, codes=self.codes[lo:hi], g_scale=self.g_scale[lo:hi],
                       g_min=cut(self.g_min), sb_scale=cut(self.sb_scale),
                       sb_min=cut(self.sb_min), shape=(hi - lo, self.k), aux=aux)

    def rows(self, ids: torch.Tensor) -> "QTensor":
        """Gathered rows of any layout (codes and every scale plane), without
        the kernels' aux planes: the embedding path dequantizes them."""
        pick = lambda t: None if t is None else t[ids]
        return replace(self, codes=self.codes[ids], g_scale=self.g_scale[ids],
                       g_min=pick(self.g_min), sb_scale=pick(self.sb_scale),
                       sb_min=pick(self.sb_min), shape=(int(ids.shape[0]), self.k),
                       aux=None)


def stack_qtensors(qts: list) -> QTensor:
    """Per-expert QTensors of one layout -> one stack with a leading E axis
    on every plane (JAX ``qtensor.py:117``), so that a decode step gathers
    only the routed experts' planes (``ops/moe.py::moe_gathered_quant``).
    Mismatched layouts raise ValueError, and so do the served folds, whose
    aux planes only their 2-D kernels read, as in JAX."""
    q0 = qts[0]
    key = lambda q: (q.qtype, q.bits, q.group_size, q.code_offset, q.shape, q.hi_signed)
    if any(key(q) != key(q0) for q in qts[1:]):
        raise ValueError("stack_qtensors: mismatched expert metadata")
    if any(q.aux is not None for q in qts):
        raise ValueError("stack_qtensors: a served fold (aux planes) does not stack")

    def st(vals):
        return None if vals[0] is None else torch.stack(vals)

    return replace(q0, codes=st([q.codes for q in qts]), g_scale=st([q.g_scale for q in qts]),
                   g_min=st([q.g_min for q in qts]), sb_scale=st([q.sb_scale for q in qts]),
                   sb_min=st([q.sb_min for q in qts]))


def concat_qtensors(qts: list) -> QTensor:
    """Concatenate QTensors along the output (n) axis: wq|wk|wv -> wqkv,
    gate|up -> gateup.  Every port layout keeps n as the leading axis of
    every plane.  Mismatched layouts (flavors included) raise ValueError,
    as the JAX package's does: a Q4_K_M layer's W4 wq/wk and W8 wv stay
    split, and so do precise and plain folds."""
    q0 = qts[0]
    key = lambda q: (q.qtype, q.bits, q.group_size, q.code_offset, q.k, q.hi_signed,
                     q.tp_axis, q.flavor)
    for q in qts[1:]:
        if key(q) != key(q0):
            raise ValueError("concat_qtensors: mismatched metadata")
        if (q.aux is None) != (q0.aux is None) or (
                q.aux is not None and set(q.aux) != set(q0.aux)):
            raise ValueError("concat_qtensors: mismatched aux")
        for f in ("g_min", "sb_scale", "sb_min"):
            if (getattr(q, f) is None) != (getattr(q0, f) is None):
                raise ValueError(f"concat_qtensors: mismatched {f}")
    if q0.tp_axis is not None:
        raise ValueError("concat_qtensors: refusing to fuse sharded tensors")
    if any(q.is_stacked for q in qts):
        raise ValueError("concat_qtensors: expert stacks do not fuse")

    def cat(vals):
        return None if vals[0] is None else torch.cat(vals, dim=0)

    aux = None
    if q0.aux is not None:
        aux = {k: (cat([q.aux[k] for q in qts]) if isinstance(v, torch.Tensor) else v)
               for k, v in q0.aux.items()}
    return replace(q0, codes=cat([q.codes for q in qts]),
                   g_scale=cat([q.g_scale for q in qts]),
                   g_min=cat([q.g_min for q in qts]),
                   sb_scale=cat([q.sb_scale for q in qts]),
                   sb_min=cat([q.sb_min for q in qts]),
                   shape=(sum(q.n for q in qts), q0.k), aux=aux)


def unpack_codes(qt: QTensor) -> torch.Tensor:
    """Codes as int32 [n, k_pad] in element order: 8-bit codes as they are
    (int8, or uint8 0..31 for Q5_K); 4-bit planes split into the low nibble
    (element j of a span) and the high nibble (element 128+j), pre-signed
    (q-8) when ``hi_signed``; 2-bit planes into bits 2p..2p+1 of byte j
    (element 64p+j of a span, as ``quant/repack.py::_pack2`` writes them)."""
    c = qt.codes
    if qt.bits == 8:
        return c.to(torch.int32)
    n = c.shape[0]
    if qt.bits == 2:
        quarter = SPAN // 4
        b = c.reshape(n, c.shape[-1] // quarter, 1, quarter).to(torch.int32)
        shifts = torch.tensor([0, 2, 4, 6], device=c.device, dtype=torch.int32).reshape(4, 1)
        return ((b >> shifts) & 0x03).reshape(n, -1)
    if qt.bits != 4:
        raise ValueError(f"unsupported bit width {qt.bits}")
    half = SPAN // 2
    spans = c.shape[-1] // half
    b = c.reshape(n, spans, half)
    lo = (b & 0x0F).to(torch.int32)
    if qt.hi_signed:
        # arithmetic shift on int8 sign-extends the stored (q-8) to [-8, 7]
        hi = (b.view(torch.int8) >> 4).to(torch.int32)
    else:
        hi = (b >> 4).to(torch.int32)
    return torch.cat([lo, hi], dim=-1).reshape(n, spans * SPAN)


def effective_scales(qt: QTensor):
    """Per-group (eff_scale, eff_min) as f32 [n, k_pad // group_size]: the
    group planes times their superblock scales, in the JAX package's order."""
    s = qt.g_scale.to(torch.float32)
    m = qt.g_min.to(torch.float32) if qt.g_min is not None else None
    if qt.sb_scale is not None:
        rep = SPAN // qt.group_size
        s = s * qt.sb_scale.to(torch.float32).repeat_interleave(rep, dim=-1)
        if m is not None and qt.sb_min is not None:
            m = m * qt.sb_min.to(torch.float32).repeat_interleave(rep, dim=-1)
    return s, m


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization to [n, k] (reference path; kernels fuse this),
    or [E, n, k] for an expert stack.  Same f32 operation order as the JAX
    package: (q - off) * s, then - m."""
    if qt.is_stacked:  # the experts' rows are independent: one [E * n, k] pass
        lead = qt.codes.shape[0]
        flat = lambda t: None if t is None else t.reshape(-1, *t.shape[2:])
        rows = replace(qt, codes=flat(qt.codes), g_scale=flat(qt.g_scale),
                       g_min=flat(qt.g_min), sb_scale=flat(qt.sb_scale),
                       sb_min=flat(qt.sb_min), shape=(lead * qt.n, qt.k))
        return dequantize(rows, dtype).reshape(lead, qt.n, qt.k)
    codes = unpack_codes(qt)
    s, m = effective_scales(qt)
    n, G = s.shape
    # per group, broadcast over its codes (no full-size copy of each plane)
    w = (codes - qt.code_offset).to(torch.float32).reshape(n, G, qt.group_size) * s[..., None]
    if m is not None:
        w = w - m[..., None]
    return w.reshape(n, -1)[:, :qt.k].to(dtype)
