"""The fast-mode weight folds: W4 (W4A8) and W8.

W4 codes and the f32 ``g_scale``/``g_min`` planes are the JAX package's
(``llama_kotlin_tpu/quant/fold.py``): plane-packed nibbles with a pre-signed
high nibble, s_eff per 32-group, and m_adj (m_eff on lo groups,
m_eff - 8*s_eff on hi groups).  The streamed aux planes are the port's own,
laid out per output row so a CUDA warp that owns a row reads them
contiguously (the JAX package transposes them to [.., n] for the TPU's
lane axis):

* compact (Q4_K-class sources; the wire's factorization, 4.625 bits per
  weight streamed): ``aux["q6"]`` uint8 [n, S, 16] — bytes 0..7 are the
  6-bit scale codes of element groups 8s..8s+7, bytes 8..15 their 6-bit
  min codes — and ``aux["dd"]`` f32 [n, S, 2] = (d, dmin) of superblock s.
  Then s_eff = d * sc6 and m_eff = dmin * m6, exactly as the wire
  decodes.
* legacy and sym (``aux["flavor"]``): the decode kernel streams the
  bf16-rounded ``g_scale``/``g_min`` themselves (stored as f32), the port's
  counterpart of the JAX scw_lo/scw_hi/madj_t planes.  A sym fold (Q4_0
  class) has m_adj = 8*s_eff on lo groups and 0 on hi groups.

The JAX package's TPU workarounds — the block-diagonal activation layout
and the (32, 128)-tile guards on the compact fold — are not needed here.

W8 (``fold_to_w8``, every group-16/32 format the W4 fold does not take:
q6_K, q8_0, q5_0, q5_1, q5_K and q3_K (8-bit codes) and q2_K (2-bit
planes, unpacked)): int8 element-order codes [n, k_pad], the exact f32
effective scale s_eff per group in ``g_scale`` [n, G] (the JAX fold also keeps it
transposed as ``aux["scw"]`` for the TPU; the port's kernel reads it per
output row) and the f32 m_eff in ``g_min`` for formats with mins.  10 bits
per weight streamed at group 16.

W4X, the high-fidelity mode (``precise=True``): the same storage as the
legacy and sym W4 folds with s_eff and m_adj kept in f32 as computed, never
rounded to bf16 and never compact, so the weights dequantize bit-exactly
(6.0 bits per weight streamed).  Flavors ``w4x`` and ``w4x_sym``, and
``w8x`` for the precise W8 fold (the W8 weights unchanged).  Their decode
kernels quantize the activations in two int8 planes (kernel 7 and kernel
5's dual-plane branch); kernels 1 and 2 must never take them, so each
layout has one predicate of its own (``is_w4``, ``is_w4x``, ``is_w8``,
``is_w8x``, ``is_q8f``) and the flavors never overlap.

The Q8F shadow (``attach_q8``, JAX ``quant/fold.py:316-380``): a W4 fold
of the ``w4`` mode may also carry the same weights as Q8F planes,
``aux["q8_codes"]`` int8 [n, k_pad] and ``aux["q8_scale"]`` f32 [n,
k_pad / 256] (k padded to 256, kernel 6's layout), about 8.2 more bits a
weight.  ``ops/qmatmul.py`` sends rows above ``LKTPU_W4_BMAX`` and up to
256 to kernel 6 on the shadow (``q8_shadow``); the fold's own planes serve
the rest.  ``LKTPU_DUAL_FOLD=1`` attaches it at load and at a synthetic
draw (W4 folds only: never W4X).
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType
from llama_kotlin_tpu_torch.quant.qtensor import (QTensor, SPAN, dequantize, effective_scales,
                                                  unpack_codes)
from llama_kotlin_tpu_torch.quant.repack import float_to_q8flat

GROUP = 32  # W4 group size (= Q4_K group)
# k-alignment of the folds: the contraction dim pads up to a multiple of
# 1024 (W4) or 512 (W8) with zero scales, kept from the JAX folds so the
# folds are identical
ALIGN_W4 = 1024
ALIGN_W8 = 512
FLAVORS = ("compact", "legacy", "sym")  # W4 (kernel 1)
W4X_FLAVORS = ("w4x", "w4x_sym")  # precise W4 (kernel 7)


def _pad_cols(a: Optional[torch.Tensor], cols: int):
    """Zero-pad [n, C] by `cols` extra columns (None passes through)."""
    return a if a is None or cols == 0 else F.pad(a, (0, cols))


def _plane_group_perm(n_groups: int, hi: bool) -> np.ndarray:
    """Group ids in plane-column order (the JAX layout's q6_t rows): column
    c of the lo (hi) plane covers element group 8*(c//128) + (c%128)//32
    (+4 for hi); one entry per 32-column run."""
    idx = np.arange(n_groups // 2)
    return 8 * (idx // 4) + idx % 4 + (4 if hi else 0)


def compact_planes(sc6: torch.Tensor, m6: torch.Tensor, d_sb: torch.Tensor,
                   dmin_sb: torch.Tensor) -> dict:
    """Port compact planes from wire-order [n, G] 6-bit scale/min codes and
    [n, S] f32 superblock d/dmin.  The one construction site of the layout
    (the fold, the converter and both synthetic generators call it)."""
    n, G = sc6.shape
    S = G // 8
    q6 = torch.cat([sc6.reshape(n, S, 8), m6.reshape(n, S, 8)], dim=-1)
    dd = torch.stack([d_sb.to(torch.float32), dmin_sb.to(torch.float32)], dim=-1)
    return {"q6": q6.to(torch.uint8).contiguous(), "dd": dd.contiguous()}


def compact_from_jax_aux(q6_t: np.ndarray, dd_t: np.ndarray) -> tuple:
    """The JAX compact aux (q6_t int8 [4, G/2, n] in plane-column order,
    dd_t f32 [2S, n] row-interleaved d/dmin) -> wire-order (sc6, m6 [n, G],
    d, dmin [n, S]) numpy arrays."""
    q6_t = np.asarray(q6_t)
    G = q6_t.shape[1] * 2
    n = q6_t.shape[2]
    lo, hi = _plane_group_perm(G, False), _plane_group_perm(G, True)
    sc6 = np.empty((G, n), np.int8)
    m6 = np.empty((G, n), np.int8)
    sc6[lo], sc6[hi] = q6_t[0], q6_t[1]
    m6[lo], m6[hi] = q6_t[2], q6_t[3]
    dd = np.asarray(dd_t, np.float32).reshape(-1, 2, n)
    return sc6.T, m6.T, dd[:, 0].T, dd[:, 1].T


def w4_from_parts(packed: torch.Tensor, s_eff: torch.Tensor, m_adj: torch.Tensor,
                  shape: tuple[int, int], qtype=None, sym: bool = False,
                  compact_parts: Optional[dict] = None, precise: bool = False) -> QTensor:
    """Assemble a W4 QTensor from plane-packed codes [n, k_pad/2] u8,
    effective per-32-group scales s_eff [n, G] f32 and adjusted mins m_adj
    [n, G] f32.  Without compact parts the scales are rounded to bf16 as the
    JAX legacy/sym folds store them (kept as f32 here, exactly); precise
    (W4X) folds keep them in f32 as given."""
    s_eff = s_eff.to(torch.float32)
    m_adj = m_adj.to(torch.float32)
    if compact_parts is not None:
        if sym or precise:
            raise ValueError("sym and precise folds have no compact planes")
        aux = dict(compact_parts, flavor="compact")
    elif precise:
        aux = {"flavor": "w4x_sym" if sym else "w4x"}
    else:
        s_eff = s_eff.to(torch.bfloat16).to(torch.float32)
        m_adj = m_adj.to(torch.bfloat16).to(torch.float32)
        aux = {"flavor": "sym" if sym else "legacy"}
    return QTensor(
        codes=packed.contiguous(), g_scale=s_eff.contiguous(),
        g_min=m_adj.contiguous(), sb_scale=None, sb_min=None,
        qtype=qtype if qtype is not None else GGMLQuantType.Q4_K,
        bits=4, group_size=GROUP, code_offset=0, shape=tuple(shape),
        hi_signed=True, aux=aux)


def fold_to_w4(qt: QTensor, precise: bool = False) -> QTensor:
    """A repacked 4-bit group-32 QTensor -> the W4 fold, on its device.
    Takes the compact flavor under the JAX fold's rule (6-bit integer
    scale/min codes under superblock scales, and k a multiple of 2048 after
    padding to 1024), else the legacy flavor, or sym for a source with
    code offset 8 and no mins (Q4_0 class).  precise=True gives the W4X
    fold: never compact, f32 s_eff and m_adj as computed."""
    if qt.bits != 4 or qt.group_size != GROUP:
        raise ValueError(f"fold_to_w4 needs 4-bit group-32 codes, got "
                         f"bits={qt.bits} group={qt.group_size}")
    if qt.hi_signed:
        return qt
    n, k = qt.shape
    codes = unpack_codes(qt)  # [n, k_pad] element order
    s_eff, m_eff = effective_scales(qt)
    if m_eff is None:
        m_eff = torch.zeros_like(s_eff)
    compact = bool(
        not precise and qt.code_offset == 0 and qt.sb_scale is not None
        and qt.sb_min is not None and qt.g_min is not None
        and not qt.g_scale.is_floating_point() and not qt.g_min.is_floating_point()
        and (k + (-k % ALIGN_W4)) // 2 % 1024 == 0)
    pad = -qt.k_pad % ALIGN_W4
    codes = _pad_cols(codes, pad)
    s_eff = _pad_cols(s_eff, pad // GROUP)
    m_eff = _pad_cols(m_eff, pad // GROUP)
    off = float(qt.code_offset)
    sym = off == 8.0 and not bool(m_eff.any())
    is_lo = (torch.arange(s_eff.shape[1], device=s_eff.device) % 8) < 4
    bias = torch.where(is_lo, torch.full_like(s_eff[0], off), torch.full_like(s_eff[0], off - 8))
    m_adj = m_eff + bias * s_eff
    el = codes.reshape(n, -1, 2, SPAN // 2)
    packed = (el[:, :, 0].to(torch.uint8) | (((el[:, :, 1] - 8) & 0xF).to(torch.uint8) << 4))
    parts = None
    if compact and not sym:
        parts = compact_planes(_pad_cols(qt.g_scale, pad // GROUP),
                               _pad_cols(qt.g_min, pad // GROUP),
                               _pad_cols(qt.sb_scale.to(torch.float32), pad // SPAN),
                               _pad_cols(qt.sb_min.to(torch.float32), pad // SPAN))
    return w4_from_parts(packed.reshape(n, -1), s_eff, m_adj, (n, k), qtype=qt.qtype,
                         sym=sym, compact_parts=parts, precise=precise)


def fold_to_w8(qt: QTensor, precise: bool = False) -> QTensor:
    """A repacked group-16/32 QTensor (q6_K, q8_0, q5_0, q5_1, q5_K, q3_K;
    4- and 2-bit sources unpack: q4_K folded to W8, q2_K) ->
    the W8 fold: int8 element-order codes, exact f32 s_eff (and m_eff) per
    group, k padded to 512.  precise=True marks it W8X (flavor ``w8x``):
    the same weights, served with dual-plane activations."""
    if qt.aux is not None:
        return qt  # already folded
    n, k = qt.shape
    gs = qt.group_size
    if gs not in (16, 32):
        raise ValueError(f"fold_to_w8: group_size {gs} unsupported (need 16/32)")
    codes = unpack_codes(qt) - qt.code_offset  # int8 range for every ported repack
    s_eff, m_eff = effective_scales(qt)
    pad = -codes.shape[-1] % ALIGN_W8
    return QTensor(codes=_pad_cols(codes, pad).to(torch.int8).contiguous(),
                   g_scale=_pad_cols(s_eff, pad // gs).contiguous(),
                   g_min=None if m_eff is None else _pad_cols(m_eff, pad // gs).contiguous(),
                   sb_scale=None, sb_min=None, qtype=qt.qtype, bits=8, group_size=gs,
                   code_offset=0, shape=(n, k), hi_signed=False,
                   aux={"flavor": "w8x" if precise else "w8"})


def _w4_storage(w) -> bool:
    return (isinstance(w, QTensor) and w.hi_signed and w.bits == 4
            and w.group_size == GROUP)


def is_w4(w) -> bool:
    """A W4 fold (kernel 1 for decode rows, kernel 2 in the FFN, kernel 4
    for prefill rows)."""
    return _w4_storage(w) and w.flavor in FLAVORS


def is_w4x(w) -> bool:
    """A precise W4 fold, W4X (kernel 7 for decode rows, kernel 4 else)."""
    return _w4_storage(w) and w.flavor in W4X_FLAVORS


def _w8_storage(w) -> bool:
    return (isinstance(w, QTensor) and w.bits == 8 and w.group_size in (16, 32)
            and w.sb_scale is None)


def is_w8(w) -> bool:
    """A W8 fold (kernel 5 for decode rows, kernel 4's 8-bit branch else)."""
    return _w8_storage(w) and w.flavor == "w8"


def is_w8x(w) -> bool:
    """A precise W8 fold (kernel 5's dual-plane branch for decode rows,
    kernel 4's 8-bit branch else)."""
    return _w8_storage(w) and w.flavor == "w8x"


def is_q8_sb(w) -> bool:
    """Kernel 6's layout: int8 codes with one scale a 256-superblock, no
    mins and no superblock planes, as a Q8F tensor or an exact Q8_K repack
    (JAX ``ops/qmatmul.py:110-116`` routes this layout, not a flavor)."""
    return (isinstance(w, QTensor) and w.flavor in ("q8f", None) and not w.hi_signed
            and w.bits == 8 and w.group_size == SPAN and w.g_min is None
            and w.sb_scale is None)


def is_q8f(w) -> bool:
    """A Q8F tensor (kernel 6 at every row count)."""
    return is_q8_sb(w) and w.flavor == "q8f"


EXACT_GROUPS = (16, 32)  # the group sizes of kernel 4's exact branches


def is_exact(w) -> bool:
    """An exact repack (``quant/repack.py``, the exact-dequant mode's layout,
    no flavor) of 8-bit codes or 4- or 2-bit planes at group 16 or 32:
    kernel 4's exact branches at every row count."""
    return (isinstance(w, QTensor) and w.aux is None and not w.hi_signed
            and w.bits in (2, 4, 8) and w.group_size in EXACT_GROUPS)


SHADOW_ROW_CHUNK = 8192  # weight rows dequantized to f32 at a time by attach_q8


def dual_fold_enabled() -> bool:
    """``LKTPU_DUAL_FOLD=1``: W4 folds carry a Q8F shadow (JAX's switch,
    read where the folds are made)."""
    return os.environ.get("LKTPU_DUAL_FOLD") == "1"


def attach_q8(w4: QTensor, wf: Optional[torch.Tensor] = None,
              row_chunk: int = SHADOW_ROW_CHUNK) -> QTensor:
    """The W4 fold `w4` with a Q8F shadow of the same weights in its aux
    (``q8_codes``, ``q8_scale``): `wf` the f32 [n, k] source (the loader's
    decode of the wire bytes), or by default the fold's own dequantization,
    a chunk of `row_chunk` rows at a time on the fold's device (JAX's
    ``attach_q8_device``, which bounds the lm_head's f32 transient)."""

    if not is_w4(w4):
        raise ValueError(f"attach_q8 takes a W4 fold, not layout {w4.flavor!r}")
    n, k = w4.shape
    codes, scales = [], []
    for r0 in range(0, n, row_chunk):
        r1 = min(r0 + row_chunk, n)
        if wf is None:
            rows = replace(w4.row_slice(r0, r1), aux=None)
            part = dequantize(rows)
        else:
            part = wf[r0:r1, :k].to(torch.float32)
        q8 = float_to_q8flat(part)
        codes.append(q8.codes)
        scales.append(q8.g_scale)
    cat = lambda ts: ts[0] if len(ts) == 1 else torch.cat(ts)
    return replace(w4, aux=dict(w4.aux, q8_codes=cat(codes).contiguous(),
                                q8_scale=cat(scales).contiguous()))


def attach_q8_device(w4: QTensor, row_chunk: int = SHADOW_ROW_CHUNK) -> QTensor:
    """attach_q8 from the fold's own weights, on its device (synthetic
    weights drawn on the card)."""
    return attach_q8(w4, None, row_chunk)


def has_shadow(w) -> bool:
    """A W4 fold that carries a Q8F shadow."""
    return is_w4(w) and "q8_codes" in w.aux


def q8_shadow(w: QTensor) -> QTensor:
    """The shadow of a W4 fold as a Q8F QTensor (views of its aux planes)."""
    return QTensor(codes=w.aux["q8_codes"], g_scale=w.aux["q8_scale"], g_min=None,
                   sb_scale=None, sb_min=None, qtype=GGMLQuantType.Q8_0, bits=8,
                   group_size=SPAN, code_offset=0, shape=w.shape, aux={"flavor": "q8f"})
