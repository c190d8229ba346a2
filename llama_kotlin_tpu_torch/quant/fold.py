"""The W4 (W4A8) weight fold, subset served by the port.

Codes and the f32 ``g_scale``/``g_min`` planes are the JAX package's
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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, SPAN

GROUP = 32  # W4 group size (= Q4_K group)
# k-alignment of the W4 fold: the contraction dim pads up to a multiple of
# 1024 with zero scales (kept from the JAX fold so folds are identical)
ALIGN_W4 = 1024
FLAVORS = ("compact", "legacy", "sym")


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
                  compact_parts: Optional[dict] = None) -> QTensor:
    """Assemble a W4 QTensor from plane-packed codes [n, k_pad/2] u8,
    effective per-32-group scales s_eff [n, G] f32 and adjusted mins m_adj
    [n, G] f32.  Without compact parts the scales are rounded to bf16 as the
    JAX legacy/sym folds store them (kept as f32 here, exactly)."""
    s_eff = s_eff.to(torch.float32)
    m_adj = m_adj.to(torch.float32)
    if compact_parts is not None:
        if sym:
            raise ValueError("a sym fold has no compact planes")
        aux = dict(compact_parts, flavor="compact")
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


def is_w4(w) -> bool:
    """A W4 fold the port's kernels serve."""
    return (isinstance(w, QTensor) and w.hi_signed and w.bits == 4
            and w.group_size == GROUP and w.aux is not None
            and w.aux.get("flavor") in FLAVORS)
