"""IQ (codebook) wire formats -> codes and scales, in torch (port of the
split decoders of ``llama_kotlin_tpu/quant/iq.py``, ``iq_split`` and its
nine ``_split_*``).

Every format factors as

    value = sb_scale * g_scale * code

with int8 codes (grid entries times exact sign flips; IQ1's +-0.125 delta
folds in as code = 8 * grid +- 1 under sb = d / 8), small-integer group
scales (uint8 2h + 1 style, int8 ls - 32 for IQ4_XS, the f32 block scale
itself for IQ4_NL) and an f32 superblock scale (none for IQ4_NL).  Every
partial product holds in f32 exactly, so dequantizing the split in any
order gives the wire decoder's floats bit for bit.

The trained grids are wire-format constants: ``iq_grids.npz`` beside this
module is a byte copy of the JAX package's (``scripts/extract_iq_grids.py``
regenerates it from llama.cpp's ``ggml-common.h``).  The bit logic runs on
the device the wire bytes are on, as ``quant/repack.py``'s other repacks.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from llama_kotlin_tpu_torch.quant.formats import QK_K, TYPE_TRAITS, GGMLQuantType

KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113)
GRID_FILE = Path(__file__).parent / "iq_grids.npz"

_host: dict[str, np.ndarray] = {}
_tables: dict[tuple, torch.Tensor] = {}


def _host_tables() -> dict:
    """The grids as int16 element tables ([n, 8] or [n, 4]), the 128 sign
    patterns [128, 8] and the IQ4 levels [16]."""
    if not _host:
        with np.load(GRID_FILE) as z:
            for name in z.files:
                g = z[name]
                width = 8 if g.dtype == np.uint64 else 4
                signed = name == "iq1s_grid"
                _host[name] = g.view(np.int8 if signed else np.uint8).reshape(
                    -1, width).astype(np.int16)
        idx = np.arange(128, dtype=np.uint8)
        bits = np.unpackbits(idx[:, None], axis=1, bitorder="little")
        bits[:, 7] = bits.sum(axis=1) & 1  # the odd-parity completion bit
        _host["signs"] = np.where(bits != 0, -1, 1).astype(np.int16)
        _host["kvalues"] = np.asarray(KVALUES_IQ4NL, np.int16)
    return _host


def _table(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _tables:
        _tables[key] = torch.from_numpy(_host_tables()[name]).to(device)
    return _tables[key]


def _f16(b: torch.Tensor) -> torch.Tensor:
    """Byte pairs [nb, 2] -> f32 [nb, 1]."""
    return b.contiguous().view(torch.float16).to(torch.float32)


def _u16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian byte pairs [..., 2m] -> their uint16 values as int64 [..., m]."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], -1, 2)
    return b[..., 0] | (b[..., 1] << 8)


def _u32(b: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes [..., 4m] -> their uint32 values as int64 [..., m]."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _byte_signs(b: torch.Tensor) -> torch.Tensor:
    """Sign bytes [...] -> +-1 int16 [..., 8] (bit j set: element j negative)."""
    bits = (b.to(torch.int64)[..., None] >> torch.arange(8, device=b.device)) & 1
    return (1 - 2 * bits).to(torch.int16)


def _codes(v: torch.Tensor, nb: int) -> torch.Tensor:
    return v.reshape(nb, QK_K).to(torch.int8)


def _scale_pairs(s: torch.Tensor, nb: int, groups: int) -> torch.Tensor:
    """Nibble-packed scale bytes -> 2 ls + 1 as uint8 [nb, groups]: the low
    nibble scales the first half of a byte's 32 elements, the high the rest."""
    ls = torch.stack([s & 0x0F, s >> 4], dim=-1).to(torch.int16)
    return (2 * ls + 1).to(torch.uint8).reshape(nb, groups)


def _split_iq2_xxs(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    q = b[:, 2:66].reshape(nb, 8, 8)
    aux = _u32(q[:, :, 4:8])[..., 0]  # [nb, 8]
    sidx = (aux[..., None] >> (7 * torch.arange(4, device=dev))) & 127  # [nb, 8, 4]
    vals = _table("iq2xxs_grid", dev)[q[:, :, 0:4].to(torch.int64)] * _table("signs", dev)[sidx]
    g = (2 * (aux >> 28) + 1).to(torch.uint8)  # d (0.5 + h) / 4 = (d / 8)(2h + 1)
    return _codes(vals, nb), g, d * 0.125, 32


def _split_iq2_xs(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    qs = _u16(b[:, 2:66]).reshape(nb, 8, 4)
    vals = _table("iq2xs_grid", dev)[qs & 511] * _table("signs", dev)[qs >> 9]
    return _codes(vals, nb), _scale_pairs(b[:, 66:74], nb, 16), d * 0.125, 16


def _split_iq2_s(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(nb, 8, 4).to(torch.int64)
    signs = b[:, 34:66].reshape(nb, 8, 4)
    qh = b[:, 66:74].to(torch.int64)
    gidx = qs | ((qh[:, :, None] << (8 - 2 * torch.arange(4, device=dev))) & 0x300)
    vals = _table("iq2s_grid", dev)[gidx] * _byte_signs(signs)
    return _codes(vals, nb), _scale_pairs(b[:, 74:82], nb, 16), d * 0.125, 16


def _split_iq3_xxs(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(nb, 8, 8).to(torch.int64)  # 8 four-element grid indices a group
    aux = _u32(b[:, 66:98])  # [nb, 8]
    sidx = (aux[..., None] >> (7 * torch.arange(4, device=dev))) & 127
    s = _table("signs", dev)[sidx].reshape(nb, 8, 4, 2, 4)
    gq = _table("iq3xxs_grid", dev)[qs].reshape(nb, 8, 4, 2, 4)
    g = (2 * (aux >> 28) + 1).to(torch.uint8)  # d (0.5 + h) / 2 = (d / 4)(2h + 1)
    return _codes(gq * s, nb), g, d * 0.25, 32


def _split_iq3_s(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(nb, 8, 8).to(torch.int64)
    qh = b[:, 66:74].to(torch.int64)  # bit m of byte l: the ninth index bit of qs[l, m]
    signs = b[:, 74:106].reshape(nb, 8, 4)
    gidx = qs | (((qh[:, :, None] >> torch.arange(8, device=dev)) & 1) << 8)
    s = _byte_signs(signs).reshape(nb, 8, 4, 2, 4)
    gq = _table("iq3s_grid", dev)[gidx].reshape(nb, 8, 4, 2, 4)
    return _codes(gq * s, nb), _scale_pairs(b[:, 106:110], nb, 8), d, 32


def _split_iq1_s(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(nb, 8, 4).to(torch.int64)
    qh = _u16(b[:, 34:50])  # [nb, 8]
    g = (2 * ((qh >> 12) & 7) + 1).to(torch.uint8)
    sgn = torch.where((qh & 0x8000) != 0, -1, 1).to(torch.int16)  # the delta's sign a group
    gidx = qs | (((qh[:, :, None] >> (3 * torch.arange(4, device=dev))) & 7) << 8)
    gr = _table("iq1s_grid", dev)[gidx]  # [nb, 8, 4, 8]
    # d (2s + 1)(grid +- 1/8) = (d / 8)(2s + 1)(8 grid +- 1)
    return _codes(8 * gr + sgn[:, :, None, None], nb), g, d * 0.125, 32


def _split_iq1_m(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    qs = b[:, 0:32].reshape(nb, 8, 4).to(torch.int64)
    qh = b[:, 32:48].reshape(nb, 8, 2).to(torch.int64)
    sc = _u16(b[:, 48:56])  # [nb, 4]
    # the f16 superblock scale hides in the top nibbles of the four scale words
    du = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
          | (sc[:, 3] & 0xF000))
    d = (du - ((du >> 15) << 16)).to(torch.int16).view(torch.float16).to(torch.float32)[:, None]
    ib = torch.arange(8, device=dev)
    word = sc[:, ib // 2]
    shift = 6 * (ib % 2)
    s1, s2 = (word >> shift) & 7, (word >> (shift + 3)) & 7  # elements 0-15, 16-31 of a group
    g = (2 * torch.stack([s1, s2], dim=-1) + 1).to(torch.uint8).reshape(nb, 16)
    idx = torch.stack([qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700),
                       qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700),
                       qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700),
                       qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)], dim=-1)
    neg = torch.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                       qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], dim=-1) != 0
    sgn = torch.where(neg, -1, 1).to(torch.int16)  # the delta's sign a group of 8
    gr = _table("iq1s_grid", dev)[idx]
    return _codes(8 * gr + sgn[..., None], nb), g, d * 0.125, 16


def _nl_codes(qs: torch.Tensor) -> torch.Tensor:
    """IQ4 nibbles [..., 16] -> levels [..., 32]: low nibbles first."""
    k = _table("kvalues", qs.device)
    return torch.cat([k[(qs & 0x0F).to(torch.int64)], k[(qs >> 4).to(torch.int64)]],
                     dim=-1).to(torch.int8)


def _split_iq4_nl(b: torch.Tensor):
    # one level of scale: the f32 block scale is the group plane
    return _nl_codes(b[:, 2:18]), _f16(b[:, 0:2]), None, 32


def _split_iq4_xs(b: torch.Tensor):
    nb, dev = b.shape[0], b.device
    d = _f16(b[:, 0:2])
    scales_h = _u16(b[:, 2:4])  # [nb, 1]
    scales_l = b[:, 4:8].to(torch.int64)
    ib = torch.arange(8, device=dev)
    ls = (((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F)
          | (((scales_h >> (2 * ib)) & 3) << 4))
    g = (ls - 32).to(torch.int8)  # [nb, 8]
    return _nl_codes(b[:, 8:136].reshape(nb, 8, 16)).reshape(nb, QK_K), g, d, 32


IQ_SPLIT = {
    GGMLQuantType.IQ2_XXS: _split_iq2_xxs,
    GGMLQuantType.IQ2_XS: _split_iq2_xs,
    GGMLQuantType.IQ2_S: _split_iq2_s,
    GGMLQuantType.IQ3_XXS: _split_iq3_xxs,
    GGMLQuantType.IQ3_S: _split_iq3_s,
    GGMLQuantType.IQ1_S: _split_iq1_s,
    GGMLQuantType.IQ1_M: _split_iq1_m,
    GGMLQuantType.IQ4_NL: _split_iq4_nl,
    GGMLQuantType.IQ4_XS: _split_iq4_xs,
}
IQ_TYPES = tuple(IQ_SPLIT)


def iq_split(data: torch.Tensor, qtype: GGMLQuantType):
    """Wire bytes (uint8, on any device) -> (codes int8 [nb, block], g_scale
    [nb, groups] (uint8, int8 or f32), sb_scale f32 [nb, 1] or None,
    group_size), JAX's ``iq_split``."""
    ts = TYPE_TRAITS[qtype].type_size
    return IQ_SPLIT[qtype](data.reshape(-1, ts))
