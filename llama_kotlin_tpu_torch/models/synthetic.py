"""Synthetic models: random W4 weights at real checkpoint shapes (port of
``llama_kotlin_tpu/models/synthetic.py``, the presets and W4 generators).

``synthetic_w4`` draws from a numpy Generator in the same order as the JAX
package's generator, so the same seed gives the same weights on both sides.
``synthetic_params_device`` draws every large tensor on the device from a
seeded ``torch.Generator`` — no multi-GB host build.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.quant.fold import (ALIGN_W4, GROUP, compact_planes,
                                               w4_from_parts)
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

PRESETS = {
    # name: (n_embd, n_layer, n_head, n_head_kv, n_ff, vocab).  Only shapes
    # the kernels serve: an E or F that is not a multiple of 1024 (llama2-7b's
    # 11008) gets a padded W4 fold, which kernel 2 does not take yet.
    "llama3-8b": (4096, 32, 32, 8, 14336, 128256),
    "test-tiny": (1024, 2, 8, 4, 1024, 512),
}


def preset_config(name: str, **overrides) -> ModelConfig:
    e, l, h, kv, f, v = PRESETS[name]
    kw = dict(arch="llama", name=name, n_embd=e, n_layer=l, n_head=h,
              n_head_kv=kv, n_ff=f, vocab_size=v, n_ctx_train=4096)
    kw.update(overrides)
    return ModelConfig(**kw)


def _hi_groups(G: int, device=None) -> torch.Tensor:
    return (torch.arange(G, device=device) % 8) >= 4


def _compact_w4(packed, sc6, m6, d_sb, dmin_sb, shape) -> QTensor:
    """W4 compact fold from wire-style parts (torch tensors)."""
    s_eff = sc6.to(torch.float32) * d_sb.repeat_interleave(SPAN // GROUP, dim=1)
    m_eff = m6.to(torch.float32) * dmin_sb.repeat_interleave(SPAN // GROUP, dim=1)
    m_adj = torch.where(_hi_groups(s_eff.shape[1], s_eff.device), m_eff - 8.0 * s_eff, m_eff)
    return w4_from_parts(packed, s_eff, m_adj, shape,
                         compact_parts=compact_planes(sc6, m6, d_sb, dmin_sb))


def synthetic_w4(rng: np.random.Generator, n: int, k: int, scale: float = 0.02,
                 sym: bool = False, compact: Optional[bool] = None,
                 device: DeviceLike = None) -> QTensor:
    """Random W4 fold from a numpy Generator, drawn in the JAX package's
    order (its synthetic_w4), so equal seeds give equal weights."""
    dev = resolve_device(device)
    k_pad = (k + ALIGN_W4 - 1) // ALIGN_W4 * ALIGN_W4
    G = k_pad // GROUP
    packed = rng.integers(0, 256, (n, k_pad // 2), dtype=np.uint8)
    if compact is None:
        compact = not sym
    compact = compact and not sym and (k_pad // 2) % 1024 == 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if compact:
        S = k_pad // SPAN
        sc6 = rng.integers(0, 64, (n, G), dtype=np.int8)
        m6 = rng.integers(0, 64, (n, G), dtype=np.int8)
        d_sb = (rng.random((n, S), np.float32) * scale / 500.0).astype(
            np.float16).astype(np.float32)
        dmin_sb = (rng.random((n, S), np.float32) * scale / 500.0).astype(
            np.float16).astype(np.float32)
        return _compact_w4(t(packed), t(sc6.astype(np.uint8)), t(m6.astype(np.uint8)),
                           t(d_sb), t(dmin_sb), (n, k))
    s_eff = (rng.random((n, G), np.float32) * scale / 8.0).astype(np.float32)
    is_lo = (np.arange(G) % 8) < 4
    if sym:
        m_adj = np.where(is_lo, 8.0 * s_eff, 0.0).astype(np.float32)
    else:
        m_adj = (rng.random((n, G), np.float32) * scale * 0.5).astype(np.float32)
    return w4_from_parts(t(packed), t(s_eff), t(m_adj), (n, k), sym=sym)


def synthetic_w4_device(gen: torch.Generator, n: int, k: int, scale: float = 0.02,
                        zero_mean: bool = True, device: DeviceLike = None) -> QTensor:
    """Random compact W4 fold drawn on the device (Q4_K profile: 6-bit
    scale/min codes under f16-valued superblock d).

    With zero_mean each group's min is 7.5 times its scale (m6 = sc6,
    dmin = 7.5 d), so the uniform 4-bit codes give zero-mean weights, as a
    trained matrix's groups are.  Independent scale and min draws give
    every row a random mean: a model's outputs then line up along one
    direction and greedy decoding emits the same token whatever the
    prompt.  The kernel checks take zero_mean=False all the same, so that a
    kernel reading the scale plane for the min plane cannot pass."""
    dev = resolve_device(device)
    k_pad = (k + ALIGN_W4 - 1) // ALIGN_W4 * ALIGN_W4
    G, S = k_pad // GROUP, k_pad // SPAN
    kw = dict(generator=gen, device=dev)
    packed = torch.randint(0, 256, (n, k_pad // 2), dtype=torch.uint8, **kw)
    sc6 = torch.randint(0, 64, (n, G), dtype=torch.uint8, **kw)
    d_sb = (torch.rand((n, S), **kw) * (scale / 500.0)).half().float()
    if zero_mean:
        return _compact_w4(packed, sc6, sc6.clone(), d_sb, d_sb * 7.5, (n, k))
    m6 = torch.randint(0, 64, (n, G), dtype=torch.uint8, **kw)
    dmin_sb = (torch.rand((n, S), **kw) * (scale / 500.0)).half().float()
    return _compact_w4(packed, sc6, m6, d_sb, dmin_sb, (n, k))


def synthetic_params_device(cfg: ModelConfig, seed: int = 0,
                            device: DeviceLike = None) -> dict:
    """Random W4A8 params for `cfg` in the serving layout (wqkv_fused,
    ffn_gateup_fused; every matrix a compact W4 fold, embedding and lm_head
    included), drawn on `device` from a seeded torch.Generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, F, V = cfg.n_embd, cfg.n_ff, cfg.vocab_size
    qdim = cfg.n_head * cfg.head_dim
    kvdim = cfg.n_head_kv * cfg.head_dim

    def norm_w():
        return 1.0 + 0.01 * torch.randn(E, generator=gen, device=dev)

    def w(n_, k_):
        return synthetic_w4_device(gen, n_, k_, device=dev)

    params: dict = {"tok_embd": w(V, E), "output_norm": norm_w(), "rope_freqs": None,
                    "output": w(V, E), "layers": []}
    for _ in range(cfg.n_layer):
        params["layers"].append({
            "attn_norm": norm_w(), "ffn_norm": norm_w(),
            "wqkv_fused": w(qdim + 2 * kvdim, E), "wo": w(E, qdim),
            "ffn_gateup_fused": w(2 * F, E), "ffn_down": w(E, F)})
    return params


def params_to(params, device: DeviceLike):
    """A copy of a params tree on another device (QTensors and tensors)."""
    dev = resolve_device(device)
    if isinstance(params, QTensor):
        return params.to(dev)
    if isinstance(params, torch.Tensor):
        return params.to(dev)
    if isinstance(params, dict):
        return {k: params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, dev) for v in params]
    return params
