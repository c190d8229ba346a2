"""Rotary position embeddings (port of ``llama_kotlin_tpu/ops/rope.py``):
NORM (adjacent pairs) and NEOX (split halves) modes, linear and YaRN
scaling, per-dimension frequency factors."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

ROPE_TYPE_NONE = -1
ROPE_TYPE_NORM = 0
ROPE_TYPE_NEOX = 2


@dataclass(frozen=True)
class RopeParams:
    n_rot: int  # rotary dims (<= head_dim)
    rope_type: int = ROPE_TYPE_NORM
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    ext_factor: float = 0.0  # YaRN extrapolation mix (0 = off)
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    n_ctx_orig: int = 0


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def _yarn_corr_dims(n_dims, n_ctx_orig, freq_base, beta_fast, beta_slow):
    start = math.floor(_yarn_corr_dim(n_dims, n_ctx_orig, beta_fast, freq_base))
    end = math.ceil(_yarn_corr_dim(n_dims, n_ctx_orig, beta_slow, freq_base))
    return max(0.0, start), min(n_dims - 1.0, end)


def rope_cos_sin(pos: torch.Tensor, p: RopeParams,
                 freq_factors: Optional[torch.Tensor] = None):
    """cos/sin tables [*pos.shape, n_rot // 2] in f32."""
    half = p.n_rot // 2
    dim_idx = torch.arange(half, dtype=torch.float32, device=pos.device)
    theta_scale = p.freq_base ** (-2.0 / p.n_rot)
    # a fill on the device, not a copy from the host: a decode step never
    # waits for the stream
    inv_freq = torch.full((), theta_scale, dtype=torch.float32, device=pos.device) ** dim_idx
    if freq_factors is not None:
        inv_freq = inv_freq / freq_factors.to(torch.float32)
    theta_extrap = pos.to(torch.float32)[..., None] * inv_freq
    theta_interp = p.freq_scale * theta_extrap
    mscale = p.attn_factor
    if p.ext_factor != 0.0:
        low, high = _yarn_corr_dims(p.n_rot, p.n_ctx_orig or 1, p.freq_base,
                                    p.beta_fast, p.beta_slow)
        ramp_y = (dim_idx - low) / max(0.001, high - low)
        mix = (1.0 - torch.clamp(ramp_y, 0.0, 1.0)) * p.ext_factor
        theta = theta_interp * (1.0 - mix) + theta_extrap * mix
        mscale = mscale * (1.0 + 0.1 * math.log(1.0 / p.freq_scale))
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, pos: torch.Tensor, p: RopeParams,
               freq_factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate x [nt, n_heads, head_dim] by positions pos [nt]; dims beyond
    n_rot pass through."""
    if p.rope_type == ROPE_TYPE_NONE:
        return x
    return rotate(x, *rope_cos_sin(pos, p, freq_factors), p)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           p: RopeParams) -> torch.Tensor:
    """apply_rope with the cos/sin tables given, so a forward pass builds
    them once for every layer's q and k."""
    if p.rope_type == ROPE_TYPE_NONE:
        return x
    half = p.n_rot // 2
    cos = cos[..., :, None, :]  # broadcast over heads
    sin = sin[..., :, None, :]
    rot = x[..., : p.n_rot].to(torch.float32)
    rest = x[..., p.n_rot:]
    if p.rope_type == ROPE_TYPE_NEOX:
        a, b = rot[..., :half], rot[..., half:]
        out = torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)
    else:  # NORM: adjacent pairs
        a, b = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(rot.shape)
    out = out.to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.numel() else out
