"""Normalization ops, computed in f32 and cast back to the input dtype
(port of ``llama_kotlin_tpu/ops/norms.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm: x / rms(x) * (weight + offset)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    y = y * (weight.to(torch.float32) + offset)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: (x - mean) / std * weight + bias; weight=None is OLMo's
    non-parametric LayerNorm, bias=None a LayerNorm without bias (JAX
    ``ops/norms.py:26-39``)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * (1.0 / torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
