"""Normalization ops, computed in f32 and cast back to the input dtype
(port of ``llama_kotlin_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm: x / rms(x) * (weight + offset)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    y = y * (weight.to(torch.float32) + offset)
    return y.to(x.dtype)
