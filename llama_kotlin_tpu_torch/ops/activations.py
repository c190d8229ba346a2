"""FFN activations (port of ``llama_kotlin_tpu/ops/activations.py``):
computed in f32, cast back to the input dtype."""

from __future__ import annotations

import torch

GELU_C = 0.79788456080286535587989211986876  # sqrt(2/pi)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return (xf * (1.0 / (1.0 + torch.exp(-xf)))).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh approximation, matching ggml_gelu."""
    xf = x.to(torch.float32)
    y = 0.5 * xf * (1.0 + torch.tanh(GELU_C * xf * (1.0 + 0.044715 * xf * xf)))
    return y.to(x.dtype)


ACTIVATIONS = {"silu": silu, "gelu": gelu}
