"""FFN activations (port of ``llama_kotlin_tpu/ops/activations.py``):
computed in f32, cast back to the input dtype (relu and relu2 agree bit for
bit with JAX's in-dtype ones: max is exact, and a bf16 square fits f32
exactly, so its one rounding is the same)."""

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


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.to(torch.float32), 0.0).to(x.dtype)


def relu2(x: torch.Tensor) -> torch.Tensor:
    """relu(x)^2 (nemotron's FFN, JAX ``relu_squared``)."""
    r = torch.clamp_min(x.to(torch.float32), 0.0)
    return (r * r).to(x.dtype)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": relu, "relu2": relu2}
