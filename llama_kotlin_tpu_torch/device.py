"""The port's device rule.

Every entry point takes ``device=None``, which means ``"cuda"``.  Without
CUDA that raises unless the caller asked for the CPU explicitly: the port
never falls back to the CPU quietly, because a CPU run of the plain
kernel versions is no measurement of the card.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda (raises if CUDA is absent); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def is_cuda(t: torch.Tensor) -> bool:
    """Kernel-wrapper dispatch: CUDA tensors launch the kernel, CPU tensors
    run the plain version, anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on unsupported device {t.device}")


def require(cond: bool, msg: str) -> None:
    """Wrapper argument check: raises instead of declining, so a shape the
    kernel does not take never silently leaves the kernel path."""
    if not cond:
        raise ValueError(msg)
