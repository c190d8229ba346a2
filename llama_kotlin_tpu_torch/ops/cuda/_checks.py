"""The wrappers' checks of a weight's tensors before a kernel reads them on
the card: W4/W4X folds (kernels 1, 2, 4, 7, 8, 10), int8-code layouts
(kernels 4, 5, 6) and exact repacks (kernel 4's exact branches).  A module
of its own so that every wrapper imports them at the top, ``qmm`` (whose
``plan`` the decode wrappers import) too."""

from __future__ import annotations

import torch

from llama_kotlin_tpu_torch.device import require
from llama_kotlin_tpu_torch.quant.qtensor import QTensor


def check_w4_on(w: QTensor, device: torch.device) -> None:
    """Every tensor of a W4 or W4X fold lies on `device`, contiguous, in the
    dtypes the kernels read."""
    for name, t in w.tensors().items():
        require(t.device == device, f"W4 {name} on {t.device}, not {device}")
        require(t.is_contiguous(), f"W4 {name} is not contiguous")
    require(w.codes.dtype == torch.uint8, "W4 codes must be uint8")
    require(w.g_scale.dtype == torch.float32 and w.g_min.dtype == torch.float32,
            "W4 g_scale/g_min must be f32")
    if w.aux["flavor"] == "compact":
        require(w.aux["q6"].dtype == torch.uint8 and w.aux["dd"].dtype == torch.float32,
                "compact planes must be uint8 q6 and f32 dd")


def check_int8_on(w: QTensor, device: torch.device) -> None:
    """Every tensor of an int8-code layout (W8 fold, Q8F) lies on `device`,
    contiguous and 16-byte aligned, in the dtypes the kernels read."""
    for name, t in w.tensors().items():
        require(t.device == device, f"{w.flavor} {name} on {t.device}, not {device}")
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{w.flavor} {name} is not contiguous and 16-byte aligned")
    require(w.codes.dtype == torch.int8 and w.g_scale.dtype == torch.float32,
            f"{w.flavor} codes must be int8 and g_scale f32")
    require(w.g_min is None or w.g_min.dtype == torch.float32, f"{w.flavor} g_min must be f32")


SCALE_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.int8: 2}  # csrc/qmm_exact.cu's codes


def check_exact_on(w: QTensor, device: torch.device) -> None:
    """Every tensor of an exact repack lies on `device`, contiguous and
    16-byte aligned (the kernel's cp.async copies), in the dtypes it reads:
    uint8 or int8 codes, f32/uint8/int8 group planes, f32 superblock planes."""
    for name, t in w.tensors().items():
        require(t.device == device, f"exact {name} on {t.device}, not {device}")
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"exact {name} is not contiguous and 16-byte aligned")
    require(w.codes.dtype in (torch.uint8, torch.int8), "exact codes must be uint8 or int8")
    for name in ("g_scale", "g_min"):
        t = getattr(w, name)
        require(t is None or t.dtype in SCALE_DTYPES, f"exact {name} must be f32, uint8 or int8")
    for name in ("sb_scale", "sb_min"):
        t = getattr(w, name)
        require(t is None or t.dtype == torch.float32, f"exact {name} must be f32")
    require(w.sb_min is None or (w.g_min is not None and w.sb_scale is not None),
            "an exact sb_min needs g_min and sb_scale")
