"""GGML tensor types (the port's own copy of the subset it reads).

Mirrors ``llama_kotlin_tpu/quant/formats.py``: the enum values are the GGUF
wire values (ggml.h enum ggml_type), so a QTensor's ``qtype`` means the
same on both sides.
"""

from __future__ import annotations

import enum


class GGMLQuantType(enum.IntEnum):
    """ggml_type enum values as used on the GGUF wire."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    BF16 = 30
