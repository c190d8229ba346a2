"""GGML tensor types and their block geometry (the port's own copy of
``llama_kotlin_tpu/quant/formats.py``).

The enum values are the GGUF wire values (ggml.h enum ggml_type), so a
QTensor's ``qtype`` means the same on both sides.  ``TYPE_TRAITS`` sizes
every type a GGUF file may name, so the reader can step over tensors whose
format the port does not decode.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

QK_K = 256  # super-block size of the K-quants
K_SCALE_SIZE = 12


class GGMLQuantType(enum.IntEnum):
    """ggml_type enum values as used on the GGUF wire."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3 (removed upstream)
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
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    Q4_0_4_4 = 31
    Q4_0_4_8 = 32
    Q4_0_8_8 = 33


@dataclass(frozen=True)
class TypeTraits:
    """Block geometry of one tensor type."""

    name: str
    block_size: int  # elements per block
    type_size: int  # bytes per block
    is_quantized: bool

    @property
    def bits_per_weight(self) -> float:
        return 8.0 * self.type_size / self.block_size


TYPE_TRAITS: dict[GGMLQuantType, TypeTraits] = {
    GGMLQuantType.F32: TypeTraits("f32", 1, 4, False),
    GGMLQuantType.F16: TypeTraits("f16", 1, 2, False),
    GGMLQuantType.BF16: TypeTraits("bf16", 1, 2, False),
    GGMLQuantType.F64: TypeTraits("f64", 1, 8, False),
    GGMLQuantType.I8: TypeTraits("i8", 1, 1, False),
    GGMLQuantType.I16: TypeTraits("i16", 1, 2, False),
    GGMLQuantType.I32: TypeTraits("i32", 1, 4, False),
    GGMLQuantType.I64: TypeTraits("i64", 1, 8, False),
    # legacy 32-element blocks
    GGMLQuantType.Q4_0: TypeTraits("q4_0", 32, 2 + 16, True),
    GGMLQuantType.Q4_1: TypeTraits("q4_1", 32, 4 + 16, True),
    GGMLQuantType.Q5_0: TypeTraits("q5_0", 32, 2 + 4 + 16, True),
    GGMLQuantType.Q5_1: TypeTraits("q5_1", 32, 4 + 4 + 16, True),
    GGMLQuantType.Q8_0: TypeTraits("q8_0", 32, 2 + 32, True),
    GGMLQuantType.Q8_1: TypeTraits("q8_1", 32, 4 + 32, True),
    # K-quants: 256-element super-blocks
    GGMLQuantType.Q2_K: TypeTraits("q2_K", QK_K, QK_K // 16 + QK_K // 4 + 4, True),
    GGMLQuantType.Q3_K: TypeTraits("q3_K", QK_K, QK_K // 8 + QK_K // 4 + 12 + 2, True),
    GGMLQuantType.Q4_K: TypeTraits("q4_K", QK_K, 4 + K_SCALE_SIZE + QK_K // 2, True),
    GGMLQuantType.Q5_K: TypeTraits("q5_K", QK_K, 4 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2, True),
    GGMLQuantType.Q6_K: TypeTraits("q6_K", QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2, True),
    GGMLQuantType.Q8_K: TypeTraits("q8_K", QK_K, 4 + QK_K + QK_K // 16 * 2, True),
    # codebook (IQ) quants
    GGMLQuantType.IQ2_XXS: TypeTraits("iq2_xxs", QK_K, 2 + QK_K // 8 * 2, True),
    GGMLQuantType.IQ2_XS: TypeTraits("iq2_xs", QK_K, 2 + QK_K // 8 * 2 + QK_K // 32, True),
    GGMLQuantType.IQ2_S: TypeTraits("iq2_s", QK_K, 2 + QK_K // 4 + QK_K // 16, True),
    GGMLQuantType.IQ3_XXS: TypeTraits("iq3_xxs", QK_K, 2 + 3 * QK_K // 8, True),
    GGMLQuantType.IQ3_S: TypeTraits("iq3_s", QK_K, 2 + 13 * QK_K // 32 + QK_K // 64, True),
    GGMLQuantType.IQ1_S: TypeTraits("iq1_s", QK_K, 2 + QK_K // 8 + QK_K // 16, True),
    GGMLQuantType.IQ1_M: TypeTraits("iq1_m", QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32, True),
    GGMLQuantType.IQ4_NL: TypeTraits("iq4_nl", 32, 2 + 16, True),
    GGMLQuantType.IQ4_XS: TypeTraits("iq4_xs", QK_K, 2 + 2 + QK_K // 64 + QK_K // 2, True),
}


def block_count(n_elements: int, qtype: GGMLQuantType) -> int:
    traits = TYPE_TRAITS[qtype]
    if n_elements % traits.block_size != 0:
        raise ValueError(f"{n_elements} elements not divisible by {traits.name} "
                         f"block size {traits.block_size}")
    return n_elements // traits.block_size


def row_byte_size(n_elements: int, qtype: GGMLQuantType) -> int:
    """Bytes for a row of n_elements in the wire format (cf. ggml_row_size)."""
    return block_count(n_elements, qtype) * TYPE_TRAITS[qtype].type_size
