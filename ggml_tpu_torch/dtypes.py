"""Dtype system: ggml-compatible type descriptors (the port's own copy of
ggml_tpu/dtypes.py; reference: include/ggml.h:351-392 enum ggml_type,
src/ggml-common.h block layouts).

The enum values MUST match ggml's on-disk numbering — GGUF files identify
tensor dtypes by these integers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

QK_K = 256  # superblock size (reference: src/ggml-common.h:89)
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """On-disk dtype ids (reference: include/ggml.h:351-392)."""

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
    TQ1_0 = 34
    TQ2_0 = 35


@dataclass(frozen=True)
class TypeTraits:
    """Block layout descriptor (analog of ggml_type_traits,
    reference: include/ggml.h:2148-2158)."""

    name: str
    block_size: int  # elements per block (QK)
    type_size: int  # bytes per block
    is_quantized: bool


# sizes mirror the static_asserts in reference: src/ggml-common.h:161-404
_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits("f32", 1, 4, False),
    GGMLType.F16: TypeTraits("f16", 1, 2, False),
    GGMLType.F64: TypeTraits("f64", 1, 8, False),
    GGMLType.BF16: TypeTraits("bf16", 1, 2, False),  # stored as uint16
    GGMLType.I8: TypeTraits("i8", 1, 1, False),
    GGMLType.I16: TypeTraits("i16", 1, 2, False),
    GGMLType.I32: TypeTraits("i32", 1, 4, False),
    GGMLType.I64: TypeTraits("i64", 1, 8, False),
    GGMLType.Q4_0: TypeTraits("q4_0", 32, 2 + 16, True),
    GGMLType.Q4_1: TypeTraits("q4_1", 32, 4 + 16, True),
    GGMLType.Q5_0: TypeTraits("q5_0", 32, 2 + 4 + 16, True),
    GGMLType.Q5_1: TypeTraits("q5_1", 32, 4 + 4 + 16, True),
    GGMLType.Q8_0: TypeTraits("q8_0", 32, 2 + 32, True),
    GGMLType.Q8_1: TypeTraits("q8_1", 32, 4 + 32, True),
    GGMLType.Q2_K: TypeTraits("q2_K", QK_K, 4 + QK_K // 16 + QK_K // 4, True),
    GGMLType.Q3_K: TypeTraits("q3_K", QK_K, 2 + QK_K // 4 + QK_K // 8 + 12, True),
    GGMLType.Q4_K: TypeTraits("q4_K", QK_K, 4 + K_SCALE_SIZE + QK_K // 2, True),
    GGMLType.Q5_K: TypeTraits("q5_K", QK_K, 4 + K_SCALE_SIZE + QK_K // 2 + QK_K // 8, True),
    GGMLType.Q6_K: TypeTraits("q6_K", QK_K, 2 + QK_K // 16 + 3 * QK_K // 4, True),
    GGMLType.Q8_K: TypeTraits("q8_K", QK_K, 4 + QK_K + QK_K // 16 * 2, True),
    GGMLType.TQ1_0: TypeTraits("tq1_0", QK_K, 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5, True),
    GGMLType.TQ2_0: TypeTraits("tq2_0", QK_K, 2 + QK_K // 4, True),
    GGMLType.IQ2_XXS: TypeTraits("iq2_xxs", QK_K, 2 + QK_K // 8 * 2, True),
    GGMLType.IQ2_XS: TypeTraits("iq2_xs", QK_K, 2 + QK_K // 8 * 2 + QK_K // 32, True),
    GGMLType.IQ2_S: TypeTraits("iq2_s", QK_K, 2 + QK_K // 4 + QK_K // 16, True),
    GGMLType.IQ3_XXS: TypeTraits("iq3_xxs", QK_K, 2 + 3 * QK_K // 8, True),
    GGMLType.IQ3_S: TypeTraits("iq3_s", QK_K, 2 + 13 * QK_K // 32 + QK_K // 64, True),
    GGMLType.IQ1_S: TypeTraits("iq1_s", QK_K, 2 + QK_K // 8 + QK_K // 16, True),
    GGMLType.IQ1_M: TypeTraits("iq1_m", QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32, True),
    GGMLType.IQ4_NL: TypeTraits("iq4_nl", 32, 2 + 16, True),
    GGMLType.IQ4_XS: TypeTraits("iq4_xs", QK_K, 2 + 2 + QK_K // 64 + QK_K // 2, True),
}


def get_type_traits(t: GGMLType) -> TypeTraits:
    return _TRAITS[GGMLType(t)]


def row_size(t: GGMLType, n_per_row: int) -> int:
    """Bytes per row of n_per_row elements (reference: ggml_row_size, include/ggml.h:719)."""
    tr = get_type_traits(t)
    if n_per_row % tr.block_size:
        raise ValueError(f"{GGMLType(t).name}: row of {n_per_row} is not whole blocks")
    return n_per_row // tr.block_size * tr.type_size


def is_quantized(t: GGMLType) -> bool:
    return get_type_traits(t).is_quantized


def bf16_bits_to_fp32(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def fp16_bits_to_fp32(bits: np.ndarray) -> np.ndarray:
    """IEEE half bit patterns (uint16) -> float32 (IQ1_M's composite scale)."""
    return np.asarray(bits, dtype=np.uint16).view(np.float16).astype(np.float32)
