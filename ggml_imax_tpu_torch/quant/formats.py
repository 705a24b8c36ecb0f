"""Block-quantization format metadata (the port's own copy of
ggml_imax_tpu/quant/formats.py, trimmed to the float and the
non-codebook block formats).

`GGMLType` keeps ggml's integer values so a type read from the JAX package
or a GGUF file maps by value.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

QK = 32      # block size of the "basic" formats
QK_K = 256   # super-block size of the K-quant formats


class GGMLType(enum.IntEnum):
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


@dataclass(frozen=True)
class FormatInfo:
    name: str
    block_size: int   # number of dequantized values per block
    type_size: int    # bytes per block
    is_quantized: bool


FORMATS: dict[GGMLType, FormatInfo] = {
    GGMLType.F32: FormatInfo("f32", 1, 4, False),
    GGMLType.F16: FormatInfo("f16", 1, 2, False),
    GGMLType.BF16: FormatInfo("bf16", 1, 2, False),
    GGMLType.Q4_0: FormatInfo("q4_0", QK, 2 + QK // 2, True),
    GGMLType.Q4_1: FormatInfo("q4_1", QK, 4 + QK // 2, True),
    GGMLType.Q5_0: FormatInfo("q5_0", QK, 2 + 4 + QK // 2, True),
    GGMLType.Q5_1: FormatInfo("q5_1", QK, 4 + 4 + QK // 2, True),
    GGMLType.Q8_0: FormatInfo("q8_0", QK, 2 + QK, True),
    GGMLType.Q8_1: FormatInfo("q8_1", QK, 4 + QK, True),
    # scales, 2-bit quants, d, dmin
    GGMLType.Q2_K: FormatInfo("q2_K", QK_K, QK_K // 16 + QK_K // 4 + 4, True),
    # hmask, 2-bit quants, 12 bytes of 6-bit scales, d
    GGMLType.Q3_K: FormatInfo("q3_K", QK_K, QK_K // 8 + QK_K // 4 + 12 + 2,
                              True),
    # d, dmin, 12 bytes of 6-bit scales and mins, 4-bit quants
    GGMLType.Q4_K: FormatInfo("q4_K", QK_K, 2 + 2 + 12 + QK_K // 2, True),
    # d, dmin, 12 bytes of 6-bit scales and mins, high bits, 4-bit quants
    GGMLType.Q5_K: FormatInfo("q5_K", QK_K,
                              2 + 2 + 12 + QK_K // 8 + QK_K // 2, True),
    # low nibbles, high 2-bit pairs, 16 int8 scales, d
    GGMLType.Q6_K: FormatInfo("q6_K", QK_K,
                              QK_K // 2 + QK_K // 4 + QK_K // 16 + 2, True),
    # f32 d, int8 quants, 16 int16 sums of 16
    GGMLType.Q8_K: FormatInfo("q8_K", QK_K, 4 + QK_K + QK_K // 16 * 2, True),
}
