// What the dequant-fused GEMV (qmatmul.cu) and GEMM (qmm.cu) share: the
// code formats (the decode of one packed code to its bf16 value) and the
// shared memory a learned book takes.
#pragma once

#include "common.cuh"

namespace {

constexpr int GROUP = 128;

enum Fmt { INT8 = 0, INT4, NF4, INT3, NF3, INT2, TERNARY, BINARY };

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};
__constant__ float kNF3[8] = {-1.0f, -0.5350227355957031f, -0.2469314038753510f, 0.0f,
                              0.1833375245332718f, 0.3819939494132996f, 0.6229856610298157f,
                              1.0f};

template <int FMT>
struct Codes {
  static constexpr int BITS = FMT == INT8 ? 8 : (FMT == INT2 || FMT == TERNARY) ? 2
                                                : FMT == BINARY                 ? 1
                                                                                : 4;
  static constexpr int CPB = 8 / BITS;       // codes per byte
  static constexpr int SUB = GROUP / CPB;    // byte rows per group
  static __device__ __forceinline__ bf16 value(uint32_t raw) {
    if (FMT == INT8) return __float2bfloat16(static_cast<float>(static_cast<int8_t>(raw)));
    if (FMT == NF4) return __float2bfloat16(kNF4[raw]);
    if (FMT == NF3) return __float2bfloat16(kNF3[raw]);
    if (FMT == TERNARY) return __float2bfloat16(static_cast<float>(static_cast<int>(raw) - 1));
    if (FMT == BINARY) return __float2bfloat16(static_cast<float>(2 * static_cast<int>(raw) - 1));
    // INT4 / INT3 / INT2: biased by 2^(bits-1)
    constexpr int bias = FMT == INT4 ? 8 : FMT == INT3 ? 4 : 2;
    return __float2bfloat16(static_cast<float>(static_cast<int>(raw) - bias));
  }
};

// entries of a learned book of a format (2^bits), and the shared memory a
// block keeps for the book rows of one group
template <int FMT, bool BOOK>
struct Book {
  static constexpr int NB = FMT == NF3 ? 8 : 16;
  static constexpr size_t BYTES = BOOK ? sizeof(float) * GROUP * NB : 0;
};

}  // namespace
