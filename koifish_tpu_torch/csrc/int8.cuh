// int8 helpers shared by the int8 kernels (quantize, qdgrad, the int8
// GEMV): the three absmax rounding conventions and the int8 tensor core
// product.
#pragma once

#include "common.cuh"

// Rounding conventions of an absmax int8 quantizer, scale s and code q of x
// for a line whose largest |x| is a (all f32, round half to even, codes
// clipped to [-127, 127]):
//   PALLAS: s = max(a, 1e-12)·f32(1/127),  q = rint(x · (127 / max(a, 1e-12)))
//           (koifish_tpu/ops/pallas/quantize.py rowquant / colquant)
//   JIT:    s = max(a · f32(1/127), 1e-12), q = rint(x / s)
//           (int8_train._rowwise_q8 / _colwise_q8 and the fused CE's
//           quantizers as XLA compiles them: a division by the constant 127
//           becomes a product with its f32 reciprocal)
//   EAGER:  s = max(a / 127, 1e-12),         q = rint(x / s)
//           (the same functions run op by op)
enum Rounding { PALLAS = 0, JIT = 1, EAGER = 2 };

struct Q8 {
  float scale, recip;   // recip: 127 / max(a, 1e-12) (PALLAS) or fl(1 / scale) (JIT)
};

template <int MODE>
__device__ __forceinline__ Q8 q8_scale(float absmax) {
  Q8 r;
  if (MODE == PALLAS) {
    const float am = fmaxf(absmax, 1e-12f);
    r.scale = __fmul_rn(am, 1.0f / 127.0f);
    r.recip = __fdiv_rn(127.0f, am);
  } else if (MODE == JIT) {
    r.scale = fmaxf(__fmul_rn(absmax, 1.0f / 127.0f), 1e-12f);
    r.recip = __frcp_rn(r.scale);
  } else {
    r.scale = fmaxf(__fdiv_rn(absmax, 127.0f), 1e-12f);
    r.recip = 0.f;
  }
  return r;
}

// JIT takes rint(x·fl(1/s)) and divides only where x·fl(1/s) lies within
// 2^-14 of a rounding boundary: for |x / s| <= 128 (any x of the line whose
// absmax made s) x·fl(1/s) (two roundings) and the rounded quotient fl(x / s)
// are within 2.3e-5 of each other, so away from the boundaries both round to
// the same integer, and the code is rint(x / s)'s.
template <int MODE>
__device__ __forceinline__ int q8_code(float x, Q8 s) {
  float c;
  if (MODE == JIT) {
    const float v = __fmul_rn(x, s.recip);
    c = rintf(v);
    if (fabsf(v - c) > 0.5f - 6.103515625e-05f) c = rintf(__fdiv_rn(x, s.scale));
  } else {
    c = rintf(MODE == PALLAS ? __fmul_rn(x, s.recip) : __fdiv_rn(x, s.scale));
  }
  return static_cast<int>(fminf(fmaxf(c, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b for one m16n8k32 tile (s8 in, s32 accumulate). Fragments
// (groupID g = lane / 4, t = lane % 4):
//   a: {A[g][4t..+3], A[g+8][4t..+3], A[g][16+4t..+3], A[g+8][16+4t..+3]}
//      of a row-major 16 x 32 A (k along the row)
//   b: {B[4t..+3][g], B[16+4t..+3][g]} of a 32 x 8 B, i.e. 4 bytes of
//      row g of Bᵀ (k contiguous)
//   d: {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the a fragment of rows [r0, r0 + 16) x k [k0, k0 + 32) of a row-major int8
// tile with row stride ld bytes (4-byte aligned rows)
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], const int8_t* A, int ld, int r0,
                                          int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int8_t* p = A + (r0 + g) * ld + k0 + 4 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 16);
  a[3] = lds32(p + 8 * ld + 16);
}

// the b fragment of columns [n0, n0 + 8) x k [k0, k0 + 32) of a B whose
// transpose is a row-major int8 tile Bt[n][k] with row stride ld bytes
__device__ __forceinline__ void load_b_s8(uint32_t& b0, uint32_t& b1, const int8_t* Bt, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int8_t* p = Bt + (n0 + g) * ld + k0 + 4 * t;
  b0 = lds32(p);
  b1 = lds32(p + 16);
}
