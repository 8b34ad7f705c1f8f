// What the warp-specialised flash kernels share (flash_fwd.cu, flash_bwd.cu
// at D = 64 and 128): 384-thread blocks of two consumer warpgroups and one
// producer warpgroup, [B,T,H,D] rows copied by cp.async into B128-swizzled
// tiles, and the wgmma products between them (sm90.cuh), with S-like
// accumulators turned into bf16 register fragments for the next product.
#pragma once

#include "sm90.cuh"

namespace {

constexpr int WS_THREADS = 384;

constexpr uint32_t align1024(uint32_t x) { return (x + 1023u) / 1024u * 1024u; }

constexpr float LOG2E = 1.4426950408889634f;

// the k16 register fragments of a 64 x N accumulator (bf16, k = N)
template <int N>
__device__ __forceinline__ void acc_to_frags(uint32_t (&f)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d (64 x N, f32) = A(64 rows of a K-major tile from row r0) · B(N rows of a
// K-major tile from row b0)ᵀ over D
template <int D, int N>
__device__ __forceinline__ void qk_t(float (&d)[N / 2], uint32_t a, int ra, int r0, uint32_t b,
                                     int rb, int b0 = 0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (N == 16)
      wgmma_ss_n16<0>(d, desc_k(a, ra, r0, kk), desc_k(b, rb, b0, kk), kk > 0);
    else if constexpr (N == 64)
      wgmma_ss_n64<0>(d, desc_k(a, ra, r0, kk), desc_k(b, rb, b0, kk), kk > 0);
    else
      wgmma_ss_n128<0>(d, desc_k(a, ra, r0, kk), desc_k(b, rb, b0, kk), kk > 0);
  }
}

// d (64 x D) += frags(64 x 16·KS) · B(rows k0 .. k0 + 16·KS of an MN-major
// tile of rb rows x D)
template <int D, int KS>
__device__ __forceinline__ void pv(float (&d)[D / 2], const uint32_t (&f)[KS][4], uint32_t b,
                                   int rb, int k0 = 0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_n64<1>(d, f[kk], desc_mn(b + k0 * 128, rb, kk), 1);
    else
      wgmma_rs_n128<1>(d, f[kk], desc_mn(b + k0 * 128, rb, kk), 1);
  }
}

// Copy rows [r0, r0 + R) of one head of a [B,T,H,D] tensor (row stride st)
// into a swizzled tile of R rows; rows past T are zero. Thread i of NT.
template <int D, int R, int NT>
__device__ __forceinline__ void copy_rows(unsigned char* tile, const bf16* src, long long st,
                                          int r0, int T, int i0) {
  constexpr int CH = D / 8;
  for (int i = i0; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < T;
    cp_async16(tile + sw128(r, c, R), in ? src + (r0 + r) * st + c * 8 : src, in ? 16 : 0);
  }
}

// rows [r_lo, r_lo + n) of a swizzled tile of R rows: dst = bf16(f32(src)·scale)
template <int D, int R>
__device__ __forceinline__ void scale_tile(unsigned char* dst, const unsigned char* src, int r_lo,
                                           int n, float scale, int i0, int nt) {
  constexpr int CH = D / 8;
  for (int i = i0; i < n * CH; i += nt) {
    const int r = r_lo + i / CH, c = i % CH;
    const uint32_t off = sw128(r, c, R);
    uint4 val = *reinterpret_cast<const uint4*>(src + off);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(__bfloat162float(e[k]) * scale);
    *reinterpret_cast<uint4*>(dst + off) = val;
  }
}

}  // namespace
