// Per-tile dynamic-int8 dgrad for Hopper: dx = dy · (wq·sw)ᵀ at the int8
// tensor-core rate.
//
// Replaces the Pallas kernel of koifish_tpu/ops/pallas/qdgrad.py:
// _dgrad_call (:57, call :61, body :90-107). dy [M, N] bf16 row-major, wq
// [K, N] int8 (the forward's column-quantized codes of w [K, N]), sw [N] f32
// (their column scales); dx [M, K] bf16. For each 1024-column tile j of dy
// (the tile defines the scales, so it is part of the function, N % 1024 ==
// 0):
//     t  = dy_j · sw_j                       (f32)
//     sx = max(rowmax|t| · f32(1/127), 1e-12) (one scale per row and tile)
//     dx = fma((q8(t) · wq_jᵀ)_int32, sx, dx) (f32, rounded to bf16 at the end)
// with q8(t) = clip(rint(t / sx), ±127): the jitted Pallas kernel's rounding
// (int8.cuh, JIT).
//
// Design: a block owns a [64 rows, 128 K] tile of dx and walks N in the
// 1024-wide tiles of the function. Per tile it stages sw, takes each row's
// absmax of the folded dy (one pass over the [64, 1024] dy tile; the 10
// K-tiles of a row block repeat it, cheaply), then walks the tile in 64-wide
// chunks: the chunk of dy is folded and quantized into shared memory, the
// [128 K, 64] slice of wq comes in by cp.async, and 8 warps (each a [32, 32]
// piece of the output) run int8 mma.sync m16n8k32 into int32 registers. At
// the end of a tile the int32 sums are scaled by the row's sx into the f32
// registers of dx with one fused multiply-add, as XLA compiles the Pallas
// kernel's ``acc += d·sx``: the plain version emulates it in f64.
//
// What bounds it on the H100: operations. 2·M·N·K int8 operations at 1,979
// TOPS (the fc dgrad of GPT2-774M, dy [16384, 5120], wq [1280, 5120]: 0.109
// ms) against 0.065 ms of bytes. This kernel reads dy twice per K-tile from
// L2 and uses mma.sync, not wgmma, and no TMA.
#include "int8.cuh"

namespace {

constexpr int BM = 64, BK = 128, BN = 1024, NS = 64, NT = 256;
constexpr int LDQ = NS + 16;   // bytes per staged row: conflict-free fragment loads

__global__ void __launch_bounds__(NT)
    qdgrad_kernel(const bf16* __restrict__ dy, const int8_t* __restrict__ wq,
                  const float* __restrict__ sw, bf16* __restrict__ dx, int M, int N, int K) {
  __shared__ float SW[BN];
  __shared__ float SX[BM];
  __shared__ __align__(16) int8_t Q[BM * LDQ];
  __shared__ __align__(16) int8_t W[BK * LDQ];

  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;   // this warp's [32, 32] piece

  int acc[2][4][4];
  float facc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mi][ni][i] = 0;
        facc[mi][ni][i] = 0.f;
      }

  for (int j0 = 0; j0 < N; j0 += BN) {
    for (int i = threadIdx.x; i < BN; i += NT) SW[i] = sw[j0 + i];
    __syncthreads();
    // the row scales of this tile: warp w takes rows 8w .. 8w + 7
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr, row = m0 + r;
      float a = 0.f;
      if (row < M) {
        const bf16* p = dy + static_cast<long long>(row) * N + j0;
        for (int c = lane * 8; c < BN; c += 256) {
          const uint4 u = *reinterpret_cast<const uint4*>(p + c);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            a = fmaxf(a, fabsf(__fmul_rn(f.x, SW[c + 2 * i])));
            a = fmaxf(a, fabsf(__fmul_rn(f.y, SW[c + 2 * i + 1])));
          }
        }
      }
      a = warp_max(a);
      if (lane == 0) SX[r] = q8_scale<JIT>(a).scale;
    }
    __syncthreads();
    for (int s = 0; s < BN; s += NS) {
      const int n0 = j0 + s;
      for (int i = threadIdx.x; i < BK * (NS / 16); i += NT) {
        const int r = i / (NS / 16), c = (i % (NS / 16)) * 16;
        const bool in = k0 + r < K;
        cp_async16(W + r * LDQ + c, in ? wq + static_cast<long long>(k0 + r) * N + n0 + c : wq,
                   in ? 16 : 0);
      }
      cp_async_commit();
      for (int i = threadIdx.x; i < BM * (NS / 8); i += NT) {
        const int r = i / (NS / 8), c = (i % (NS / 8)) * 8, row = m0 + r;
        uint2 packed = make_uint2(0u, 0u);
        if (row < M) {
          const uint4 u = *reinterpret_cast<const uint4*>(dy + static_cast<long long>(row) * N +
                                                          n0 + c);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
          Q8 q;
          q.scale = SX[r];
          q.recip = 0.f;
          int code[8];
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2) {
            const float2 f = __bfloat1622float2(h[i2]);
            code[2 * i2] = q8_code<JIT>(__fmul_rn(f.x, SW[s + c + 2 * i2]), q);
            code[2 * i2 + 1] = q8_code<JIT>(__fmul_rn(f.y, SW[s + c + 2 * i2 + 1]), q);
          }
          packed.x = pack4(code[0], code[1], code[2], code[3]);
          packed.y = pack4(code[4], code[5], code[6], code[7]);
        }
        *reinterpret_cast<uint2*>(Q + r * LDQ + c) = packed;
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NS; kk += 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) load_a_s8(a[mi], Q, LDQ, wr + mi * 16, kk);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          uint32_t b0, b1;
          load_b_s8(b0, b1, W, LDQ, wc + ni * 8, kk);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
        }
      }
      __syncthreads();
    }
    // dx += d · sx, per row, in f32 (the Pallas kernel's acc update)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float sa = SX[wr + mi * 16 + g], sb = SX[wr + mi * 16 + g + 8];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          facc[mi][ni][i] =
              __fmaf_rn(static_cast<float>(acc[mi][ni][i]), i < 2 ? sa : sb, facc[mi][ni][i]);
          acc[mi][ni][i] = 0;
        }
      }
    }
    __syncthreads();   // SW and SX are rewritten by the next tile
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wr + mi * 16 + g + (i < 2 ? 0 : 8);
        const int col = k0 + wc + ni * 8 + 2 * t + (i & 1);
        if (row < M && col < K)
          dx[static_cast<long long>(row) * K + col] = __float2bfloat16(facc[mi][ni][i]);
      }
}

}  // namespace

// dx [M, K] bf16 = per-tile int8 dgrad of dy [M, N] bf16 against wq [K, N]
// int8 and sw [N] f32; N a multiple of 1024, all row-major and contiguous
KOIFISH_API int koifish_qdgrad(const void* dy, const void* wq, const void* sw, void* dx, int M,
                               int N, int K, void* stream) {
  if (M < 1 || K < 1 || N < BN || N % BN != 0) return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (K + BK - 1) / BK);
  qdgrad_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<bf16*>(dx), M, N, K);
  return cudaGetLastError();
}
