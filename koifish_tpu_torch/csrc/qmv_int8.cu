// Int8 decode GEMV with in-kernel activation quantization, for Hopper:
//
//     y = Σ_g (q8(x_g) @ wq_g) · sx[:, g] · s[g, :]
//
// Replaces the Pallas kernel of koifish_tpu/ops/pallas/matmul.py:
// qmv_int8_mxu / _qmv_int8_kernel (:239, call :257, body :281-293). x [m, K]
// bf16 with m <= 32, wq [K, N] int8 codes (row-major, N contiguous), s
// [K/128, N] f32 group scales; y [m, N] bf16. For each 128-wide group g and
// row r of x (the jitted Pallas kernel's rounding, int8.cuh JIT):
//     sx = max(max|x_g| · f32(1/127), 1e-12),   q8 = clip(rint(x_g / sx), ±127)
//     acc = fma(f32(d) · sx, s, acc)   with d = q8 · wq_g exact in int32
// The interpreted Pallas kernel's epilogue agrees best with that fused
// multiply-add (one bf16 output in 32K differs from either form).
//
// What bounds it on the H100: bytes. Each weight code is one byte for 2·m
// operations; at m <= 32 that is far under the int8 ridge (~590 operations
// per byte), so reading the codes once bounds it (Qwen3-0.6B's 7 projections
// of a layer: 15.7 MB of codes + 0.5 MB of scales, ~4.8 µs at 3.35 TB/s).
//
// Design: the product runs transposed, yᵀ = wqᵀ · q8(x)ᵀ, on int8
// mma.sync m16n8k32: the weight tile is the 16-row A operand and the
// activations the 8-column B operand, so m = 1 (chat decode) or 5 (the
// speculative verify) pads only to 8 columns. A block of 4 warps owns 64
// output columns (16 a warp) and a run of K groups (K is split across blocks
// when the column tiles alone cannot fill the 132 SMs, into an f32
// workspace that a second pass sums in split order). Per group it (1)
// quantizes the group's m rows of x, one warp per row (a warp absmax, codes
// packed into shared memory rows padded by 16 bytes), (2) transposes the
// [128 K, 64 N] code tile into shared memory (each thread loads 4 rows of 4
// bytes, coalesced along N, and transposes the 4 x 4 bytes in registers with
// byte permutes), prefetching the next group's words into registers before
// the products, and (3) runs 4 k-steps of mma into int32 registers; the
// exact group sums are scaled into f32 registers. mma.sync, not wgmma; no
// TMA.
#include "int8.cuh"

namespace {

constexpr int GROUP = 128;
constexpr int BN = 64;                 // output columns per block
constexpr int NT = 128;                // 4 warps, 16 columns each
constexpr int MMAX = 32;
constexpr int LD = GROUP + 16;         // bytes per staged row (conflict-free fragments)
constexpr int WORDS = (GROUP / 4) * (BN / 4) / NT;   // 4 x 4-byte blocks per thread

struct Tile {
  uint32_t w[WORDS][4];   // rows 4kb..4kb+3 of columns 4nb..4nb+3, one block each
};

__device__ __forceinline__ void load_tile(Tile& t, const int8_t* __restrict__ wq, int g, int n0,
                                          int N) {
#pragma unroll
  for (int it = 0; it < WORDS; ++it) {
    const int idx = threadIdx.x + it * NT, kb = idx / (BN / 4), nb = idx % (BN / 4);
    const int n = n0 + 4 * nb;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      t.w[it][i] = n < N ? *reinterpret_cast<const uint32_t*>(
                               wq + static_cast<long long>(g * GROUP + 4 * kb + i) * N + n)
                         : 0u;   // N % 4 == 0: a word is all in or all out
  }
}

// Wt[n][k] = wq[k][n] for the tile's 4 x 4 byte blocks
__device__ __forceinline__ void store_tile(const Tile& t, int8_t* Wt) {
#pragma unroll
  for (int it = 0; it < WORDS; ++it) {
    const int idx = threadIdx.x + it * NT, kb = idx / (BN / 4), nb = idx % (BN / 4);
    const uint32_t* r = t.w[it];
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140), lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362), hi23 = __byte_perm(r[2], r[3], 0x7362);
    uint32_t* dst = reinterpret_cast<uint32_t*>(Wt + (4 * nb) * LD + 4 * kb);
    dst[0] = __byte_perm(lo01, lo23, 0x5410);            // column 4nb: rows 4kb..+3
    dst[LD / 4] = __byte_perm(lo01, lo23, 0x7632);
    dst[2 * LD / 4] = __byte_perm(hi01, hi23, 0x5410);
    dst[3 * LD / 4] = __byte_perm(hi01, hi23, 0x7632);
  }
}

template <int MT>   // m8 tiles of x: ceil(m / 8)
__global__ void __launch_bounds__(NT)
    qmv_int8_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ scales, bf16* __restrict__ out,
                    float* __restrict__ partial, int m, int K, int N, int groups_per_split) {
  __shared__ __align__(16) int8_t Wt[BN * LD];
  __shared__ __align__(16) int8_t Xq[MMAX * LD];
  __shared__ float SX[MMAX];
  __shared__ float SS[BN];

  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const int g_begin = split * groups_per_split;
  const int g_end = min(K / GROUP, g_begin + groups_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;

  // rows m .. 8·MT-1 of the activation codes stay zero
  for (int i = threadIdx.x; i < (8 * MT - m) * (GROUP / 4); i += NT)
    reinterpret_cast<uint32_t*>(Xq + (m + i / (GROUP / 4)) * LD)[i % (GROUP / 4)] = 0u;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;

  Tile tile;
  if (g_begin < g_end) load_tile(tile, wq, g_begin, n0, N);
  for (int g = g_begin; g < g_end; ++g) {
    store_tile(tile, Wt);
    // quantize the group's rows of x: warp w takes rows w, w + 4, ...
    for (int r = warp; r < m; r += NT / 32) {
      const uint2 u =
          *reinterpret_cast<const uint2*>(x + static_cast<long long>(r) * K + g * GROUP + 4 * lane);
      const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      const float a = warp_max(fmaxf(fmaxf(fabsf(f0.x), fabsf(f0.y)), fmaxf(fabsf(f1.x), fabsf(f1.y))));
      const Q8 q = q8_scale<JIT>(a);
      reinterpret_cast<uint32_t*>(Xq + r * LD)[lane] =
          pack4(q8_code<JIT>(f0.x, q), q8_code<JIT>(f0.y, q), q8_code<JIT>(f1.x, q),
                q8_code<JIT>(f1.y, q));
      if (lane == 0) SX[r] = q.scale;
    }
    if (threadIdx.x < BN)
      SS[threadIdx.x] = n0 + threadIdx.x < N ? scales[static_cast<long long>(g) * N + n0 + threadIdx.x]
                                             : 0.f;
    __syncthreads();
    if (g + 1 < g_end) load_tile(tile, wq, g + 1, n0, N);   // in flight during the products

    int d[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][i] = 0;
#pragma unroll
    for (int kk = 0; kk < GROUP; kk += 32) {
      uint32_t a[4];
      load_a_s8(a, Wt, LD, warp * 16, kk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t b0, b1;
        load_b_s8(b0, b1, Xq, LD, mt * 8, kk);
        mma_s8(d[mt], a, b0, b1);
      }
    }
    // d[mt] = {D[gq][2tq], D[gq][2tq+1], D[gq+8][2tq], D[gq+8][2tq+1]}: D's
    // rows are output columns, its columns rows of x
    const float s_lo = SS[warp * 16 + gq], s_hi = SS[warp * 16 + gq + 8];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = mt * 8 + 2 * tq;
      const float sx0 = SX[r], sx1 = SX[r + 1];   // rows >= m: unused (zero codes)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[mt][i] = __fmaf_rn(__fmul_rn(static_cast<float>(d[mt][i]), (i & 1) ? sx1 : sx0),
                               i < 2 ? s_lo : s_hi, acc[mt][i]);
    }
    __syncthreads();   // Wt, Xq, SX and SS are rewritten by the next group
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mt * 8 + 2 * tq + (i & 1);
      const int n = n0 + warp * 16 + gq + (i < 2 ? 0 : 8);
      if (r >= m || n >= N) continue;
      const long long at = static_cast<long long>(r) * N + n;
      if (partial != nullptr)
        partial[static_cast<long long>(split) * m * N + at] = acc[mt][i];
      else
        out[at] = __float2bfloat16(acc[mt][i]);
    }
}

// Sum the K-split partials in split order and round to bf16.
__global__ void splitk_reduce(const float* __restrict__ partial, bf16* __restrict__ out,
                              int splits, long long mn) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * mn + i];
  out[i] = __float2bfloat16(s);
}

template <int MT>
void launch(dim3 grid, cudaStream_t stream, const void* x, const void* wq, const void* scales,
            void* out, float* partial, int m, int K, int N, int gps) {
  qmv_int8_kernel<MT><<<grid, NT, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scales), static_cast<bf16*>(out), partial, m, K, N, gps);
}

}  // namespace

// y [m, N] bf16 = the int8 GEMV of x [m, K] bf16 (m <= 32) against wq [K, N]
// int8 with group scales s [K/128, N] f32; K % 128 == 0, N % 4 == 0, all
// row-major and contiguous. gps groups of K per block; with more than one
// split, work holds [splits, m, N] f32.
KOIFISH_API int koifish_qmv_int8(const void* x, const void* wq, const void* scales, void* out,
                                 void* work, int m, int K, int N, int gps, void* stream) {
  if (m < 1 || m > MMAX || K < GROUP || K % GROUP != 0 || N < 4 || N % 4 != 0 || gps < 1)
    return cudaErrorInvalidValue;
  const int splits = (K / GROUP + gps - 1) / gps;
  float* partial = splits > 1 ? static_cast<float*>(work) : nullptr;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, splits);
  switch ((m + 7) / 8) {
    case 1: launch<1>(grid, s, x, wq, scales, out, partial, m, K, N, gps); break;
    case 2: launch<2>(grid, s, x, wq, scales, out, partial, m, K, N, gps); break;
    case 3: launch<3>(grid, s, x, wq, scales, out, partial, m, K, N, gps); break;
    default: launch<4>(grid, s, x, wq, scales, out, partial, m, K, N, gps); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = static_cast<long long>(m) * N;
  splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      partial, static_cast<bf16*>(out), splits, mn);
  return cudaGetLastError();
}
