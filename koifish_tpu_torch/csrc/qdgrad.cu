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
// What bounds it on the H100: operations. 2·M·N·K int8 operations at 1,979
// TOPS (the fc dgrad of GPT2-774M, dy [16384, 5120], wq [1280, 5120]: 0.109
// ms) against 0.065 ms of bytes.
//
// Design: two launches.
//   1. The quantize pass (qdgrad_quant_kernel) reads dy once, one warp per
//      (row, 1024-column tile): it folds in sw, takes the tile's absmax and
//      writes the codes q [M, N] int8 and the scales sx [M, N/1024] f32, the
//      codes and scales the Pallas kernel forms in VMEM. Each code is made
//      once (a kernel that quantizes inside the GEMM's blocks makes it once
//      for every column tile of dx).
//   2. The GEMM (qdgrad_gemm_kernel): dx = Σ_j (q_j · wq_jᵀ) · sx_j, with N
//      the contraction axis, contiguous in both q and wq: both operands are
//      K-major, the only order wgmma reads 8-bit types in. Persistent and
//      warp-specialised, 384 threads: the producer warpgroup's one thread
//      streams [128 rows x 128 bytes of N] tiles of q and wq by TMA into a
//      6-stage ring of 128-byte-swizzled stages (a "full" and an "empty"
//      mbarrier each); consumer warpgroups 0 and 1 each own 64 rows of a
//      128 x 128 tile of dx and run wgmma m64n128k32 s8 into 64 int32
//      registers a thread over a scale tile's 1024 columns (32 k32 steps,
//      8 ring stages), then fold them into 64 f32 registers with one fused
//      multiply-add per entry, fma(f32(acc), sx, dx), and restart the int32
//      sum (scale_d = 0): the tiles are summed in order, so dx is the plain
//      version's bit for bit. dx is written as bf16 straight from the
//      registers, ragged rows and columns masked (any M and K). The grid is
//      one block per SM (the ring fills its shared memory), walking the
//      128 x 128 tiles of dx.
//   Two f32 and int32 accumulators per entry limit a consumer to n128 (128
//   registers); an m64n256 tile would need 256. The quantize pass makes its
//   codes with q8_code<JIT> (int8.cuh): a product by 1/sx, and the division
//   only near a rounding boundary.
#include "int8.cuh"
#include "sm90.cuh"

namespace {

constexpr int TN = 1024;                // columns of dy per scale tile

// ---------------------------------------------------------------------------
// 1. the quantize pass
// ---------------------------------------------------------------------------

constexpr int QWARPS = 8;

__global__ void __launch_bounds__(QWARPS * 32)
    qdgrad_quant_kernel(const bf16* __restrict__ dy, const float* __restrict__ sw,
                        int8_t* __restrict__ q, float* __restrict__ sx, int M, int N) {
  const int tiles = N / TN, lane = threadIdx.x % 32;
  const long long line = static_cast<long long>(blockIdx.x) * QWARPS + threadIdx.x / 32;
  if (line >= static_cast<long long>(M) * tiles) return;
  const long long row = line / tiles;
  const int j = static_cast<int>(line % tiles);
  const long long base = row * N + static_cast<long long>(j) * TN;
  // lane takes columns 256·i + 8·lane .. + 7 of the tile, i = 0..3
  float t[32];
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = i * 256 + lane * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(dy + base + c);
    const float4 s0 = *reinterpret_cast<const float4*>(sw + j * TN + c);
    const float4 s1 = *reinterpret_cast<const float4*>(sw + j * TN + c + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      t[8 * i + 2 * e] = __fmul_rn(f.x, s[2 * e]);
      t[8 * i + 2 * e + 1] = __fmul_rn(f.y, s[2 * e + 1]);
      a = fmaxf(a, fmaxf(fabsf(t[8 * i + 2 * e]), fabsf(t[8 * i + 2 * e + 1])));
    }
  }
  const Q8 sc = q8_scale<JIT>(warp_max(a));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* v = t + 8 * i;
    *reinterpret_cast<uint2*>(q + base + i * 256 + lane * 8) = make_uint2(
        pack4(q8_code<JIT>(v[0], sc), q8_code<JIT>(v[1], sc), q8_code<JIT>(v[2], sc),
              q8_code<JIT>(v[3], sc)),
        pack4(q8_code<JIT>(v[4], sc), q8_code<JIT>(v[5], sc), q8_code<JIT>(v[6], sc),
              q8_code<JIT>(v[7], sc)));
  }
  if (lane == 0) sx[line] = sc.scale;
}

// ---------------------------------------------------------------------------
// 2. the GEMM
// ---------------------------------------------------------------------------

constexpr int THREADS = 384;            // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int BM = 128, BK = 128;       // dx tile: rows x columns
constexpr uint32_t RING = 128;          // bytes of N a ring stage carries (a swizzled row)
constexpr int STAGES = 6;
constexpr uint32_t A_TILE = BM * RING, B_TILE = BK * RING, STAGE = A_TILE + B_TILE;
constexpr uint32_t BAR = STAGES * STAGE;               // full[S], empty[S]
constexpr uint32_t ALLOC = BAR + 16 * STAGES + 1024;
static_assert(ALLOC <= 232448, "qdgrad: shared memory");

__global__ void __launch_bounds__(THREADS, 1)
    qdgrad_gemm_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap wmap, const float* __restrict__ sx,
                       bf16* __restrict__ dx, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR);
  uint64_t* empty = full + STAGES;
  // a work item: one 128 x 128 tile of dx
  const int ct = (K + BK - 1) / BK, items = ((M + BM - 1) / BM) * ct;
  const int tiles = N / TN, nk = TN / RING;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);   // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg == 2) {   // producer: one thread streams q and wq tiles by TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t128 == 0) {
      int step = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int r0 = (w / ct) * BM, c0 = (w % ct) * BK;
        for (int k = 0; k < tiles * nk; ++k, ++step) {
          const int stage = step % STAGES;
          mbar_wait(&empty[stage], ((step / STAGES) & 1) ^ 1);
          unsigned char* sp = sm + stage * STAGE;
          mbar_arrive_expect_tx(&full[stage], STAGE);
          tma_load_2d(sp, &qmap, &full[stage], k * RING, r0);
          tma_load_2d(sp + A_TILE, &wmap, &full[stage], k * RING, c0);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = t128 / 32, lane = t128 % 32;
    const int lr = wg * 64 + warp * 16 + lane / 4;   // this thread's rows lr, lr + 8 of a tile
    const int cq = 2 * (lane % 4);                   // and columns 8i + cq, + 1
    int acc[64];
    float facc[64];
    int step = 0;
    // a warp's release of a stage to the producer
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int r0 = (w / ct) * BM, c0 = (w % ct) * BK;
#pragma unroll
      for (int i = 0; i < 64; ++i) facc[i] = 0.f;
      for (int j = 0; j < tiles; ++j) {
        float s[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + lr + 8 * h;
          s[h] = row < M ? sx[static_cast<long long>(row) * tiles + j] : 0.f;
        }
        for (int k = 0; k < nk; ++k, ++step) {
          const int stage = step % STAGES;
          mbar_wait(&full[stage], (step / STAGES) & 1);
          const uint32_t sA = smem_u32(sm + stage * STAGE), sB = sA + A_TILE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_s8_n128(acc, desc_k(sA, BM, wg * 64, kk), desc_k(sB, BK, 0, kk),
                          k > 0 || kk > 0);
          wgmma_commit();
          if (k > 0) {   // the stage before has been read
            wgmma_wait<1>();
            release((step - 1) % STAGES);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release((step - 1) % STAGES);
        // the tile's exact int32 sums into dx: one fused multiply-add each,
        // the Pallas kernel's acc += d·sx
#pragma unroll
        for (int i = 0; i < 64; ++i)
          facc[i] = __fmaf_rn(static_cast<float>(acc[i]), s[(i >> 1) & 1], facc[i]);
      }
      // dx in bf16: pairs of neighbouring columns when K is even (4-byte
      // aligned), else one value at a time
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = r0 + lr + 8 * ((i >> 1) & 1), col = c0 + 8 * (i >> 2) + cq;
        if (row >= M || col >= K) continue;
        bf16* p = dx + static_cast<long long>(row) * K + col;
        if ((K & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(facc[i], facc[i + 1]);
        } else {
          p[0] = __float2bfloat16(facc[i]);
          if (col + 1 < K) p[1] = __float2bfloat16(facc[i + 1]);
        }
      }
    }
  }
}

}  // namespace

// q [M, N] int8 and sx [M, N/1024] f32: the per-(row, 1024-column tile) codes
// and scales of dy [M, N] bf16 folded by sw [N] f32; N a multiple of 1024,
// all row-major, contiguous and 16-byte aligned
KOIFISH_API int koifish_qdgrad_quant(const void* dy, const void* sw, void* q, void* sx, int M,
                                     int N, void* stream) {
  if (M < 1 || N < TN || N % TN != 0) return cudaErrorInvalidValue;
  const long long lines = static_cast<long long>(M) * (N / TN);
  qdgrad_quant_kernel<<<static_cast<unsigned>((lines + QWARPS - 1) / QWARPS), QWARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const float*>(sw), static_cast<int8_t*>(q),
      static_cast<float*>(sx), M, N);
  return cudaGetLastError();
}

// dx [M, K] bf16 = Σ_j (q_j · wq_jᵀ) · sx_j over the 1024-column tiles j of
// q [M, N] int8 (sx [M, N/1024] f32) and wq [K, N] int8; N a multiple of
// 1024, q and wq contiguous and 16-byte aligned
KOIFISH_API int koifish_qdgrad(const void* q, const void* wq, const void* sx, void* dx, int M,
                               int N, int K, void* stream) {
  if (M < 1 || K < 1 || N < TN || N % TN != 0) return cudaErrorInvalidValue;
  CUtensorMap qmap, wmap;
  cudaError_t err = tma_map_2d(&qmap, q, true, N, M, N, RING, BM);
  if (err == cudaSuccess) err = tma_map_2d(&wmap, wq, true, N, K, N, RING, BK);
  if (err != cudaSuccess) return err;
  static cudaError_t attr = set_smem(qdgrad_gemm_kernel, ALLOC);
  if (attr != cudaSuccess) return attr;
  // persistent: one block per SM, at most one per work item
  const long long items = static_cast<long long>((M + BM - 1) / BM) * ((K + BK - 1) / BK);
  const unsigned grid = static_cast<unsigned>(items < sm_count() ? items : sm_count());
  qdgrad_gemm_kernel<<<grid, THREADS, ALLOC, static_cast<cudaStream_t>(stream)>>>(
      qmap, wmap, static_cast<const float*>(sx), static_cast<bf16*>(dx), M, N, K);
  return cudaGetLastError();
}
