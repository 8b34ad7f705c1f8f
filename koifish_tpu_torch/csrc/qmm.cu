// Dequant-fused GEMM for Hopper (m > 32): y = Σ_g (x_g @ codes_g) · s_g.
//
// Replaces the Pallas kernels _qmm/_qmm_kernel (koifish_tpu/ops/pallas/
// matmul.py:305/:328) and their learned-codebook variant _qmm_book/
// _qmm_book_kernel (:451/:480); the GEMV shape (m <= 32) stays in
// qmatmul.cu. Codes, formats and books are those of qmatmul.cu
// (qcodes.cuh): code values are rounded to bf16, each 128-row group gives
// one f32 partial product and acc += partial · scale — the weights are
// never scaled.
//
// What bounds it on the H100: at m = 4096 (the batched prefill) the
// products are ~600 flops per byte of x, codes and output, above the card's ~295
// bf16 flops/byte ridge, so the tensor cores bound it; the decode of the
// codes into bf16 and the re-read of each x tile by every N tile (from L2)
// come next. Design: a persistent block per SM walks 128 x 128 output
// tiles (N tiles fastest, so blocks in flight share x tiles in L2) with
// three warpgroups. The producer warpgroup streams, per 128-row group, the
// x tile (bf16 [128, 128], by TMA in the 128-byte swizzle: two 64-column
// boxes, rows past m zero), the group's code bytes, its scale row and
// (MINI books) its 128 book rows (cp.async) through a ring of 3 stages,
// each guarded by a "full" mbarrier (the TMA bytes and the 128 cp.async
// arrivals) and an "empty" one (the 8 consumer warps). The two consumer
// warpgroups (64 rows each) decode a stage's codes into a bf16 B tile in
// shared memory, in the 128-byte swizzle that wgmma reads MN-major, then
// issue the group's eight k16 wgmma steps (m64n128k16, A = the x tile
// K-major) into a partial fragment in registers. While those run
// asynchronously the consumers decode the next group into the other of two
// B tiles; then they wait, and fold partial · scale into the accumulator.
// The ring runs on across tiles, so a tile's epilogue overlaps the next
// one's loads. A 128 x 256 tile would need 128 f32 partial and 128
// accumulator registers a thread, more than a consumer has, so N tiles are
// 128 wide. INT4/INT3 codes decode two at a time with bf16 magic numbers;
// NF codes and per-tensor books through a 16-entry bf16 table in shared
// memory. When the output tiles alone cannot fill the card (small m, the
// batcher's bucketed prefills) K is split across work items into an f32
// workspace that splitk_reduce sums in a fixed order. The TMA map of x is
// encoded on the host at each call (cuTensorMapEncodeTiled, looked up in
// libcuda at first use).
#include "qcodes.cuh"
#include "sm90.cuh"


namespace {

constexpr int BM = 128, BN = 128, STAGES = 3;
constexpr int THREADS = 384;   // consumer warpgroups 0, 1; producer warpgroup 2

constexpr uint32_t align1024(uint32_t x) { return (x + 1023u) / 1024u * 1024u; }

template <int FMT, bool BOOK>
struct QmmLayout {
  using C = Codes<FMT>;
  static constexpr int NB = Book<FMT, BOOK>::NB;
  static constexpr uint32_t X_TILE = BM * GROUP * 2;   // x tile, K-major
  static constexpr uint32_t W_TILE = GROUP * BN * 2;   // decoded codes, MN-major
  // a stage: x tile, code bytes [SUB][BN], scales [BN], book rows [128][NB]
  static constexpr uint32_t SX = 0, SC = X_TILE, SS = SC + C::SUB * BN, SB = SS + BN * 4;
  static constexpr uint32_t STAGE = align1024(SB + Book<FMT, BOOK>::BYTES);
  static constexpr uint32_t W = 0, STAGE0 = 2 * W_TILE;
  static constexpr uint32_t LUT = STAGE0 + STAGES * STAGE;   // 16 bf16: NF values or the book
  static constexpr uint32_t BAR = LUT + 64;                  // full[S], empty[S]
  static constexpr uint32_t ALLOC = BAR + 8 * 2 * STAGES + 1024;
  static_assert(ALLOC <= 232448, "qmm: shared memory");
};

// One tile of work: output tile (n0, m0) over groups [g0, g0 + n).
struct Work {
  int n0, m0, split, g0, n;
};

__device__ __forceinline__ Work work_item(int w, int tiles_n, int tiles_m, int ng, int gps) {
  Work r;
  r.n0 = (w % tiles_n) * BN;
  r.m0 = ((w / tiles_n) % tiles_m) * BM;
  r.split = w / (tiles_n * tiles_m);
  r.g0 = r.split * gps;
  r.n = min(ng, r.g0 + gps) - r.g0;
  return r;
}

// Persistent: block b takes work items b, b + gridDim.x, ... (N tiles
// fastest, so the blocks in flight share x tiles in L2); the ring and its
// phases run on across items, so one item's epilogue overlaps the next
// one's loads.
template <int FMT, bool BOOK>
__global__ void __launch_bounds__(THREADS, 1)
    qmm_ws_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, const float* __restrict__ book, int per_row,
                  bf16* __restrict__ out, float* __restrict__ partial, int m, int K, int N,
                  int gps) {
  using LY = QmmLayout<FMT, BOOK>;
  using C = Codes<FMT>;
  constexpr int NB = LY::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + STAGES;

  const int ng = K / GROUP;
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (m + BM - 1) / BM;
  const int total = tiles_n * tiles_m * ((ng + gps - 1) / gps);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 129);   // 128 cp.async arrivals and the TMA's expect_tx
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    const int t = threadIdx.x - 256;
    const bool wide = N % 16 == 0;   // code rows 16-byte aligned
    int it = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const Work wk = work_item(w, tiles_n, tiles_m, ng, gps);
      for (int i = 0; i < wk.n; ++i, ++it) {
        const int stage = it % STAGES, gi = wk.g0 + i;
        mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
        unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
        if (t == 0) {   // x tile by TMA: two 64-column boxes, rows past m zero
          mbar_arrive_expect_tx(&full[stage], LY::X_TILE);
          tma_load_2d(sp + LY::SX, &xmap, &full[stage], gi * GROUP, wk.m0);
          tma_load_2d(sp + LY::SX + BM * 128, &xmap, &full[stage], gi * GROUP + 64, wk.m0);
        }
        const uint8_t* crow = codes + static_cast<size_t>(gi) * C::SUB * N + wk.n0;
        if (wide) {
          for (int j = t; j < C::SUB * (BN / 16); j += 128) {
            const int r = j / (BN / 16), c = (j % (BN / 16)) * 16;
            const bool in = wk.n0 + c < N;
            cp_async16(sp + LY::SC + r * BN + c,
                       in ? crow + static_cast<size_t>(r) * N + c : crow, in ? 16 : 0);
          }
        } else {
          for (int j = t; j < C::SUB * (BN / 4); j += 128) {
            const int r = j / (BN / 4), c = (j % (BN / 4)) * 4;
            const bool in = wk.n0 + c < N;
            cp_async4(sp + LY::SC + r * BN + c,
                      in ? crow + static_cast<size_t>(r) * N + c : crow, in ? 4 : 0);
          }
        }
        if (t < BN / 4) {   // scales, N % 4 == 0: 4 columns all in or all out
          const bool in = wk.n0 + 4 * t < N;
          const float* src = scales + static_cast<size_t>(gi) * N + wk.n0 + 4 * t;
          cp_async16(sp + LY::SS + 16 * t, in ? src : scales, in ? 16 : 0);
        }
        if constexpr (BOOK) {
          if (per_row) {   // the group's 128 book rows, [128, NB] contiguous
            const float* src = book + static_cast<size_t>(gi) * GROUP * NB;
            for (int j = t; j < GROUP * NB / 4; j += 128)
              cp_async16(sp + LY::SB + 16 * j, src + 4 * j, 16);
          }
        }
        cp_async_arrive(&full[stage]);
      }
    }
    cp_async_wait_all();
  } else {   // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
    bf16* lut = reinterpret_cast<bf16*>(sm + LY::LUT);
    if (tid < 16) {
      if constexpr (BOOK) {
        if (!per_row && tid < NB) lut[tid] = __float2bfloat16(book[tid]);
      } else if constexpr (FMT == NF4 || FMT == NF3) {
        if (tid < NB) lut[tid] = C::value(tid);
      }
    }
    named_bar_sync(1, 256);

    // decode the codes of a stage into B tile `w` (bf16 [128 k][BN n],
    // MN-major swizzled): byte row r, code slot j -> weight row j·SUB + r;
    // a thread takes 8 columns of a byte row at a time
    auto decode = [&](int stage, int w) {
      const unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
      const float* brow = reinterpret_cast<const float*>(sp + LY::SB);
      unsigned char* wt = sm + LY::W + w * LY::W_TILE;
      for (int it = tid; it < C::SUB * (BN / 8); it += 256) {
        const int r = it / (BN / 8), c8 = it % (BN / 8);
        const uint2 word = *reinterpret_cast<const uint2*>(sp + LY::SC + r * BN + c8 * 8);
        if constexpr (FMT == INT4 || FMT == INT3) {
          // nibble n as the bf16 bits 0x43nn = 128 + n, then one exact
          // bf16x2 subtraction of 128 + bias: two values an instruction
          const __nv_bfloat162 off = __float2bfloat162_rn(FMT == INT4 ? 136.f : 132.f);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t lo = (word.x >> (4 * j)) & 0x0F0F0F0Fu;
            const uint32_t hi = (word.y >> (4 * j)) & 0x0F0F0F0Fu;
            uint32_t v[4] = {__byte_perm(lo, 0x43434343u, 0x4140),
                             __byte_perm(lo, 0x43434343u, 0x4342),
                             __byte_perm(hi, 0x43434343u, 0x4140),
                             __byte_perm(hi, 0x43434343u, 0x4342)};
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              __nv_bfloat162 t = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v[b]), off);
              v[b] = *reinterpret_cast<uint32_t*>(&t);
            }
            *reinterpret_cast<uint4*>(wt + sw128(j * C::SUB + r, c8, GROUP)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < C::CPB; ++j) {
            const int kr = j * C::SUB + r;
            constexpr uint32_t mask = (1u << C::BITS) - 1u;
            uint32_t v[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              uint32_t h[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int byte = 2 * b + e;
                const uint32_t raw =
                    ((byte < 4 ? word.x >> (8 * byte) : word.y >> (8 * (byte - 4))) >>
                     (C::BITS * j)) & mask;
                bf16 val;
                if constexpr (BOOK)
                  val = per_row ? __float2bfloat16(brow[kr * NB + raw]) : lut[raw];
                else if constexpr (FMT == NF4 || FMT == NF3)
                  val = lut[raw];
                else
                  val = C::value(raw);
                h[e] = __bfloat16_as_ushort(val);
              }
              v[b] = h[0] | (h[1] << 16);
            }
            *reinterpret_cast<uint4*>(wt + sw128(kr, c8, GROUP)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    };

    // bf16 output with rows of whole 16-byte chunks: the epilogue goes
    // through shared memory; else (an f32 K-split partial, N % 8 != 0)
    // straight from the registers
    const bool staged = partial == nullptr && N % 8 == 0;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int w = blockIdx.x, i = 0, it = 0;
    Work wk = work_item(w, tiles_n, tiles_m, ng, gps);
    if (w < total) {
      mbar_wait(&full[0], 0);
      decode(0, 0);
      fence_proxy_async();
      named_bar_sync(1, 256);
    }
    while (w < total) {
      const int stage = it % STAGES;
      const unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
      const uint32_t sX = smem_u32(sp + LY::SX);
      const uint32_t sW = smem_u32(sm + LY::W + (it & 1) * LY::W_TILE);
      // partial = x_g · codes_g for this warpgroup's 64 rows (asynchronous)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GROUP / 16; ++kk)
        wgmma_ss_n128<1>(part, desc_k(sX, BM, wg * 64, kk), desc_mn(sW, GROUP, kk), kk > 0);
      wgmma_commit();
      const bool last = i + 1 == wk.n;
      const bool more = !last || w + static_cast<int>(gridDim.x) < total;
      if (more) {   // decode the next group (of this item or the next) meanwhile
        const int next = (it + 1) % STAGES;
        mbar_wait(&full[next], ((it + 1) / STAGES) & 1);
        decode(next, (it + 1) & 1);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_regs(part);
      // acc += partial · scale; a thread holds columns 8j + 2·(lane%4), +1
      const float* ss = reinterpret_cast<const float*>(sp + LY::SS);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(ss + j * 8 + (lane % 4) * 2);
        acc[4 * j + 0] += part[4 * j + 0] * sc.x;
        acc[4 * j + 1] += part[4 * j + 1] * sc.y;
        acc[4 * j + 2] += part[4 * j + 2] * sc.x;
        acc[4 * j + 3] += part[4 * j + 3] * sc.y;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (last) {   // rows lane/4 and lane/4 + 8 of this warp's 16, two columns an n8 tile
        const int lr0 = wg * 64 + warp * 16 + lane / 4;
        if (staged) {
          // through B tile it & 1 (free once both warpgroups' products are
          // done): bf16 rows of 128 columns, 16-byte chunks swizzled by row,
          // then out in coalesced 16-byte stores
          named_bar_sync(1, 256);
          unsigned char* ot = sm + LY::W + (it & 1) * LY::W_TILE;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = lr0 + 8 * h;
              *reinterpret_cast<__nv_bfloat162*>(ot + r * 256 + ((j ^ (r & 7)) << 4) +
                                                 (lane % 4) * 4) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          named_bar_sync(1, 256);
          for (int q = tid; q < BM * (BN / 8); q += 256) {
            const int r = q / (BN / 8), c = q % (BN / 8);
            if (wk.m0 + r < m && wk.n0 + c * 8 < N)
              *reinterpret_cast<uint4*>(out + static_cast<size_t>(wk.m0 + r) * N + wk.n0 + c * 8) =
                  *reinterpret_cast<const uint4*>(ot + r * 256 + ((c ^ (r & 7)) << 4));
          }
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int gn = wk.n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int gm = wk.m0 + lr0 + 8 * h;
              if (gn < N && gm < m) {
                const size_t at = static_cast<size_t>(gm) * N + gn;
                if (partial != nullptr)
                  *reinterpret_cast<float2*>(partial + static_cast<size_t>(wk.split) * m * N +
                                             at) =
                      make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
                else
                  *reinterpret_cast<__nv_bfloat162*>(out + at) =
                      __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
        w += gridDim.x;
        i = 0;
        wk = work_item(w, tiles_n, tiles_m, ng, gps);
      } else {
        ++i;
      }
      ++it;
      named_bar_sync(1, 256);   // B tile it & 1 is free, tile (it + 1) & 1 is decoded
    }
  }
}

// Sum the K-split partials in split order and round to bf16 (with f32_out,
// keep the f32 sum).
__global__ void splitk_reduce(const float* __restrict__ partial, void* __restrict__ out,
                              int f32_out, int splits, size_t mn) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * mn + i];
  if (f32_out)
    static_cast<float*>(out)[i] = s;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16(s);
}

// The TMA map of x [m, K] bf16: boxes of 64 columns x BM rows in the
// 128-byte swizzle; rows past m read as zero.
cudaError_t x_map(CUtensorMap* map, const void* x, int m, int K) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {64, BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int FMT, bool BOOK = false>
cudaError_t launch(const void* x, const void* codes, const void* scales, void* out, void* work,
                   int f32_out, int m, int K, int N, int gps, cudaStream_t stream,
                   const void* book = nullptr, int per_row = 0) {
  using LY = QmmLayout<FMT, BOOK>;
  static cudaError_t attr = set_smem(qmm_ws_kernel<FMT, BOOK>, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  const int ng = K / GROUP;
  const int splits = (ng + gps - 1) / gps;
  const long long total =
      static_cast<long long>((N + BN - 1) / BN) * ((m + BM - 1) / BM) * splits;
  // an f32 result without a K split is the one split's partial, written
  // by the kernel straight into out
  float* partial = splits > 1 ? static_cast<float*>(work)
                   : f32_out  ? static_cast<float*>(out)
                              : nullptr;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(total < sm_count() ? total : sm_count());
  CUtensorMap xmap;
  const cudaError_t mapped = x_map(&xmap, x, m, K);
  if (mapped != cudaSuccess) return mapped;
  qmm_ws_kernel<FMT, BOOK><<<grid, THREADS, LY::ALLOC, stream>>>(
      xmap, static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(book), per_row,
      static_cast<bf16*>(out), partial, m, K, N, gps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = static_cast<size_t>(m) * N;
  splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(partial, out,
                                                                              f32_out, splits, mn);
  return cudaGetLastError();
}

}  // namespace

// x [m, K] bf16, codes [K/cpb, N], scales f32 [K/128, N], out [m, N] bf16
// (f32 with f32_out); work f32 [splits, m, N] when gps < K/128
KOIFISH_API int koifish_qmm(const void* x, const void* codes, const void* scales, void* out,
                            void* work, int f32_out, int m, int K, int N, int fmt, int gps,
                            void* stream) {
  if (m < 1 || K % GROUP != 0 || N % 4 != 0 || gps < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case INT8: return launch<INT8>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case INT4: return launch<INT4>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case NF4: return launch<NF4>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case INT3: return launch<INT3>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case NF3: return launch<NF3>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case INT2: return launch<INT2>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case TERNARY: return launch<TERNARY>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    case BINARY: return launch<BINARY>(x, codes, scales, out, work, f32_out, m, K, N, gps, s);
    default: return cudaErrorInvalidValue;
  }
}

// Learned-codebook codes (NF4 or NF3 layouts): book is f32 [K, 2^bits]
// (per_row = 1) or [2^bits] (per_row = 0), contiguous.
KOIFISH_API int koifish_qmm_book(const void* x, const void* codes, const void* scales,
                                 const void* book, void* out, void* work, int f32_out, int m,
                                 int K, int N, int fmt, int per_row, int gps, void* stream) {
  if (m < 1 || K % GROUP != 0 || N % 4 != 0 || gps < 1 || book == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case NF4:
      return launch<NF4, true>(x, codes, scales, out, work, f32_out, m, K, N, gps, s, book,
                               per_row);
    case NF3:
      return launch<NF3, true>(x, codes, scales, out, work, f32_out, m, K, N, gps, s, book,
                               per_row);
    default: return cudaErrorInvalidValue;
  }
}
