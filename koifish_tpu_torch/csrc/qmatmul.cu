// Dequant-fused GEMV for Hopper (m <= 32): y = Σ_g (x_g @ codes_g) · s_g.
//
// Replaces the Pallas kernels of koifish_tpu/ops/pallas/matmul.py:
// _qmv/_qmv_kernel (:201/:224, the GEMV, m <= 32) and its learned-codebook
// variant _qmv_book/_qmv_book_kernel (:389/:419); the BOOK flag swaps the
// constant decode for a lookup in the tensor's own book. The GEMM shape
// (m > 32: _qmm, _qmm_book) is qmm.cu.
//
// Codes: [K/cpb, N] bytes (INT8: int8 [K, N]) in the group-local
// block-split order of quant/packing.py — within each 128-row group, byte
// row r holds rows r, r + SUB, ... (SUB = 128/cpb, lowest bits first).
// Decoding follows _unpack_block (matmul.py:155-189): signed formats are
// stored biased by 2^(bits-1), TERNARY is raw-1, BINARY is 2·raw-1, NF4/NF3
// come from the same constants, rounded to bf16 (qcodes.cuh). Integer codes
// are exact in bf16. The group scale multiplies each group's f32 partial
// product, never the weights. Learned codebooks (BOOK, NF4/NF3 code layouts
// only): code c of weight row k decodes to bf16(book[k][c]) from an f32
// book of 2^bits entries per row ([K, 2^bits], MINI) or one book for all
// rows ([2^bits], k-means: per_row = 0).
//
// What bounds it on the H100: the decode GEMV (m <= 32) does 2·m flops per
// weight against half a byte of INT4 codes — at most 128 flops per byte,
// under the ~295 bf16 flops/byte ridge, so reading the codes once bounds
// it (Qwen3-0.6B's 7 projections of a layer: 7.9 MB of INT4 codes and 0.5
// MB of scales, ~2.5 µs at 3.35 TB/s); at these sizes the latency of the
// first bytes and of each launch is most of the time. Design:
//   - A block of 4 warps owns 64 output columns and a run of K groups:
//     warp (wn, wk) takes columns 32·wn .. 32·wn + 31 and k steps 4·wk ..
//     4·wk + 3 of each group's eight, so that a block's chain of decodes
//     and products per group is half as long as one warp's (at decode
//     sizes an SM holds one or two blocks; on an H100 2 k warps timed
//     better than 1 or 4). Each warp folds partial · scale of its part of
//     a group into its own accumulator.
//   - Where the column tiles alone cannot fill the card, K is split across
//     the blocks of a thread-block cluster (up to 8, one launch). Each
//     block sums its k warps' accumulators (in order) through its own
//     shared memory, cuts the tile into one slice per block of the cluster
//     and stores each slice into its slot in that slice's owner's shared
//     memory (st.async into distributed shared memory, each store counted
//     in bytes by the owner's mbarrier: no remote loads and no cluster
//     barrier at the end, which timed ~0.3 µs a launch slower on an H100);
//     once its slice has landed each owner sums its slots in rank order
//     and writes bf16 (with f32_out the f32 sum, for a caller that adds
//     other partials before it rounds). No workspace, no second launch, no
//     atomics: the result is the same at every run.
//   - A 4-stage cp.async ring holds each group's raw code bytes, its x
//     columns (m rows, rows past m zero), its scale row and (MINI) its 128
//     book rows; three groups are in flight while one is multiplied, so a
//     block with at most three groups issues every load at once. The
//     k-means book and the NF constants sit in a 16-entry bf16 table.
//   - The product runs transposed, yᵀ = W_gᵀ · x_gᵀ, on mma.sync m16n8k16
//     (bf16 in, f32 accumulate): the weights are the 16-row A operand and x
//     the 8-column B operand, so m = 1 (chat) pads to 8 columns, not 32.
//   - The raw code bytes decode straight into A fragments, with no tile of
//     decoded weights: a thread reads one 4-byte word (4 neighbouring
//     columns) of two neighbouring byte rows r, r + 1, and each code slot
//     j gives one bf16 pair (rows r + SUB·j, r + 1 + SUB·j) of each column.
//     The A rows of the warp's two m16 tiles are mapped to the columns so
//     that thread (g, t) owns columns 4g .. 4g + 3, and the mma's k order
//     to the rows so that each pair is one A register; x is read in the
//     same k order, as 4-byte pairs of neighbouring rows. Integer codes
//     decode two at a time with bf16 magic numbers (0x43nn = 128 + n, then
//     one exact bf16x2 subtraction).
#include "qcodes.cuh"
#include "sm90.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS_N = 2, WARPS_K = 2;     // column warps x k warps
constexpr int NT = 32 * WARPS_N * WARPS_K;  // 128 threads
constexpr int BN = 32 * WARPS_N;            // output columns per block
constexpr int STAGES = 4;
constexpr int MAX_CLUSTER = 8;
constexpr int LDC = BN + 16;                // bytes per staged code row (conflict-free words)
constexpr int LDX = 2 * GROUP + 16;         // bytes per staged x row

template <int FMT, bool BOOK, int MT>
struct GemvLayout {
  using C = Codes<FMT>;
  static constexpr int NB = Book<FMT, BOOK>::NB;
  // a stage: code bytes [SUB][LDC], x [8·MT][LDX], scales [BN] f32,
  // (MINI) book rows [128][NB] f32
  static constexpr uint32_t SC = 0, SX = SC + C::SUB * LDC, SS = SX + 8 * MT * LDX,
                            SB = SS + BN * 4;
  static constexpr uint32_t STAGE = SB + Book<FMT, BOOK>::BYTES;
  static constexpr uint32_t LUT = STAGES * STAGE;   // 16 bf16: NF values or the book
  // the cluster's partial sums for this block's slice of the tile, one
  // slot per block of the cluster: at most [8·MT][BN] f32 and a float4 of
  // rounding per block
  static constexpr uint32_t SLOTS = LUT + 64;
  // the mbarrier that counts the bytes of the slots as they land
  static constexpr uint32_t RBAR = SLOTS + 8 * MT * BN * 4 + MAX_CLUSTER * 16;
  static constexpr uint32_t BYTES = RBAR + 16;
  // the k warps' f32 partial tiles [WARPS_K][8·MT][BN] reuse the ring
  static constexpr uint32_t RED = WARPS_K * 8 * MT * BN * 4;
  static_assert(STAGE % 16 == 0 && RED <= LUT, "qmv: layout");
};

// d += a · b for one m16n8k16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the bf16 table entries r0 (low half) and r1 (high half) as one register
__device__ __forceinline__ uint32_t lut_pair(const bf16* lut, uint32_t r0, uint32_t r1) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lut[r0])) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(lut[r1])) << 16);
}

template <int FMT, bool BOOK, int MT>
__global__ void __launch_bounds__(NT)
    qmv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scales, const float* __restrict__ book, int per_row,
               void* __restrict__ out, int f32_out, int m, int K, int N, int gps) {
  using C = Codes<FMT>;
  using LY = GemvLayout<FMT, BOOK, MT>;
  constexpr int NB = LY::NB, SUB = C::SUB, CPB = C::CPB;
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* lut = reinterpret_cast<bf16*>(sm + LY::LUT);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  // The m x BN tile in float4s is cut into one slice per block of the
  // cluster; this block owns slice `rank` and receives it from every block
  // of the cluster (itself too) into its slots, counted in bytes by rbar.
  const int total = m * (BN / 4), per = (total + nrank - 1) / nrank;
  const int mine = max(0, min(total, (rank + 1) * per) - rank * per);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(sm + LY::RBAR);
  if (nrank > 1) {
    if (threadIdx.x == 0) {
      mbar_init(rbar, 1);
      mbar_fence_init();
      mbar_arrive_expect_tx(rbar, static_cast<uint32_t>(nrank * mine * 16));
    }
    // arrive now, wait before the first store to another block's shared
    // memory: every block of the cluster has started and set up its rbar
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int n0 = blockIdx.y * BN;
  const int g_begin = rank * gps;
  const int n = min(K / GROUP, g_begin + gps) - g_begin;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wn = warp % WARPS_N, wk = warp / WARPS_N;
  const int wc = wn * 32 + 4 * g;   // this thread's 4 columns in the tile
  const bool wide = N % 16 == 0;      // code rows 16-byte aligned

  if (tid < 16) {
    if constexpr (BOOK) {
      if (!per_row && tid < NB) lut[tid] = __float2bfloat16(book[tid]);
    } else if constexpr (FMT == NF4 || FMT == NF3) {
      if (tid < NB) lut[tid] = C::value(tid);
    }
  }

  // one group's code bytes, x columns, scales and book rows into a stage
  auto load = [&](int stage, int gi) {
    unsigned char* sp = sm + stage * LY::STAGE;
    const uint8_t* crow = codes + static_cast<size_t>(gi) * SUB * N + n0;
    if (wide) {
      for (int j = tid; j < SUB * (BN / 16); j += NT) {
        const int r = j / (BN / 16), c = (j % (BN / 16)) * 16;
        const bool in = n0 + c < N;
        cp_async16(sp + LY::SC + r * LDC + c, in ? crow + static_cast<size_t>(r) * N + c : crow,
                   in ? 16 : 0);
      }
    } else {   // N % 4 == 0: 4 columns all in or all out
      for (int j = tid; j < SUB * (BN / 4); j += NT) {
        const int r = j / (BN / 4), c = (j % (BN / 4)) * 4;
        const bool in = n0 + c < N;
        cp_async4(sp + LY::SC + r * LDC + c, in ? crow + static_cast<size_t>(r) * N + c : crow,
                  in ? 4 : 0);
      }
    }
    for (int j = tid; j < 8 * MT * (GROUP / 8); j += NT) {
      const int r = j / (GROUP / 8), c = (j % (GROUP / 8)) * 8;
      const bool in = r < m;
      cp_async16(sp + LY::SX + r * LDX + 2 * c,
                 in ? x + static_cast<size_t>(r) * K + gi * GROUP + c : x, in ? 16 : 0);
    }
    if (tid < BN / 4) {
      const bool in = n0 + 4 * tid < N;
      cp_async16(sp + LY::SS + 16 * tid,
                 in ? scales + static_cast<size_t>(gi) * N + n0 + 4 * tid : scales, in ? 16 : 0);
    }
    if constexpr (BOOK) {
      if (per_row) {   // the group's 128 book rows, [128, NB] contiguous
        const float* src = book + static_cast<size_t>(gi) * GROUP * NB;
        for (int j = tid; j < GROUP * NB / 4; j += NT) cp_async16(sp + LY::SB + 16 * j, src + 4 * j, 16);
      }
    }
  };

  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][mt][e] = 0.f;

  // the bf16 pair of column byte c, code slot j, from the words of byte
  // rows kr and kr + 1 (group-local weight rows kr + SUB·j and + 1)
  auto pair = [&](const unsigned char* sp, uint32_t w0, uint32_t w1, int c, int j,
                  int kr) -> uint32_t {
    constexpr uint32_t mask = (1u << C::BITS) - 1u;
    const uint32_t r0 = (w0 >> (8 * c + C::BITS * j)) & mask;
    const uint32_t r1 = (w1 >> (8 * c + C::BITS * j)) & mask;
    if constexpr (BOOK) {
      if (per_row) {
        const float* bk = reinterpret_cast<const float*>(sp + LY::SB) + (kr + SUB * j) * NB;
        return pack_bf16(bk[r0], bk[NB + r1]);
      }
      return lut_pair(lut, r0, r1);
    } else if constexpr (FMT == NF4 || FMT == NF3) {
      return lut_pair(lut, r0, r1);
    } else if constexpr (FMT == INT8) {
      return pack_bf16(static_cast<float>(static_cast<int8_t>(r0)),
                       static_cast<float>(static_cast<int8_t>(r1)));
    } else {
      // 0x43nn = 128 + n in bf16; minus 128 + bias (BINARY: 2·raw − 1)
      constexpr int sh = FMT == BINARY ? 1 : 0;
      constexpr float off = FMT == INT4      ? 136.f
                            : FMT == INT3    ? 132.f
                            : FMT == INT2    ? 130.f
                                             : 129.f;   // TERNARY, BINARY
      uint32_t v = 0x43004300u | (r0 << sh) | (r1 << (16 + sh));
      __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), __float2bfloat162_rn(off));
      return *reinterpret_cast<uint32_t*>(&d);
    }
  };

  // this warp's part of one group: k16 steps s = 2·wk, 2·wk + 1 of 8;
  // step s takes the pairs 2s (k 2t, 2t + 1 of the mma) and 2s + 1 (k
  // 2t + 8, 2t + 9). Pair q is slot j = q % CPB of the byte rows
  // 8·(q / CPB) + 2t, + 1.
  auto group = [&](int stage) {
    const unsigned char* sp = sm + stage * LY::STAGE;
    const unsigned char* cs = sp + LY::SC + wc;
    const unsigned char* xs = sp + LY::SX + g * LDX;
    float part[2][MT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][mt][e] = 0.f;
#pragma unroll
    for (int ss = 0; ss < 8 / WARPS_K; ++ss) {
      const int s = wk * (8 / WARPS_K) + ss;
      uint32_t a[2][4];
      int kx[2];   // the group-local k of each pair's first row, for x
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * s + h, j = q % CPB, kr = 8 * (q / CPB) + 2 * t;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cs + kr * LDC);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cs + (kr + 1) * LDC);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][2 * h] = pair(sp, w0, w1, 2 * i, j, kr);          // A row g: column 4g + 2i
          a[i][2 * h + 1] = pair(sp, w0, w1, 2 * i + 1, j, kr);  // A row g + 8: 4g + 2i + 1
        }
        kx[h] = kr + SUB * j;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* xr = xs + 8 * mt * LDX;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + 2 * kx[0]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 2 * kx[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(part[i][mt], a[i], b0, b1);
      }
    }
    // the group scale on the partial sums: d0, d1 are column 4g + 2i,
    // d2, d3 column 4g + 2i + 1
    const float* sc = reinterpret_cast<const float*>(sp + LY::SS) + wc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float s0 = sc[2 * i], s1 = sc[2 * i + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[i][mt][0] = fmaf(part[i][mt][0], s0, acc[i][mt][0]);
        acc[i][mt][1] = fmaf(part[i][mt][1], s0, acc[i][mt][1]);
        acc[i][mt][2] = fmaf(part[i][mt][2], s1, acc[i][mt][2]);
        acc[i][mt][3] = fmaf(part[i][mt][3], s1, acc[i][mt][3]);
      }
    }
  };

  // the ring: STAGES - 1 groups ahead; one (possibly empty) commit group a
  // step keeps wait_group's count uniform
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, g_begin + s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // group i has landed; every warp is done with group i - 1
    if (i + STAGES - 1 < n) load((i + STAGES - 1) % STAGES, g_begin + i + STAGES - 1);
    cp_async_commit();
    group(i % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: the partial tile reuses it

  // partial tiles [WARPS_K][8·MT][BN] f32: rows of x, columns of the tile
  float* red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((wk * MT + mt) * 8 + 2 * t + (e & 1)) * BN + wc + 2 * i + (e >> 1)] =
            acc[i][mt][e];
  __syncthreads();
  // the k warps' sum of one float4 of the tile, in order
  auto ksum = [&](int idx) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < WARPS_K; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(red + (k * MT * 8 + r) * BN + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    return sum;
  };
  auto store = [&](int idx, float4 v) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    if (n0 + c >= N) return;
    const size_t at = static_cast<size_t>(r) * N + n0 + c;
    if (f32_out) {   // the sum as it is, for a caller that adds more partials
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
      return;
    }
    __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y), hi2 = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + at) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo2), *reinterpret_cast<uint32_t*>(&hi2));
  };
  if (nrank == 1) {   // no K split
    for (int idx = tid; idx < total; idx += NT) store(idx, ksum(idx));
    return;
  }
  // Each block stores each float4 of its k-warp sum into its rank's slot
  // in the owner's shared memory (st.async: the owner's rbar counts the
  // bytes); each owner then sums its slots in rank order and writes bf16.
  // No block reads another's shared memory, and an owner leaves only once
  // every byte of its slice has landed.
  float4* slots = reinterpret_cast<float4*>(sm + LY::SLOTS);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int idx = tid; idx < total; idx += NT) {
    const float4 v = ksum(idx);
    const int owner = idx / per;
    st_async_in(slots + rank * per + idx - owner * per, rbar, owner, v);
  }
  mbar_wait(rbar, 0);
  for (int idx = rank * per + tid; idx < rank * per + mine; idx += NT) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < nrank; ++q) {
      const float4 v = slots[q * per + idx - rank * per];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store(idx, sum);
  }
}

template <int FMT, bool BOOK, int MT>
cudaError_t launch_mt(const void* x, const void* codes, const void* scales, const void* book,
                      int per_row, void* out, int f32_out, int m, int K, int N, int gps,
                      int splits, cudaStream_t stream) {
  using LY = GemvLayout<FMT, BOOK, MT>;
  auto kernel = qmv_kernel<FMT, BOOK, MT>;
  static cudaError_t attr = set_smem(kernel, LY::BYTES);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + BN - 1) / BN, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = LY::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = splits;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(book), per_row,
      out, f32_out, m, K, N, gps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// m8 tiles of x: ceil(m / 8)
template <int FMT, bool BOOK = false>
cudaError_t launch(const void* x, const void* codes, const void* scales, void* out, int f32_out,
                   int m, int K, int N, int gps, int splits, cudaStream_t stream,
                   const void* book = nullptr, int per_row = 0) {
  switch ((m + 7) / 8) {
    case 1:
      return launch_mt<FMT, BOOK, 1>(x, codes, scales, book, per_row, out, f32_out, m, K, N,
                                     gps, splits, stream);
    case 2:
      return launch_mt<FMT, BOOK, 2>(x, codes, scales, book, per_row, out, f32_out, m, K, N,
                                     gps, splits, stream);
    case 3:
      return launch_mt<FMT, BOOK, 3>(x, codes, scales, book, per_row, out, f32_out, m, K, N,
                                     gps, splits, stream);
    default:
      return launch_mt<FMT, BOOK, 4>(x, codes, scales, book, per_row, out, f32_out, m, K, N,
                                     gps, splits, stream);
  }
}

// the plan's K split: `splits` blocks of a cluster, `gps` groups each, each
// split with at least one group
bool plan_ok(int m, int K, int N, int gps, int splits) {
  const int ng = K / GROUP;
  return m >= 1 && m <= 32 && K >= GROUP && K % GROUP == 0 && N >= 4 && N % 4 == 0 && gps >= 1 &&
         splits >= 1 && splits <= MAX_CLUSTER && (splits - 1) * gps < ng && splits * gps >= ng;
}

}  // namespace

// y [m, N] bf16 (f32 with f32_out) = x [m, K] bf16 (m <= 32) against the
// codes; K is split over `splits` blocks of a cluster (at most 8), `gps`
// groups each.
KOIFISH_API int koifish_qmatmul(const void* x, const void* codes, const void* scales, void* out,
                                int f32_out, int m, int K, int N, int fmt, int gps, int splits,
                                void* stream) {
  if (!plan_ok(m, K, N, gps, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case INT8: return launch<INT8>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case INT4: return launch<INT4>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case NF4: return launch<NF4>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case INT3: return launch<INT3>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case NF3: return launch<NF3>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case INT2: return launch<INT2>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case TERNARY: return launch<TERNARY>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    case BINARY: return launch<BINARY>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// Learned-codebook codes (NF4 or NF3 layouts): book is f32 [K, 2^bits]
// (per_row = 1) or [2^bits] (per_row = 0), contiguous.
KOIFISH_API int koifish_qmatmul_book(const void* x, const void* codes, const void* scales,
                                     const void* book, void* out, int f32_out, int m, int K,
                                     int N, int fmt, int per_row, int gps, int splits,
                                     void* stream) {
  if (!plan_ok(m, K, N, gps, splits) || book == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case NF4:
      return launch<NF4, true>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s, book,
                               per_row);
    case NF3:
      return launch<NF3, true>(x, codes, scales, out, f32_out, m, K, N, gps, splits, s, book,
                               per_row);
    default: return cudaErrorInvalidValue;
  }
}
