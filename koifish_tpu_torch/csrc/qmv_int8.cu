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
// of a layer: 15.7 MB of codes + 0.5 MB of scales, ~4.8 µs at 3.35 TB/s); at
// these sizes the latency of the first bytes and of the launch is most of
// the time. Design (the row-4 GEMV's, qmatmul.cu, carried over to int8):
//   - A block of 8 warps owns 128 output columns and a run of K groups,
//     summed in one chain: warp (wn, wm) takes columns 32·wn .. 32·wn + 31
//     and the m8 tiles wm, wm + 2 of x. Where the column tiles alone cannot fill
//     the card, K is split across the blocks of a thread-block cluster (up
//     to 8, one launch): each block stores each float4 of its partial tile
//     into its rank's slot in the owner's shared memory (st.async, counted
//     in bytes by the owner's mbarrier); each owner sums its slots in rank
//     order and writes bf16. No workspace, no second launch, no atomics: the
//     result is the same at every run, and the splits add in the order of
//     qmv_int8_plain(gps=...).
//   - A 3-stage cp.async ring holds each group's code bytes ([128 rows] x
//     128 bytes, 16-byte chunks swizzled by row), its x columns (m rows of
//     bf16) and its scale row; the first group's x comes in a commit group
//     of its own, so that its quantization overlaps the landing of its
//     codes. Each group's activations are quantized once per block, one
//     group ahead: after the barrier that lands group i + 1,
//     the warps quantize it (the row absmax among a row's threads, codes by
//     q8_code<JIT> of int8.cuh into a double-buffered tile) while they multiply group i, whose codes
//     were made in the step before; the load of group i + 2 is in flight
//     meanwhile. All the rows of a group are quantized at once (8 or
//     16 threads a row, one chunk of 8 values each at a time), so that no
//     warp walks the rows one after another.
//   - The product runs transposed, yᵀ = wqᵀ · q8(x)ᵀ, on int8 mma.sync
//     m16n8k32: the weights are the 16-row A operand and the activations
//     the 8-column B operand, so m = 1 (chat) pads to 8 columns, not 64.
//   - The code bytes go straight into A fragments, with no tile of
//     transposed codes: thread (g, t) of a warp owns columns 4g .. 4g + 3 of
//     the warp's 32 (A row g of m16 tile i is column 4g + 2i, A row g + 8 is
//     4g + 2i + 1) and, in k step s of the group's four, weight rows 32s +
//     4t .. + 3 and 32s + 16 + 4t .. + 3 (the mma's own k order). It reads
//     the 4-byte word (4 columns) of each of those rows and transposes each
//     4 x 4 block of bytes in registers (byte permutes) into the 4
//     registers of one column's 4 rows. The row swizzle of the chunks makes
//     the four t's of a load hit four different bank groups. x's codes are
//     read in the same natural k order.
#include "int8.cuh"
#include "sm90.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GROUP = 128;
constexpr int NT = 256;                // 8 warps: 4 column warps x 2 row warps
constexpr int BN = 128;                // output columns per block
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 8;
constexpr int MMAX = 32;
constexpr int LDQ = GROUP + 16;        // bytes per row of activation codes (conflict-free)

template <int MT>   // m8 tiles of x: ceil(m / 8)
struct Layout {
  // a stage: code bytes [GROUP][BN] (swizzled), x [8·MT][GROUP] bf16, scales [BN] f32
  static constexpr uint32_t SC = 0, SX = SC + GROUP * BN, SS = SX + 8 * MT * GROUP * 2;
  static constexpr uint32_t STAGE = SS + BN * 4;
  // the activation codes [2][8·MT][LDQ] and scales [2][8·MT], one group ahead
  static constexpr uint32_t XQ = STAGES * STAGE, XS = XQ + 2 * 8 * MT * LDQ;
  // the cluster's partial sums of this block's slice of the tile: at most
  // [8·MT][BN] f32 and a float4 of rounding per block of the cluster
  static constexpr uint32_t SLOTS = XS + 2 * 8 * MT * 4;
  // the mbarrier that counts the bytes of the slots as they land
  static constexpr uint32_t RBAR = SLOTS + (8 * MT * BN / 4 + MAX_CLUSTER) * 16;
  static constexpr uint32_t BYTES = RBAR + 16;
  static_assert(STAGE % 16 == 0 && XS % 16 == 0 && SLOTS % 16 == 0, "qmv_int8: layout");
};

// byte offset of 16-byte chunk c of code row r in a stage: the chunk index
// is XORed with 2·((r / 4) % 4), so that rows 4 apart lie in other banks
__device__ __forceinline__ uint32_t code_at(int r, int c) {
  return static_cast<uint32_t>(r * BN + ((c ^ (2 * ((r >> 2) & 3))) << 4));
}

template <int MT>
__global__ void __launch_bounds__(NT, 2)
    qmv_int8_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ scales, bf16* __restrict__ out, int m, int K,
                    int N, int gps) {
  using LY = Layout<MT>;
  extern __shared__ __align__(16) unsigned char sm[];
  int8_t* xq = reinterpret_cast<int8_t*>(sm + LY::XQ);
  float* xs = reinterpret_cast<float*>(sm + LY::XS);

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
  const int wn = warp % 4, wm = warp / 4;   // columns 32·wn .., m8 tiles wm, wm + 2
  const bool wide = N % 16 == 0;   // code rows 16-byte aligned

  // rows m .. 8·MT - 1 of both activation-code tiles stay zero
  for (int i = tid; i < 2 * 8 * MT * (LDQ / 4); i += NT) {
    const int r = (i / (LDQ / 4)) % (8 * MT);
    if (r >= m) reinterpret_cast<uint32_t*>(xq)[i] = 0u;
  }
  if (tid < 2 * 8 * MT) xs[tid] = 0.f;

  // one group's x columns into a stage
  auto load_x = [&](int stage, int gi) {
    unsigned char* sp = sm + stage * LY::STAGE;
    for (int j = tid; j < m * (GROUP / 8); j += NT) {
      const int r = j / (GROUP / 8), c = (j % (GROUP / 8)) * 8;
      cp_async16(sp + LY::SX + (r * GROUP + c) * 2,
                 x + static_cast<size_t>(r) * K + gi * GROUP + c, 16);
    }
  };
  // one group's code bytes and scale row into a stage
  auto load_codes = [&](int stage, int gi) {
    unsigned char* sp = sm + stage * LY::STAGE;
    const int8_t* crow = wq + static_cast<size_t>(gi) * GROUP * N + n0;
    if (wide) {
      for (int j = tid; j < GROUP * (BN / 16); j += NT) {
        const int r = j / (BN / 16), c = j % (BN / 16);
        const bool in = n0 + 16 * c < N;
        cp_async16(sp + LY::SC + code_at(r, c),
                   in ? crow + static_cast<size_t>(r) * N + 16 * c : crow, in ? 16 : 0);
      }
    } else {   // N % 4 == 0: 4 columns all in or all out
      for (int j = tid; j < GROUP * (BN / 4); j += NT) {
        const int r = j / (BN / 4), c4 = j % (BN / 4);
        const bool in = n0 + 4 * c4 < N;
        cp_async4(sp + LY::SC + code_at(r, c4 / 4) + 4 * (c4 % 4),
                  in ? crow + static_cast<size_t>(r) * N + 4 * c4 : crow, in ? 4 : 0);
      }
    }
    if (tid < BN / 4) {
      const bool in = n0 + 4 * tid < N;
      cp_async16(sp + LY::SS + 16 * tid,
                 in ? scales + static_cast<size_t>(gi) * N + n0 + 4 * tid : scales, in ? 16 : 0);
    }
  };

  // the activation codes and scales of the group in `stage` into tile `buf`,
  // every row at once: T neighbouring threads share a row, thread `seg`
  // taking its 8-value chunks seg, seg + T, ... (threads of rows past m
  // only join the absmax shuffles)
  auto quantize = [&](int stage, int buf) {
    constexpr int T = MT <= 2 ? 16 : 8, C = GROUP / 8 / T;
    const int r = tid / T, seg = tid % T;
    const bf16* xr = reinterpret_cast<const bf16*>(sm + stage * LY::STAGE + LY::SX) + r * GROUP;
    float v[C][8];
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < m) u = *reinterpret_cast<const uint4*>(xr + 8 * (seg + T * c));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[c][2 * e] = f.x;
        v[c][2 * e + 1] = f.y;
        a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
#pragma unroll
    for (int o = 1; o < T; o <<= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    const Q8 sc = q8_scale<JIT>(a);
    if (r >= m) return;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* f = v[c];
      *reinterpret_cast<uint2*>(xq + (buf * 8 * MT + r) * LDQ + 8 * (seg + T * c)) = make_uint2(
          pack4(q8_code<JIT>(f[0], sc), q8_code<JIT>(f[1], sc), q8_code<JIT>(f[2], sc),
                q8_code<JIT>(f[3], sc)),
          pack4(q8_code<JIT>(f[4], sc), q8_code<JIT>(f[5], sc), q8_code<JIT>(f[6], sc),
                q8_code<JIT>(f[7], sc)));
    }
    if (seg == 0) xs[buf * 8 * MT + r] = sc.scale;
  };

  // this warp's m8 tiles: wm + 2j, j < MH, those below MT
  constexpr int MH = (MT + 1) / 2;
  float acc[2][MH][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // group i of the block's run: the stage's codes against tile buf's
  // activation codes, the exact int32 sums scaled into acc
  auto multiply = [&](int stage, int buf) {
    const unsigned char* cs = sm + stage * LY::STAGE + LY::SC;
    const int8_t* xb = xq + buf * 8 * MT * LDQ + g * LDQ + 4 * t;
    const int chunk = ((2 * wn + (g >> 2)) ^ (2 * t)) << 4;   // code_at's chunk, row / 4 % 4 = t
    int d[2][MH][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0;
#pragma unroll
    for (int s = 0; s < GROUP / 32; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // rows 32s + 16h + 4t + e, e = 0..3, of this thread's 4 columns
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = *reinterpret_cast<const uint32_t*>(cs + (32 * s + 16 * h + 4 * t + e) * BN +
                                                    chunk + 4 * (g & 3));
        const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
        const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
        a[0][2 * h] = __byte_perm(lo01, lo23, 0x5410);       // column 4g: its 4 rows
        a[0][2 * h + 1] = __byte_perm(lo01, lo23, 0x7632);   // column 4g + 1
        a[1][2 * h] = __byte_perm(hi01, hi23, 0x5410);       // column 4g + 2
        a[1][2 * h + 1] = __byte_perm(hi01, hi23, 0x7632);   // column 4g + 3
      }
#pragma unroll
      for (int j = 0; j < MH; ++j) {
        const int mt = wm + 2 * j;
        if (mt >= MT) continue;
        const uint32_t b0 = lds32(xb + mt * 8 * LDQ + 32 * s);
        const uint32_t b1 = lds32(xb + mt * 8 * LDQ + 32 * s + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(d[i][j], a[i], b0, b1);
      }
    }
    // d[i][j] = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}: D's rows
    // are columns 4g + 2i (g) and 4g + 2i + 1 (g + 8), its columns rows
    // mt·8 + 2t (+ 1) of x
    const float4 sc = *reinterpret_cast<const float4*>(sm + stage * LY::STAGE + LY::SS +
                                                       16 * (8 * wn + g));
    const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int j = 0; j < MH; ++j) {
      const int mt = wm + 2 * j;
      if (mt >= MT) continue;
      const float sx0 = xs[buf * 8 * MT + mt * 8 + 2 * t], sx1 = xs[buf * 8 * MT + mt * 8 + 2 * t + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fmaf_rn(__fmul_rn(static_cast<float>(d[i][j][e]), (e & 1) ? sx1 : sx0),
                                   s4[2 * i + (e >> 1)], acc[i][j][e]);
    }
  };

  // the ring: group 0's x first, in a commit group of its own, so that its
  // quantization overlaps the landing of its codes; then group 0's codes
  // and group 1. Group i + 2 is loaded while group i + 1 is quantized and
  // group i multiplied. One (possibly empty) commit group a step keeps
  // wait_group's count uniform.
  if (n > 0) load_x(0, g_begin);
  cp_async_commit();
  if (n > 0) load_codes(0, g_begin);
  cp_async_commit();
  if (n > 1) {
    load_x(1, g_begin + 1);
    load_codes(1, g_begin + 1);
  }
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();   // group 0's x has landed; the zero rows are written
  if (n > 0) quantize(0, 0);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // groups i and i + 1 have landed and group i's codes
                       // are made; every warp is done with group i - 1
    if (i + STAGES - 1 < n) {
      load_x((i + STAGES - 1) % STAGES, g_begin + i + STAGES - 1);
      load_codes((i + STAGES - 1) % STAGES, g_begin + i + STAGES - 1);
    }
    cp_async_commit();
    if (i + 1 < n) quantize((i + 1) % STAGES, (i + 1) % 2);
    multiply(i % STAGES, i % 2);
  }
  cp_async_wait<0>();

  // this thread's float4s: row mt·8 + 2t + p, columns 4g .. 4g + 3 of the
  // warp's 32, float4 index idx of the m x BN tile
  auto store = [&](int idx, float4 v) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    if (n0 + c >= N) return;
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(out + static_cast<size_t>(r) * N + n0 + c) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  };
  float4* slots = reinterpret_cast<float4*>(sm + LY::SLOTS);
  if (nrank > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < MH; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int r = (wm + 2 * j) * 8 + 2 * t + p;
      if (r >= m) continue;
      const int idx = r * (BN / 4) + 8 * wn + g;
      const float4 v = make_float4(acc[0][j][p], acc[0][j][2 + p], acc[1][j][p], acc[1][j][2 + p]);
      if (nrank == 1) {   // no K split
        store(idx, v);
        continue;
      }
      // into this rank's slot in the owner's shared memory (st.async: the
      // owner's rbar counts the bytes). No block reads another's shared
      // memory, and an owner leaves only once every byte of its slice has
      // landed.
      const int owner = idx / per;
      st_async_in(slots + rank * per + idx - owner * per, rbar, owner, v);
    }
  if (nrank == 1) return;
  mbar_wait(rbar, 0);
  for (int idx = rank * per + tid; idx < rank * per + mine; idx += NT) {
    const int at = idx - rank * per;
    float4 sum = slots[at];
    for (int q = 1; q < nrank; ++q) {
      const float4 v = slots[q * per + at];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store(idx, sum);
  }
}

template <int MT>
cudaError_t launch(const void* x, const void* wq, const void* scales, void* out, int m, int K,
                   int N, int gps, int splits, cudaStream_t stream) {
  using LY = Layout<MT>;
  auto kernel = qmv_int8_kernel<MT>;
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                                       static_cast<const int8_t*>(wq),
                                       static_cast<const float*>(scales),
                                       static_cast<bf16*>(out), m, K, N, gps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// y [m, N] bf16 = the int8 GEMV of x [m, K] bf16 (m <= 32) against wq [K, N]
// int8 with group scales s [K/128, N] f32; K % 128 == 0, N % 4 == 0, all
// row-major, contiguous and 16-byte aligned. K is split over `splits` blocks
// of a cluster (at most 8), `gps` groups each, each with at least one.
KOIFISH_API int koifish_qmv_int8(const void* x, const void* wq, const void* scales, void* out,
                                 int m, int K, int N, int gps, int splits, void* stream) {
  const int ng = K / GROUP;
  if (m < 1 || m > MMAX || K < GROUP || K % GROUP != 0 || N < 4 || N % 4 != 0 || gps < 1 ||
      splits < 1 || splits > MAX_CLUSTER || (splits - 1) * gps >= ng || splits * gps < ng)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((m + 7) / 8) {
    case 1: return launch<1>(x, wq, scales, out, m, K, N, gps, splits, s);
    case 2: return launch<2>(x, wq, scales, out, m, K, N, gps, splits, s);
    case 3: return launch<3>(x, wq, scales, out, m, K, N, gps, splits, s);
    default: return launch<4>(x, wq, scales, out, m, K, N, gps, splits, s);
  }
}
