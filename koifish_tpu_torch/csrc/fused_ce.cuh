// Fused classifier cross-entropy for Hopper, both flavours: lse / gold, dx
// and dw of CE(x · w) without ever holding the [m, V] logits.
//
// Replaces the Pallas kernels of koifish_tpu/ops/pallas/fused_ce.py:
// _fwd_call (:117, call :126), _dx_call (:209, call :217) and _dw_call (:278,
// call :302), in their bf16 flavour (fused_ce.cu) and their int8 flavour
// (fused_ce_int8.cu, int8=True). Both sources include this header and
// instantiate only their own flavour, so the two build in parallel.
//
// bf16: x [m, E] bf16 row-major; the head w [E, V] bf16 read through its
// strides, [E, V] storage (an untied head) or [V, E] storage (the tied wte
// read in place as wte.T). Logits in f32 from bf16 products.
// int8: xq [m, E] int8 + sx [m] f32 (row scales), wq int8 in [V, E] storage
// (row stride ldw; the wrapper brings an untied head's codes to that order)
// + sw [V] f32. Logits = (xq · wq)_int32 · sx · sw, the two products rounded
// as _tile_logits rounds them. dx multiplies dlogits by bf16(wq · sw); dw
// multiplies the TRUE bf16 x by dlogits (int8 wgrad measured harmful in the
// JAX package).
// Both: tgt [m] int32, lse / wtok [m] f32; dlogits = bf16((exp(logits − lse)
// − onehot) · wtok), the vocab tail masked in-kernel; E a multiple of 64 up
// to 8192 (E is the loop axis of every kernel, never a resident width).
//
// What bounds them on the H100: 2·m·E·V operations a product on the tensor
// cores (989 TFLOP/s bf16, 1,979 TOPS int8): at Qwen3-0.6B's training shape
// (m 8192, E 1024, V 151,936) the forward's bound is 2.6 ms and a backward's
// three products 7.7 ms. Bytes matter only for the backward's dlogits
// chunk (written once, read twice) and the f32 dx carried across chunks.
//
// Design: every kernel is warp-specialised (384 threads: consumer
// warpgroups 0 and 1 issue wgmma on 64 rows each, producer warpgroup 2
// feeds a ring of 128-byte-swizzled stages by TMA, each stage guarded by a
// "full" and an "empty" mbarrier), and no sum uses atomics: every sum has one
// order, so two runs give the same bits.
//
//   logits kernel (forward and dlogits): a GEMM of x [128 rows, E] against
//     256-column vocab tiles of the head, E streamed through the ring in
//     steps of 128 bytes (64 bf16, 128 int8: wgmma m64n256k16 bf16 or
//     m64n256k32 s8, the head K-major from [V, E] storage or MN-major from
//     [E, V]). A consumer's 64 x 256 accumulator (128 registers a thread)
//     never leaves the registers: the forward folds each tile into a running
//     (max, sumexp, gold) per row with quad shuffles, as the flash forward's
//     softmax does; the dlogits form turns it into bf16 dlogits and stores
//     them, through its own rows of a staging tile, into a chunk buffer.
//     Persistent: block b takes work items b, b + grid, ... (a row tile and a
//     run of vocab tiles; row tiles fastest, so the blocks in flight read the
//     same head tiles and the head comes from L2); the ring runs on across
//     items. The forward's vocab splits write (max, sumexp, gold) to a
//     [splits, m, 3] workspace that a second pass merges in split order.
//   GEMM kernel (dx and dw): C [128 x 128 tile] = Σ_k A·B over the chunk
//     buffer: dx_f32 += dlogits_c · W_c (the f32 dx carried across chunks in
//     chunk order, rounded to bf16 by the last) and dW_c = dlogits_cᵀ · x (or
//     xᵀ · dlogits_c for an [E, V] head), written bf16 through the head's
//     storage order. In the int8 flavour the dx GEMM's B operand is
//     bf16(wq · sw): the producer's TMA brings the raw code bytes into the
//     stage and seven producer warps (a second producer warpgroup) dequantize
//     them into the swizzled bf16 tile that wgmma reads, so the head is never
//     dequantized in a pass of its own.
//
// The backward is thus one dlogits launch and one or two GEMM launches per
// vocab chunk (the wrapper's loop): the logits are computed once for dx and
// dw together, and the accumulators are ordinary GEMM tiles.
#pragma once

#include "sm90.cuh"

#include <type_traits>

// internal linkage: both libraries instantiate some of the same kernels
namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 384;            // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int E_STEP = 64, E_MAX = 8192;
constexpr int BM = 128, BV = 256;       // logits tile: rows x vocab columns
constexpr int GT = 128;                 // GEMM tile: GT x GT, K steps of 64
constexpr uint32_t RING_K = 128;        // bytes of E a ring step carries (a swizzled row)

inline bool bad_shape(int m, int E, int V) {
  return m < 1 || V < 1 || E < E_STEP || E % E_STEP != 0 || E > E_MAX;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the float held in an accumulator register (the int8 form keeps its logits
// there as bits)
__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(int v) { return __int_as_float(v); }
__device__ __forceinline__ void put_f(float& d, float v) { d = v; }
__device__ __forceinline__ void put_f(int& d, float v) { d = __float_as_int(v); }

// a warp's release of a ring stage (the empty barriers count 8 warps)
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ---------------------------------------------------------------------------
// logits kernel: forward (lse, gold) and dlogits
// ---------------------------------------------------------------------------

template <bool DLOG>
struct LogitsLayout {
  static constexpr int STAGES = DLOG ? 3 : 4;
  static constexpr uint32_t X_TILE = BM * RING_K, W_TILE = BV * RING_K;
  static constexpr uint32_t STAGE = X_TILE + W_TILE;
  // dlogits: each consumer warpgroup's [64, BV] bf16 rows on their way out
  static constexpr uint32_t OUT = STAGES * STAGE;
  static constexpr uint32_t BAR = OUT + (DLOG ? BM * BV * 2 : 0);   // full[S], empty[S]
  static constexpr uint32_t ALLOC = BAR + 16 * STAGES + 1024;
  static_assert(ALLOC <= 232448, "fused_ce: logits kernel shared memory");
};

// A work item: rows [r0, r0 + BM) against vocab tiles [t0, t1) of the range
// (split `split` of `splits`, `per` tiles each).
struct Item {
  int r0, split, t0, t1;
};

__device__ __forceinline__ Item item_of(int w, int rt, int per, int nt) {
  Item it;
  it.r0 = (w % rt) * BM;
  it.split = w / rt;
  it.t0 = it.split * per;
  it.t1 = min(nt, it.t0 + per);
  return it;
}

// Vocab tiles t of the range start at column v_begin + t·BV; columns past V
// are masked. INT8: x, w are the codes, sx / sw their scales. DLOG: writes
// dlogits of tile t into columns [t·BV, (t + 1)·BV) of the chunk buffer
// (row stride ldd); else (lse, gold), or with splits > 1 each split's
// (max, sumexp, gold) into ws [splits, m, 3].
template <bool INT8, bool VE, bool DLOG>
__global__ void __launch_bounds__(THREADS, 1)
    fce_logits_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const float* __restrict__ sx,
                      const float* __restrict__ sw, const int* __restrict__ tgt,
                      const float* __restrict__ lse_in, const float* __restrict__ wtok,
                      float* __restrict__ lse_out, float* __restrict__ gold_out,
                      float* __restrict__ ws, bf16* __restrict__ dlog, long long ldd, int m,
                      int E, int V, int v_begin, int nt, int splits) {
  using LY = LogitsLayout<DLOG>;
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int S = LY::STAGES;
  constexpr int KE = INT8 ? 128 : 64;   // E values a ring step
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + S;
  const int rt = (m + BM - 1) / BM, per = (nt + splits - 1) / splits;
  const int items = rt * splits, nk = (E + KE - 1) / KE;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg == 2) {   // producer: one thread streams x and head tiles by TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t128 == 0) {
      int step = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it = item_of(w, rt, per, nt);
        for (int t = it.t0; t < it.t1; ++t) {
          const int v0 = v_begin + t * BV;
          for (int k = 0; k < nk; ++k, ++step) {
            const int stage = step % S;
            mbar_wait(&empty[stage], ((step / S) & 1) ^ 1);
            unsigned char* sp = sm + stage * LY::STAGE;
            mbar_arrive_expect_tx(&full[stage], LY::STAGE);
            tma_load_2d(sp, &xmap, &full[stage], k * KE, it.r0);
            if constexpr (VE) {   // [BV v rows, KE e]: K-major
              tma_load_2d(sp + LY::X_TILE, &wmap, &full[stage], k * KE, v0);
            } else {              // [64 e rows, BV v] in 64-column blocks: MN-major
#pragma unroll
              for (int c = 0; c < BV / 64; ++c)
                tma_load_2d(sp + LY::X_TILE + c * 64 * RING_K, &wmap, &full[stage], v0 + 64 * c,
                            k * KE);
            }
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int warp = t128 / 32, lane = t128 % 32;
  const int lr = wg * 64 + warp * 16 + lane / 4;   // this thread's rows lr, lr + 8 of a tile
  const int cq = 2 * (lane % 4);                   // and columns 8j + cq, + 1
  Acc acc[BV / 2];
  int step = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = item_of(w, rt, per, nt);
    // the rows' columns, read once an item
    int tg[2];
    float sxr[2], ls[2], wt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = it.r0 + lr + 8 * r;
      const bool in = row < m;
      tg[r] = in ? tgt[row] : -1;
      sxr[r] = INT8 && in ? sx[row] : 0.f;
      ls[r] = DLOG && in ? lse_in[row] : 0.f;
      wt[r] = DLOG && in ? wtok[row] : 0.f;
    }
    float m_run[2] = {NEG_INF, NEG_INF}, s_run[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
    for (int t = it.t0; t < it.t1; ++t) {
      for (int k = 0; k < nk; ++k, ++step) {
        const int stage = step % S;
        mbar_wait(&full[stage], (step / S) & 1);
        const uint32_t sX = smem_u32(sm + stage * LY::STAGE), sW = sX + LY::X_TILE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = desc_k(sX, BM, wg * 64, kk);
          if constexpr (INT8)
            wgmma_s8_n256(acc, da, desc_k(sW, BV, 0, kk), k > 0 || kk > 0);
          else if constexpr (VE)
            wgmma_ss_n256<0>(acc, da, desc_k(sW, BV, 0, kk), k > 0 || kk > 0);
          else
            wgmma_ss_n256<1>(acc, da, desc_mn(sW, 64, kk), k > 0 || kk > 0);
        }
        wgmma_commit();
        if (k > 0) {   // the step before has finished reading its stage
          wgmma_wait<1>();
          release(&empty[(step - 1) % S], lane);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(&empty[(step - 1) % S], lane);

      // the tile's logits, in place: f32 sums, or int32 sums · sx · sw as
      // _tile_logits rounds them; columns past V masked
      const int v0 = v_begin + t * BV;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BV / 8; ++j) {
        float s2[2] = {0.f, 0.f};
        if constexpr (INT8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = v0 + 8 * j + cq + h;
            s2[h] = col < V ? __ldg(sw + col) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = v0 + 8 * j + cq + (e & 1), r = e >> 1;
          float l;
          if constexpr (INT8)
            l = __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + e]), sxr[r]), s2[e & 1]);
          else
            l = acc[4 * j + e];
          l = col < V ? l : NEG_INF;
          if constexpr (!DLOG) {
            gold[r] = col == tg[r] ? l : gold[r];
            mx[r] = fmaxf(mx[r], l);
          }
          put_f(acc[4 * j + e], l);
        }
      }
      if constexpr (!DLOG) {
        // fold the tile into the running (max, sumexp) of the rows
        float mn[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) mn[r] = fmaxf(m_run[r], quad_max(mx[r]));
#pragma unroll
        for (int i = 0; i < BV / 2; ++i) sum[(i >> 1) & 1] += expf(as_f(acc[i]) - mn[(i >> 1) & 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s_run[r] = s_run[r] * expf(m_run[r] - mn[r]) + quad_sum(sum[r]);
          m_run[r] = mn[r];
        }
      } else {
        // dlogits = bf16((p − onehot)·wtok) into this warpgroup's staging
        // rows (16-byte chunks swizzled by row), then out in 16-byte stores
        unsigned char* ot = sm + LY::OUT + wg * (64 * BV * 2);
        named_bar_sync(2 + wg, 128);   // the previous tile's rows are out
#pragma unroll
        for (int j = 0; j < BV / 8; ++j) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = v0 + 8 * j + cq + (e & 1), r = e >> 1;
            const float p = expf(as_f(acc[4 * j + e]) - ls[r]);
            const float g = (col == tg[r] ? p - 1.f : p) * wt[r];
            d[e] = col < V ? g : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = warp * 16 + lane / 4 + 8 * h;
            *reinterpret_cast<uint32_t*>(ot + rr * (BV * 2) + ((j ^ (rr & 7)) << 4) +
                                         (lane % 4) * 4) = pack_bf16(d[2 * h], d[2 * h + 1]);
          }
        }
        named_bar_sync(2 + wg, 128);
        constexpr int CH = BV / 8;
        for (int idx = t128; idx < 64 * CH; idx += 128) {
          const int r = idx / CH, c = idx % CH, row = it.r0 + wg * 64 + r;
          if (row < m)
            *reinterpret_cast<uint4*>(dlog + static_cast<long long>(row) * ldd + t * BV + c * 8) =
                *reinterpret_cast<const uint4*>(ot + r * (BV * 2) + ((c ^ (r & 7)) << 4));
        }
      }
    }
    if constexpr (!DLOG) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float g = quad_sum(gold[r]);   // one thread of the row holds it, the rest 0
        const int row = it.r0 + lr + 8 * r;
        if (lane % 4 == 0 && row < m) {
          if (splits == 1) {
            lse_out[row] = m_run[r] + logf(fmaxf(s_run[r], 1e-30f));
            gold_out[row] = g;
          } else {
            float* p = ws + (static_cast<long long>(it.split) * m + row) * 3;
            p[0] = m_run[r];
            p[1] = s_run[r];
            p[2] = g;
          }
        }
      }
    }
  }
}

// merge the splits' (max, sumexp, gold) of each row, in split order
__global__ void fce_fwd_merge_kernel(const float* __restrict__ ws, float* __restrict__ lse_out,
                                     float* __restrict__ gold_out, int m, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws[(static_cast<long long>(s) * m + row) * 3]);
  float sum = 0.f, gold = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = ws + (static_cast<long long>(s) * m + row) * 3;
    sum += p[1] * expf(p[0] - mx);
    gold += p[2];
  }
  lse_out[row] = mx + logf(fmaxf(sum, 1e-30f));
  gold_out[row] = gold;
}

// The logits kernel over vocab columns [v_begin, v_begin + vc) in `splits`
// runs of tiles. x [m, E] (codes with INT8); w: [V, E] storage (VE, row
// stride ldw elements) or [E, V] (row stride ldw).
template <bool INT8, bool VE, bool DLOG>
cudaError_t launch_logits(const void* x, const void* w, long long ldw, const float* sx,
                          const float* sw, const void* tgt, const void* lse_in, const void* wtok,
                          void* lse_out, void* gold_out, void* ws, void* dlog, long long ldd,
                          int m, int E, int V, int v_begin, int vc, int splits, cudaStream_t st) {
  using LY = LogitsLayout<DLOG>;
  const int nt = (vc + BV - 1) / BV, rt = (m + BM - 1) / BM;
  if (vc < 1 || v_begin < 0 || v_begin + vc > V || splits < 1 || splits > nt ||
      (splits - 1) * ((nt + splits - 1) / splits) >= nt)
    return cudaErrorInvalidValue;
  if (!DLOG && (splits > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  const int esz = INT8 ? 1 : 2, ke = INT8 ? 128 : 64;
  CUtensorMap xmap, wmap;
  cudaError_t err = tma_map_2d(&xmap, x, INT8, E, m, static_cast<uint64_t>(E) * esz, ke, BM);
  if (err == cudaSuccess)
    err = VE ? tma_map_2d(&wmap, w, INT8, E, V, ldw * esz, ke, BV)
             : tma_map_2d(&wmap, w, INT8, V, E, ldw * esz, 64, 64);
  if (err != cudaSuccess) return err;
  static cudaError_t attr = set_smem(fce_logits_kernel<INT8, VE, DLOG>, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  const long long items = static_cast<long long>(rt) * splits;
  if (items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(items < sm_count() ? items : sm_count());
  float* wsf = static_cast<float*>(ws);
  fce_logits_kernel<INT8, VE, DLOG><<<grid, THREADS, LY::ALLOC, st>>>(
      xmap, wmap, sx, sw, static_cast<const int*>(tgt), static_cast<const float*>(lse_in),
      static_cast<const float*>(wtok), static_cast<float*>(lse_out),
      static_cast<float*>(gold_out), wsf, static_cast<bf16*>(dlog), ldd, m, E, V, v_begin, nt,
      splits);
  if ((err = cudaGetLastError()) != cudaSuccess || DLOG || splits == 1) return err;
  fce_fwd_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(wsf, static_cast<float*>(lse_out),
                                                        static_cast<float*>(gold_out), m, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM kernel: dx and dw from a chunk of dlogits
// ---------------------------------------------------------------------------

template <bool DEQ>
struct GemmLayout {
  static constexpr int STAGES = DEQ ? 4 : 5;
  static constexpr uint32_t A_TILE = GT * RING_K, B_TILE = GT * RING_K;
  static constexpr uint32_t RAW = DEQ ? 64 * RING_K : 0;   // int8 codes [64 v][128 e]
  static constexpr uint32_t STAGE = A_TILE + B_TILE + RAW;
  static constexpr uint32_t OUT = STAGES * STAGE;          // two [64, GT] bf16 staging tiles
  static constexpr uint32_t BAR = OUT + GT * GT * 2;       // full[S], empty[S], raw[S]
  static constexpr uint32_t ALLOC = BAR + 24 * STAGES + 1024;
  static_assert(ALLOC <= 232448, "fused_ce: GEMM kernel shared memory");
};

enum GemmFlags { FIRST = 1, LAST = 2, M_FAST = 4 };

// threads of a GEMM block: two consumer warpgroups and a producer
// warpgroup, and with DEQ a second producer warpgroup, so that 7 warps
// dequantize the codes (3 held the int8 dx GEMM at ~1.8x its bf16 form's
// time on an H100)
template <bool DEQ>
constexpr int GEMM_THREADS = DEQ ? 512 : THREADS;

// 4 int8 codes of a word times s as two packed bf16 pairs, bf16(f32(q)·s):
// byte q + 128 is the low mantissa byte of 2^23 + 128 + q, exact in f32
__device__ __forceinline__ void deq4(uint32_t word, float s, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) - 8388736.f;
  lo = pack_bf16(__fmul_rn(f[0], s), __fmul_rn(f[1], s));
  hi = pack_bf16(__fmul_rn(f[2], s), __fmul_rn(f[3], s));
}

// C [M, N] = Σ_k A[m, k] · B[k, n] over K in steps of 64, one 128 x 128 tile
// a block. A: K-major (a row-major [M, K] view: the dlogits chunk for dx) or
// MN-major (A_MN: a row-major [K, M] view); B: MN-major (B_MN: row-major
// [K, N]) or K-major (row-major [N, K]); B's K rows start at row b_k0 of its
// map. DEQ: B is the int8 codes [V, E] (bmap of bytes) times sw, dequantized
// in the stage. DX: C is dx [M, N] (row stride N): the f32 dx of the earlier
// chunks (dxf) is added unless FIRST, and C goes to dxf unless LAST, else to
// out in bf16. Otherwise C goes to out in bf16 (row stride ldo).
template <bool A_MN, bool B_MN, bool DEQ, bool DX>
__global__ void __launch_bounds__(GEMM_THREADS<DEQ>, 1)
    fce_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap, const float* __restrict__ sw,
                    float* __restrict__ dxf, bf16* __restrict__ out, long long ldo, int M, int N,
                    int K, int b_k0, int V, int flags) {
  using LY = GemmLayout<DEQ>;
  constexpr int S = LY::STAGES;
  constexpr int NDQ = GEMM_THREADS<DEQ> - 256 - 32;   // DEQ: dequantizing threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + S;
  uint64_t* raw = empty + S;
  const int tiles_m = (M + GT - 1) / GT, tiles_n = (N + GT - 1) / GT;
  const int b = blockIdx.x;
  const int m0 = (flags & M_FAST ? b % tiles_m : b / tiles_n) * GT;
  const int n0 = (flags & M_FAST ? b / tiles_m : b % tiles_n) * GT;
  const int nk = (K + 63) / 64;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], DEQ ? NDQ : 1);   // DEQ: the dequantizing threads
      mbar_init(&empty[i], 8);
      mbar_init(&raw[i], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg >= 2) {   // producers: thread 256 issues TMA, warps 9.. dequantize
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      for (int k = 0; k < nk; ++k) {
        const int stage = k % S;
        mbar_wait(&empty[stage], ((k / S) & 1) ^ 1);
        unsigned char* sp = sm + stage * LY::STAGE;
        uint64_t* bar = DEQ ? &raw[stage] : &full[stage];
        mbar_arrive_expect_tx(bar, LY::A_TILE + (DEQ ? LY::RAW : LY::B_TILE));
        if constexpr (A_MN) {
          tma_load_2d(sp, &amap, bar, m0, k * 64);
          tma_load_2d(sp + 64 * RING_K, &amap, bar, m0 + 64, k * 64);
        } else {
          tma_load_2d(sp, &amap, bar, k * 64, m0);
        }
        unsigned char* sb = sp + LY::A_TILE;
        if constexpr (DEQ) {
          tma_load_2d(sb + LY::B_TILE, &bmap, bar, n0, b_k0 + k * 64);
        } else if constexpr (B_MN) {
          tma_load_2d(sb, &bmap, bar, n0, b_k0 + k * 64);
          tma_load_2d(sb + 64 * RING_K, &bmap, bar, n0 + 64, b_k0 + k * 64);
        } else {
          tma_load_2d(sb, &bmap, bar, b_k0 + k * 64, n0);
        }
      }
    } else if (DEQ && pt >= 32) {
      // the stage's codes [64 v][128 e] (swizzled rows of 128 bytes) into
      // the bf16 B tile [64 v][128 e] read MN-major. A thread takes 16-byte
      // chunks d, d + NDQ, ... (DQ of them, the last maybe none); its rows'
      // scales load before the stage lands, and its chunks load together,
      // so one latency covers them.
      constexpr int DQ = (64 * 8 + NDQ - 1) / NDQ;
      const int d = pt - 32;
      for (int k = 0; k < nk; ++k) {
        const int stage = k % S;
        const int v_base = b_k0 + k * 64;
        float s[DQ];
#pragma unroll
        for (int i = 0; i < DQ; ++i) {
          const int v = v_base + (d + NDQ * i) / 8;
          s[i] = d + NDQ * i < 64 * 8 && v < V ? __ldg(sw + v) : 0.f;
        }
        mbar_wait(&raw[stage], (k / S) & 1);
        unsigned char* sb = sm + stage * LY::STAGE + LY::A_TILE;
        uint4 q[DQ];
#pragma unroll
        for (int i = 0; i < DQ; ++i) {
          const int c = d + NDQ * i;
          if (c < 64 * 8)
            q[i] = *reinterpret_cast<const uint4*>(sb + LY::B_TILE + sw128(c / 8, c % 8, 64));
        }
#pragma unroll
        for (int i = 0; i < DQ; ++i) {
          const int c = d + NDQ * i, r = c / 8, c16 = c % 8;
          if (c >= 64 * 8) continue;
          uint4 lo, hi;
          deq4(q[i].x, s[i], lo.x, lo.y);
          deq4(q[i].y, s[i], lo.z, lo.w);
          deq4(q[i].z, s[i], hi.x, hi.y);
          deq4(q[i].w, s[i], hi.z, hi.w);
          *reinterpret_cast<uint4*>(sb + sw128(r, 2 * c16, 64)) = lo;
          *reinterpret_cast<uint4*>(sb + sw128(r, 2 * c16 + 1, 64)) = hi;
        }
        fence_proxy_async();
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  // consumers: this warpgroup's 64 rows of the tile
  const int warp = t128 / 32, lane = t128 % 32;
  float acc[GT / 2];
  for (int k = 0; k < nk; ++k) {
    const int stage = k % S;
    if (DEQ) mbar_wait(&raw[stage], (k / S) & 1);
    mbar_wait(&full[stage], (k / S) & 1);
    const uint32_t sA = smem_u32(sm + stage * LY::STAGE), sB = sA + LY::A_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          A_MN ? desc_mn(sA + wg * 64 * RING_K, 64, kk) : desc_k(sA, GT, wg * 64, kk);
      const uint64_t db = B_MN ? desc_mn(sB, 64, kk) : desc_k(sB, GT, 0, kk);
      wgmma_ss_n128<B_MN ? 1 : 0, A_MN ? 1 : 0>(acc, da, db, k > 0 || kk > 0);
    }
    wgmma_commit();
    if (k > 0) {
      wgmma_wait<1>();
      release(&empty[(k - 1) % S], lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(&empty[(nk - 1) % S], lane);

  // a thread holds rows lr, lr + 8 and columns 8j + cq, + 1 of the tile
  const int lr = wg * 64 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  if constexpr (DX) {
    if (!(flags & FIRST)) {   // dx of the earlier chunks + this chunk's
#pragma unroll
      for (int j = 0; j < GT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + lr + 8 * h, gn = n0 + 8 * j + cq;
          if (gm < M && gn < N) {
            const float2 p =
                *reinterpret_cast<const float2*>(dxf + static_cast<long long>(gm) * N + gn);
            acc[4 * j + 2 * h] = p.x + acc[4 * j + 2 * h];
            acc[4 * j + 2 * h + 1] = p.y + acc[4 * j + 2 * h + 1];
          }
        }
    }
    if (!(flags & LAST)) {
#pragma unroll
      for (int j = 0; j < GT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + lr + 8 * h, gn = n0 + 8 * j + cq;
          if (gm < M && gn < N)
            *reinterpret_cast<float2*>(dxf + static_cast<long long>(gm) * N + gn) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      return;
    }
  }
  // bf16 out through this warpgroup's staging rows (16-byte chunks swizzled
  // by row), then 16-byte stores where a chunk lies whole inside C and
  // aligned, element stores at a ragged edge
  unsigned char* ot = sm + LY::OUT + wg * (64 * GT * 2);
  const int rl = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < GT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = rl + 8 * h;
      *reinterpret_cast<uint32_t*>(ot + rr * (GT * 2) + ((j ^ (rr & 7)) << 4) + (lane % 4) * 4) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  named_bar_sync(2 + wg, 128);
  const bool vec = ldo % 8 == 0;
  constexpr int CH = GT / 8;
  for (int idx = t128; idx < 64 * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH;
    const int gm = m0 + wg * 64 + r, gn = n0 + c * 8;
    if (gm >= M || gn >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ot + r * (GT * 2) + ((c ^ (r & 7)) << 4));
    bf16* dst = out + static_cast<long long>(gm) * ldo + gn;
    if (vec && gn + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int i = 0; i < 8 && gn + i < N; ++i) dst[i] = e[i];
    }
  }
}

template <bool A_MN, bool B_MN, bool DEQ, bool DX>
cudaError_t launch_gemm(const CUtensorMap& amap, const CUtensorMap& bmap, const float* sw,
                        float* dxf, bf16* out, long long ldo, int M, int N, int K, int b_k0,
                        int V, int flags, cudaStream_t st) {
  using LY = GemmLayout<DEQ>;
  static cudaError_t attr = set_smem(fce_gemm_kernel<A_MN, B_MN, DEQ, DX>, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  const int tiles_m = (M + GT - 1) / GT, tiles_n = (N + GT - 1) / GT;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  if (tiles > (1ll << 31) - 1) return cudaErrorInvalidValue;
  // the operand with fewer tiles varies fastest, so the blocks in flight
  // share the other (the streamed dlogits) from L2
  if (tiles_m < tiles_n) flags |= M_FAST;
  fce_gemm_kernel<A_MN, B_MN, DEQ, DX>
      <<<static_cast<unsigned>(tiles), GEMM_THREADS<DEQ>, LY::ALLOC, st>>>(
          amap, bmap, sw, dxf, out, ldo, M, N, K, b_k0, V, flags);
  return cudaGetLastError();
}

// dx (+)= dlogits[:, :vc] · W[c0 : c0 + vc] for a chunk: buf [m, ldb] bf16;
// the head as in launch_logits, or (DEQ) the int8 codes in [V, E] storage
// with sw; dxf [m, E] f32 carries the chunks' sum; the last writes dx bf16.
template <bool VE, bool DEQ>
cudaError_t launch_dx(const void* buf, long long ldb, const void* w, long long ldw,
                      const float* sw, float* dxf, bf16* dx, int m, int E, int V, int c0, int vc,
                      int first, int last, cudaStream_t st) {
  if (vc < 1 || c0 < 0 || c0 + vc > V || ldb < vc || ldb % 8 ||
      ((!first || !last) && dxf == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  cudaError_t err = tma_map_2d(&amap, buf, false, ldb, m, ldb * 2, 64, GT);
  if (err == cudaSuccess) {
    if (DEQ)
      err = tma_map_2d(&bmap, w, true, E, V, ldw, 128, 64);
    else if (VE)   // [V, E] storage: B [k = v][n = e] row-major, MN-major
      err = tma_map_2d(&bmap, w, false, E, V, ldw * 2, 64, 64);
    else           // [E, V] storage: B's rows n = e, K-major
      err = tma_map_2d(&bmap, w, false, V, E, ldw * 2, 64, GT);
  }
  if (err != cudaSuccess) return err;
  const int flags = (first ? FIRST : 0) | (last ? LAST : 0);
  return launch_gemm<false, VE || DEQ, DEQ, true>(amap, bmap, sw, dxf, dx, E, m, E, vc, c0, V,
                                                  flags, st);
}

// dW for the chunk's vocab columns [c0, c0 + vc): Σ over the m rows of x
// (bf16 [m, E]) against buf [m, ldb]; dw through strides (sde, sdv), one of
// them 1: [V, E] storage takes C = dlogitsᵀ·x, [E, V] storage C = xᵀ·dlogits.
inline cudaError_t launch_dw(const void* buf, long long ldb, const void* x, void* dw, int m,
                             int E, int V, int c0, int vc, long long sde, long long sdv,
                             cudaStream_t st) {
  if (vc < 1 || c0 < 0 || c0 + vc > V || ldb < vc || ldb % 8 || (sde != 1 && sdv != 1))
    return cudaErrorInvalidValue;
  CUtensorMap dmap, xmap;
  cudaError_t err = tma_map_2d(&dmap, buf, false, ldb, m, ldb * 2, 64, 64);
  if (err == cudaSuccess)
    err = tma_map_2d(&xmap, x, false, E, m, static_cast<uint64_t>(E) * 2, 64, 64);
  if (err != cudaSuccess) return err;
  bf16* out = static_cast<bf16*>(dw);
  if (sde == 1)
    return launch_gemm<true, true, false, false>(dmap, xmap, nullptr, nullptr,
                                                 out + c0 * sdv, sdv, vc, E, m, 0, V, 0, st);
  return launch_gemm<true, true, false, false>(xmap, dmap, nullptr, nullptr, out + c0 * sdv, sde,
                                               E, vc, m, 0, V, 0, st);
}

}  // namespace
