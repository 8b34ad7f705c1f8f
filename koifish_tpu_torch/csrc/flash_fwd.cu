// Flash attention forward (causal, optional sliding window, GQA) for Hopper.
//
// Replaces the Pallas forward kernels of koifish_tpu/ops/pallas/flash.py:
// _fwd_cols_single/_fwd_cols_single_kernel (:844/:868),
// _flash_cols_fwd_call/_fwd_cols_kernel (:732/:773),
// _flash_fwd_call/_fwd_kernel (:194/:234) and
// _fwd_single/_fwd_single_kernel (:283/:318). The column and head-major
// layouts differ only in strides, so one kernel takes q [B,T,Hq,D] and
// k/v [B,T,Hkv,D] through their strides (unit stride on D); o [B,T,Hq,D]
// bf16 and lse [B,Hq,T] f32 are contiguous.
//
// What bounds it on the H100: at the serving prefill (T = 128, D = 128)
// each q row meets at most 128 keys, ~64 flops per byte of q, k, v and o,
// under the card's ~295 bf16 flops/byte ridge, so bytes bound it. At
// Qwen3-0.6B's training shape (T 1024, D 128) it is ~340 flops per byte,
// just over the ridge (the tensor cores bound it), at GPT2-124M's (D 64)
// ~170, under it; the online softmax (an exp and a few flops per score)
// is the second cost.
//
// D = 64 and 128 (the serving and training paths): a persistent,
// warp-specialised wgmma kernel. A work item is 128 q rows of one q head
// and batch; the kv head is h / (Hq/Hkv), so K/V are never repeated. One
// block of 384 threads per SM takes items x, x + grid, ..., the items with
// the most live kv tiles first, so the last wave is short. The producer
// warpgroup copies each item's q tile into one of two q buffers (the next
// item's loads while the consumers work on this one) and one of its
// threads streams the live K/V tiles (from the window's start to the
// causal diagonal; 64 rows at D 128, 128 at D 64) by TMA, through a
// 3-stage ring of B128-swizzled tiles with "full" and "empty" mbarriers;
// the ring runs on across items, so an item's start and end overlap other
// work. Each consumer warpgroup owns 64 q rows of the item: it scales its
// q rows in place (bf16(q·scale), the Pallas rounding), takes S = qs·Kᵀ
// by wgmma into registers, runs the online softmax in registers (a row's
// max and sum across the 4 threads that hold it, by shuffles; tiles with
// no masked entry of its rows take a path without the mask; O is rescaled
// only when a row max of the warp moved), turns p into bf16 register
// fragments and issues O += P·V with them as the A operand, V read
// MN-major from the same swizzled tile. S, P and the f32 O accumulator
// never touch shared memory. The bf16 output leaves through the
// warpgroup's own rows of the q buffer, in 16-byte stores. (Issuing the
// next tile's S before a tile's P·V, FA3's intra-warpgroup overlap, was
// slower here: the live S, P and O registers made ptxas serialise.)
//
// D = 256 keeps the WMMA kernel (flash_fwd_wmma_kernel below), chosen by
// D at dispatch. At D = 256 a q tile and a K/V stage are 64 KB each, so
// the ring would hold two stages beside one q buffer and no next item's q
// tile, and the f32 O accumulator alone takes 128 of a consumer's 232
// registers; no model the port serves or trains at full size has D = 256
// (Qwen3 has 128, GPT2 64). The WMMA kernel stages S, P and O in shared
// memory, 4 warps a block of 64 q rows.
//
// Rounding follows the Pallas kernels: q scaled in f32 then rounded to
// bf16, masked logits -1e30 (so their p is 0), p = exp(s − m) rounded to
// bf16 before PV, l >= 1e-30, o = O / l. The wgmma kernel keeps the plain
// version's roundings as closely as the card allows: p and the rescale
// are expf of the same differences (not the exp2 of one FMA that the
// backward uses), l is summed with compensation (Kahan in each thread,
// TwoSum across the quad: near the exact sum, as the CPU's pairwise sum
// is), and o is O / l rounded as a division rounds it. The tiny
// card-against-CPU train steps of chip_smoke.py compare gradients that are
// rounding noise (a key bias's is 0 in exact arithmetic), and an o an ulp
// apart moves them by several percent. On an H100 the exp2 form or a
// plain f32 row sum moved the tiny QAT step's check past its 5 %; expf,
// the compensated sum and the rounded division cost ~25 % of the kernel's
// time at Qwen3-0.6B's training shape.
#include "flash_ws.cuh"

#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// D = 64, 128: warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

template <int D>
struct FwdWs {
  // kv tiles of 64 rows at D 128; at D 64 of 128 rows, so that a tile's
  // softmax bookkeeping and waits meet as many flops as at D 128
  static constexpr int BQ = 128, BN = D == 64 ? 128 : 64, STAGES = 3;
  static constexpr uint32_t Q_TILE = BQ * D * 2, KV_TILE = BN * D * 2;
  // two q tiles (scaled in place; then the bf16 output rows): a block's
  // next work item loads into one while the other is in use; then the
  // K/V ring
  static constexpr uint32_t Q = 0, STAGE0 = 2 * Q_TILE;
  static constexpr uint32_t SK = 0, SV = KV_TILE, STAGE = 2 * KV_TILE;
  // full[S], empty[S], qfull[2], qempty[2]
  static constexpr uint32_t BAR = STAGE0 + STAGES * STAGE;
  static constexpr uint32_t ALLOC = BAR + 8 * (2 * STAGES + 4) + 1024;
  static_assert(ALLOC <= 232448 && BN / 2 <= 64, "flash_fwd: shared memory, mask bits");
};

// a / b rounded as the division rounds it, from inv = RN(1/b): the
// product's residual by one FMA and one corrected product (Markstein), a
// handful of instructions where the division takes its slow path
__device__ __forceinline__ float div_rn(float a, float b, float inv) {
  const float q = a * inv;
  return fmaf(fmaf(-q, b, a), inv, q);
}

// the max of a row over the 4 threads of a quad that hold it
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// One work item: the q tile of 128 rows from q0, of q head h and batch b,
// and its live kv tiles [j_lo, j_lo + n). Items are numbered heaviest q
// tiles first (the last q tiles see the most kv tiles).
struct Item {
  int q0, h, b, j_lo, n;
};

template <int BQ, int BN>
__device__ __forceinline__ Item item_of(int w, int T, int Hq, int B, int window) {
  const int nq = (T + BQ - 1) / BQ, per = Hq * B;
  Item it;
  it.q0 = (nq - 1 - w / per) * BQ;
  it.h = (w % per) % Hq;
  it.b = (w % per) / Hq;
  const int j_hi = (min(it.q0 + BQ, T) - 1) / BN;
  it.j_lo = (window > 0 && it.q0 - window + 1 > 0) ? (it.q0 - window + 1) / BN : 0;
  it.n = j_hi - it.j_lo + 1;
  return it;
}

// Persistent: block x takes work items x, x + gridDim.x, ... The producer
// runs ahead across items (the next q tile and its first kv tiles load
// while the consumers finish an item), so a block's start and end overlap
// other work.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_ws_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                        float* __restrict__ lse, int B, int T, int Hq, int Hkv, long long qsb,
                        long long qst, long long qsh, float scale, int window) {
  using LY = FwdWs<D>;
  constexpr int BQ = LY::BQ, BN = LY::BN, S = LY::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;
  uint64_t* qempty = qfull + 2;
  const int items = ((T + BQ - 1) / BQ) * Hq * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 128);
      mbar_init(&qempty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg == 2) {   // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    int step = 0;   // ring steps issued (thread 0)
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const Item it = item_of<BQ, BN>(w, T, Hq, B, window);
      const int qb = k & 1;
      mbar_wait(&qempty[qb], ((k >> 1) & 1) ^ 1);
      copy_rows<D, BQ, 128>(sm + LY::Q + qb * LY::Q_TILE, q + it.b * qsb + it.h * qsh, qst,
                            it.q0, T, t128);
      cp_async_arrive(&qfull[qb]);
      if (t128 == 0) {   // K and V tiles by TMA: 64-column boxes, rows past T zero
        const int hk = it.h / (Hq / Hkv);
        for (int i = 0; i < it.n; ++i, ++step) {
          const int stage = step % S;
          mbar_wait(&empty[stage], ((step / S) & 1) ^ 1);
          unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
          mbar_arrive_expect_tx(&full[stage], 2 * LY::KV_TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sp + LY::SK + c * BN * 128, &kmap, &full[stage], 64 * c, hk,
                        (it.j_lo + i) * BN, it.b);
            tma_load_4d(sp + LY::SV + c * BN * 128, &vmap, &full[stage], 64 * c, hk,
                        (it.j_lo + i) * BN, it.b);
          }
        }
      }
    }
    cp_async_wait_all();
  } else {   // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = t128 / 32, lane = t128 % 32;
    int step = 0;   // ring steps consumed
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const Item it = item_of<BQ, BN>(w, T, Hq, B, window);
      const int qb = k & 1, h = it.h, b = it.b, q0 = it.q0, j_lo = it.j_lo, n = it.n;
      unsigned char* qt = sm + LY::Q + qb * LY::Q_TILE;
      const int wq0 = q0 + wg * 64;                     // this warpgroup's first q row
      const int lr = wg * 64 + warp * 16 + lane / 4;    // this thread's rows lr, lr + 8
      const int qr = q0 + lr;
      mbar_wait(&qfull[qb], (k >> 1) & 1);
      fence_proxy_async();
      // qs = bf16(q·scale) in place, this warpgroup's 64 rows
      scale_tile<D, BQ>(qt, qt, wg * 64, 64, scale, t128, 128);
      fence_proxy_async();
      named_bar_sync(2 + wg, 128);
      const uint32_t sQ = smem_u32(qt);
      const int w_last = min(wq0 + 63, T - 1);
      float oa[D / 2];
      zero(oa);
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};   // rows lr, lr + 8
      for (int i = 0; i < n; ++i, ++step) {
        const int stage = step % S;
        mbar_wait(&full[stage], (step / S) & 1);
        const int k0 = (j_lo + i) * BN;
        const bool live =
            wq0 < T && k0 <= w_last && !(window > 0 && k0 + BN - 1 <= wq0 - window);
        if (live) {
          unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
          float sa[BN / 2];
          // S = qs·Kᵀ for this warpgroup's 64 q rows
          wgmma_fence();
          qk_t<D, BN>(sa, sQ, BQ, wg * 64, smem_u32(sp + LY::SK), BN);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sa);
          // the online softmax of rows lr (entries e < 2) and lr + 8 (e >= 2);
          // a tile with no masked entry of this warpgroup's rows skips the
          // mask. A masked entry's p is 0 outright: while a row has seen
          // only masked keys its max is -1e30, and exp(-1e30 - -1e30) = 1.
          float alpha[2];
          float rs[2] = {0.f, 0.f}, rc[2] = {0.f, 0.f};   // row sums, compensated
          auto softmax = [&](auto masked) {
            uint64_t live_bits = ~0ull;   // bit 4j + e: entry 4j + e is inside the mask
            if constexpr (decltype(masked)::value) {
#pragma unroll
              for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int qpos = qr + (e & 2 ? 8 : 0);
                  const int kpos = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
                  if (!(kpos <= qpos && (window == 0 || kpos > qpos - window))) {
                    sa[4 * j + e] = NEG_INF;
                    live_bits &= ~(1ull << (4 * j + e));
                  }
                }
            }
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sa[4 * j + e]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
              alpha[r] = expf(m_run[r] - m_new);
              m_run[r] = m_new;
            }
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float p = expf(sa[4 * j + e] - m_run[e >> 1]);
                if constexpr (decltype(masked)::value)
                  p = (live_bits >> (4 * j + e)) & 1ull ? p : 0.f;
                sa[4 * j + e] = p;
                const float y = p - rc[e >> 1];   // Kahan: rc holds the lost low part
                const float t = rs[e >> 1] + y;
                rc[e >> 1] = (t - rs[e >> 1]) - y;
                rs[e >> 1] = t;
              }
          };
          if (k0 + BN - 1 <= wq0 && (window == 0 || k0 > wq0 + 63 - window))
            softmax(std::false_type{});
          else
            softmax(std::true_type{});
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // the quad's compensated sums, combined with their corrections
            float hi = rs[r], lo = -rc[r];
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1) {
              const float h2 = __shfl_xor_sync(0xffffffffu, hi, o);
              const float l2 = __shfl_xor_sync(0xffffffffu, lo, o);
              const float sum = hi + h2;   // TwoSum: err is what the add lost
              const float bb = sum - hi;
              const float err = (hi - (sum - bb)) + (h2 - bb);
              hi = sum;
              lo = lo + l2 + err;
            }
            l_run[r] = l_run[r] * alpha[r] + (hi + lo);
          }
          // rescale O only when a row max of the warp moved
          if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) oa[4 * j + e] *= alpha[e >> 1];
          }
          uint32_t pf[BN / 16][4];
          acc_to_frags<BN>(pf, sa);
          // O += bf16(P)·V
          wgmma_fence();
          pv<D, BN / 16>(oa, pf, smem_u32(sp + LY::SV), BN);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(oa);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
      }
      if (wq0 < T) {
        // o = O / max(l, 1e-30) as bf16 into this warpgroup's rows of the q
        // tile (once all four warps are past their last product), then
        // 16-byte rows out; lse = m + log(l)
        named_bar_sync(2 + wg, 128);
        float l[2], inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = fmaxf(l_run[r], 1e-30f);
          inv[r] = __frcp_rn(l[r]);
          const int t = qr + 8 * r;
          if (lane % 4 == 0 && t < T)
            lse[(static_cast<long long>(b) * Hq + h) * T + t] = m_run[r] + logf(l[r]);
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(qt + sw128(lr + 8 * r, j, BQ) + (lane % 4) * 4) =
                pack_bf16(div_rn(oa[4 * j + 2 * r], l[r], inv[r]),
                          div_rn(oa[4 * j + 2 * r + 1], l[r], inv[r]));
        named_bar_sync(2 + wg, 128);
        constexpr int CH = D / 8;
        for (int idx = t128; idx < 64 * CH; idx += 128) {
          const int r = idx / CH, c = idx % CH, t = wq0 + r;
          if (t < T)
            *reinterpret_cast<uint4*>(o + ((static_cast<long long>(b) * T + t) * Hq + h) * D +
                                      c * 8) =
                *reinterpret_cast<const uint4*>(qt + sw128(wg * 64 + r, c, BQ));
        }
      }
      // this warp is done with the q tile: the producer may load the item
      // after next into it
      __syncwarp();
      if (lane == 0) mbar_arrive(&qempty[qb]);
    }
  }
}

// The TMA map of a [B,T,H,D] bf16 view (strides in elements, unit on D):
// boxes of 64 columns x BN rows of one head, in the 128-byte swizzle; rows
// past T read as zero.
template <int BN>
cudaError_t kv_map(CUtensorMap* map, const void* base, int B, int T, int H, int D, long long sb,
                   long long st, long long sh) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, BN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_ws(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                      int T, int Hq, int Hkv, long long qsb, long long qst, long long qsh,
                      long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                      long long vsh, float scale, int window, cudaStream_t stream) {
  using LY = FwdWs<D>;
  static cudaError_t attr = set_smem(flash_fwd_ws_kernel<D>, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  CUtensorMap kmap, vmap;
  cudaError_t mapped = kv_map<LY::BN>(&kmap, k, B, T, Hkv, D, ksb, kst, ksh);
  if (mapped == cudaSuccess) mapped = kv_map<LY::BN>(&vmap, v, B, T, Hkv, D, vsb, vst, vsh);
  if (mapped != cudaSuccess) return mapped;
  const long long items = static_cast<long long>((T + LY::BQ - 1) / LY::BQ) * Hq * B;
  if (items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(items < sm_count() ? items : sm_count());
  flash_fwd_ws_kernel<D><<<grid, WS_THREADS, LY::ALLOC, stream>>>(
      static_cast<const bf16*>(q), kmap, vmap, static_cast<bf16*>(o), static_cast<float*>(lse),
      B, T, Hq, Hkv, qsb, qst, qsh, scale, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D = 256: the WMMA kernel
// ---------------------------------------------------------------------------
// One block of 4 warps per (q tile of 64 rows, q head, batch); K/V tiles of
// 64 rows are staged in shared memory; Q·Kᵀ and P·V run on WMMA 16x16x16
// (bf16 in, f32 accumulate); each warp owns 16 q rows of S, P and the f32
// output accumulator in shared memory, so the online softmax needs only
// warp-level syncs.

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // each warp owns 16 q rows
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;    // bf16 q / k / v rows (padded)
  static constexpr int LDS = BK + 4;   // f32 scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;    // f32 output accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t V = K + sizeof(bf16) * BK * LDQ;
  static constexpr size_t S = V + sizeof(bf16) * BK * LDQ;
  static constexpr size_t P = S + sizeof(float) * BQ * LDS;
  static constexpr size_t O = P + sizeof(bf16) * BQ * LDP;
  static constexpr size_t M = O + sizeof(float) * BQ * LDO;
  static constexpr size_t L = M + sizeof(float) * BQ;
  static constexpr size_t A = L + sizeof(float) * BQ;
  static constexpr size_t BYTES = A + sizeof(float) * BQ;
};

// Copy rows [r0, r0 + 64) of one head of a [B,T,H,D] tensor into a padded
// shared tile; rows past T are zero. 16-byte chunks, neighbouring threads
// on neighbouring addresses.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long st, int r0,
                                          int T) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDQ + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int T, int Hq, int Hkv, long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                     long long vsh, float scale, int window) {
  using LY = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + LY::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + LY::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + LY::V);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + LY::P);
  float* Os = reinterpret_cast<float*>(smem + LY::O);
  float* Ms = reinterpret_cast<float*>(smem + LY::M);
  float* Ls = reinterpret_cast<float*>(smem + LY::L);
  float* As = reinterpret_cast<float*>(smem + LY::A);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;   // this warp's first q row in the tile

  // q tile, scaled in f32 and rounded to bf16
  {
    constexpr int CH = D / 8;
    const bf16* qh = q + b * qsb + h * qsh;
    for (int i = threadIdx.x; i < BQ * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (q0 + r < T) raw = *reinterpret_cast<const uint4*>(qh + (q0 + r) * qst + c);
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      *reinterpret_cast<uint4*>(Qs + r * LY::LDQ + c) = raw;
    }
  }
  // this warp's rows of the running state
  for (int i = lane; i < 16 * D; i += 32) Os[(row0 + i / D) * LY::LDO + i % D] = 0.f;
  if (lane < 16) {
    Ms[row0 + lane] = NEG_INF;
    Ls[row0 + lane] = 0.f;
  }

  const int q_last = min(q0 + BQ, T) - 1;
  const int j_hi = q_last / BK;
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / BK;

  const bf16* kh = k + b * ksb + hk * ksh;
  const bf16* vh = v + b * vsb + hk * vsh;
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // everyone is done with the previous K/V tile
    load_tile<D>(Ks, kh, kst, k0, T);
    load_tile<D>(Vs, vh, vst, k0, T);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + row0 * LY::LDQ + kk * 16, LY::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + n * 16 * LY::LDQ + kk * 16, LY::LDQ);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + row0 * LY::LDS + n * 16, acc[n], LY::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time, two keys per lane
    for (int i = 0; i < 16; ++i) {
      const int r = row0 + i;
      const int qpos = q0 + r;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        bool ok = kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[c] = ok ? Ss[r * LY::LDS + lane + 32 * c] : NEG_INF;
      }
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      Ps[r * LY::LDP + lane] = __float2bfloat16(p0);
      Ps[r * LY::LDP + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Ls[r] = Ls[r] * alpha + psum;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = row0 + i / D;
      Os[r * LY::LDO + i % D] *= As[r];
    }
    __syncwarp();

    // O += P V for this warp's 16 rows x D
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + row0 * LY::LDO + n * 16, LY::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + row0 * LY::LDP + kk * 16, LY::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LY::LDQ + n * 16, LY::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + row0 * LY::LDO + n * 16, acc, LY::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // normalise and write this warp's rows: o [B,T,Hq,D] contiguous, lse [B,Hq,T]
  for (int i = 0; i < 16; ++i) {
    const int r = row0 + i;
    const int t = q0 + r;
    if (t >= T) break;
    const float l = fmaxf(Ls[r], 1e-30f);
    bf16* orow = o + ((static_cast<long long>(b) * T + t) * Hq + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(Os[r * LY::LDO + c] / l);
    if (lane == 0) lse[(static_cast<long long>(b) * Hq + h) * T + t] = Ms[r] + logf(l);
  }
}

template <int D>
cudaError_t launch_wmma(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int T, int Hq, int Hkv, long long qsb, long long qst, long long qsh,
                        long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                        long long vsh, float scale, int window, cudaStream_t stream) {
  static cudaError_t attr = set_smem(flash_fwd_wmma_kernel<D>, Layout<D>::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_fwd_wmma_kernel<D><<<grid, NTHREADS, Layout<D>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh,
      vsb, vst, vsh, scale, window);
  return cudaGetLastError();
}

}  // namespace

KOIFISH_API int koifish_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int B, int T, int Hq, int Hkv, int D, long long qsb,
                                  long long qst, long long qsh, long long ksb, long long kst,
                                  long long ksh, long long vsb, long long vst, long long vsh,
                                  float scale, int window, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_ws<64>(q, k, v, o, lse, B, T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
                           vsh, scale, window, s);
    case 128:
      return launch_ws<128>(q, k, v, o, lse, B, T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh, vsb,
                            vst, vsh, scale, window, s);
    case 256:
      return launch_wmma<256>(q, k, v, o, lse, B, T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh, vsb,
                              vst, vsh, scale, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
