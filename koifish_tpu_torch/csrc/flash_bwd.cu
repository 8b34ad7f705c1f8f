// Flash attention backward (causal, optional sliding window, GQA) for Hopper.
//
// Replaces the Pallas backward kernels of koifish_tpu/ops/pallas/flash.py:
// _bwd_fused (:375), _bwd_twopass (:495 dK/dV sweep, :534 dQ sweep),
// _bwd_cols_fused (:932) and _bwd_cols_twopass (:1054, :1077). On the TPU
// the four variants exist for layout and tiling only; here they are one
// strided pair: q, o, dO [B,T,Hq,D] and k, v [B,T,Hkv,D] bf16 through their
// strides (unit stride on D), lse [B,Hq,T] f32 from the forward, outputs
// dq [B,T,Hq,D] and dk, dv [B,T,Hkv,D] bf16, contiguous.
//
//   flash_bwd_dkv: one block per (kv tile, kv head, batch). It loops over
//     the g q heads of the group and, for each, over the live q tiles (from
//     the causal diagonal on, inside the window). Each warp owns 16 kv rows
//     and computes the transposed tiles Sᵀ = K·qsᵀ, dPᵀ = V·dOᵀ, then
//     dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·q into f32 accumulators: dk and
//     dv sum over the whole group in f32 and round to bf16 once, as the
//     Pallas kernels do, with no atomics. For D <= 128 the accumulators are
//     register fragments and the next step's q and dO tiles load by
//     cp.async during this one (flash_bwd_dkv_reg_kernel); D = 256 needs
//     twice the registers, so its accumulators stay in shared memory
//     (flash_bwd_dkv_kernel).
//   flash_bwd_dq: one block per (q tile, q head, batch), looping over the
//     live kv tiles: S = qs·Kᵀ, dP = dO·Vᵀ, dQ += bf16(dS)·K, with dQ in
//     registers and the next K/V tiles loading by cp.async.
//
// Both recompute delta = rowsum(f32(dO)·f32(O)) for the q rows they visit,
// as the TPU kernels do, so there is no extra launch or buffer. Rounding
// follows the Pallas kernels: qs = bf16(q·scale); p = exp(s − lse) with
// masked logits giving p = 0; bf16(p) feeds dV; ds = p·(dp − delta)·scale
// rounds to bf16 before dK (against the unscaled q) and dQ.
//
// What bounds them on the H100: at T = 1024, D = 128 the work is about
// 64-128 flops per byte of q, k, v, o, dO moved, under the card's ridge of
// ~295 bf16 flops/byte only at short T; at training lengths the products
// dominate and the card's tensor cores bound them in principle. In this
// design the bound is the recompute of S and P in both kernels (five
// products for dkv+dq where a fused single pass needs four), the round
// trips of S, dP, P and dS through shared memory between WMMA products
// (16x16x16, bf16 in, f32 accumulate), and one 4-warp block per SM; no
// wgmma or TMA yet.
#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Copy rows [r0, r0 + R) of one head of a [B,T,H,D] tensor into a padded
// shared tile (row stride LD); rows past T are zero. Every 16-byte load of
// the tile is started before any store, so their latencies overlap. With
// `scaled` the same rows also go to a second tile, each value multiplied
// by `scale` in f32 and rounded back to bf16.
template <int D, int R, int LD, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long st, int r0,
                                          int T, bf16* scaled = nullptr, float scale = 0.f) {
  constexpr int CH = D / 8;
  constexpr int N = (R * CH + NT - 1) / NT;
  uint4 val[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = (i % CH) * 8;
    val[j] = make_uint4(0, 0, 0, 0);
    if (i < R * CH && r0 + r < T) val[j] = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * NT;
    if (i >= R * CH) break;
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val[j];
    if (scaled != nullptr) {
      bf16* e = reinterpret_cast<bf16*>(&val[j]);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(__bfloat162float(e[k]) * scale);
      *reinterpret_cast<uint4*>(scaled + r * LD + c) = val[j];
    }
  }
}

// delta[r] = Σ_d f32(dO[r, d]) · f32(O[r0 + r, d]) and lse_s[r] = lse[r0 + r]
// for R rows (0 past T), dO from its shared tile (row stride LD), O from
// global memory: each warp takes R / NW rows, each lane D / 32 neighbouring
// values of a row; the O loads of 8 rows are started before their
// reductions.
template <int D, int R, int NW, int LD>
__device__ __forceinline__ void row_stats(float* delta, float* lse_s, const bf16* DOs,
                                          const bf16* O, long long ost, const float* lse, int r0,
                                          int T) {
  constexpr int PER = D / 32, RW = R / NW, RB = RW < 8 ? RW : 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j0 = 0; j0 < RW; j0 += RB) {
    float o[RB][PER];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int t = r0 + warp + (j0 + j) * NW;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        o[j][k] = t < T ? __bfloat162float(O[t * ost + lane * PER + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int r = warp + (j0 + j) * NW;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        acc += __bfloat162float(DOs[r * LD + lane * PER + k]) * o[j][k];
      acc = warp_sum(acc);
      if (lane == 0) {
        delta[r] = acc;
        lse_s[r] = r0 + r < T ? lse[r0 + r] : 0.f;
      }
    }
  }
}

// rows [r0, r0 + R) of one head into a padded shared tile by cp.async (the
// caller commits and waits); rows past T are zero
template <int D, int R, int LD, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, long long st,
                                                int r0, int T) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < T;
    cp_async16(dst + r * LD + c, in ? src + (r0 + r) * st + c : src, in ? 16 : 0);
  }
}

// dst = bf16(f32(src) · scale) over an [R, D] tile (row stride LD)
template <int D, int R, int LD, int NT>
__device__ __forceinline__ void scale_rows(bf16* dst, const bf16* src, float scale) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = *reinterpret_cast<const uint4*>(src + r * LD + c);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(__bfloat162float(e[k]) * scale);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[16 x 16·NC] (f32, row stride LDO) = a[16 x KD] · bᵀ, where b holds NC·16
// rows of KD values (row stride LDB): the "rows times rowsᵀ" product.
template <int KD, int NC>
__device__ __forceinline__ void rows_by_rows_t(float* out, int ldo, const bf16* a, int lda,
                                               const bf16* b, int ldb) {
  FragC acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      FragBc fb;
      wmma::load_matrix_sync(fb, b + n * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], ldo, wmma::mem_row_major);
}

// acc[16 x D] (f32 in shared memory, row stride lda) += a[16 x KR] · b[KR x D]
// (b row-major with row stride ldb).
template <int D, int KR>
__device__ __forceinline__ void accumulate_rows(float* acc, int lda, const bf16* a, int ldp,
                                                const bf16* b, int ldb) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC c;
    wmma::load_matrix_sync(c, acc + n * 16, lda, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      FragA fa;
      FragBr fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ldp);
      wmma::load_matrix_sync(fb, b + kk * 16 * ldb + n * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + n * 16, c, lda, wmma::mem_row_major);
  }
}

// acc[n] (16x16 f32 fragments in registers, n < D/16) += a[16 x KR] · b[KR x D]
// (b row-major with row stride ldb)
template <int D, int KR>
__device__ __forceinline__ void accumulate_regs(FragC (&acc)[D / 16], const bf16* a, int ldp,
                                                const bf16* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, ldp);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// the warp's 16 rows of D/16 register fragments to bf16 rows out + r·ld_row
// (rows at or past `rows` skipped), through a 16x16 f32 scratch tile
template <int D>
__device__ __forceinline__ void write_rows(const FragC (&acc)[D / 16], float* scratch, bf16* out,
                                           long long ld_row, int rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(scratch, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16, c = i % 16;
      if (r < rows) out[r * ld_row + n * 16 + c] = __float2bfloat16(scratch[i]);
    }
    __syncwarp();
  }
}

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, dsb, dst, dsh;
};

// ---------------------------------------------------------------------------
// dK / dV: block = (BK = 16·NW kv rows, kv head, batch); q tiles of BQ rows
// ---------------------------------------------------------------------------

template <int D, int NW, int BQ>
struct DkvLayout {
  static constexpr int BK = 16 * NW;
  static constexpr int LDH = D + 8;   // bf16 rows of k, v, q, qs, dO
  static constexpr int LDA = D + 4;   // f32 dk / dv accumulators
  static constexpr int LDS = BQ + 4;  // f32 Sᵀ, dPᵀ
  static constexpr int LDP = BQ + 8;  // bf16 Pᵀ, dSᵀ
  static constexpr size_t K = 0;
  static constexpr size_t V = K + align128(sizeof(bf16) * BK * LDH);
  static constexpr size_t Q = V + align128(sizeof(bf16) * BK * LDH);
  static constexpr size_t QS = Q + align128(sizeof(bf16) * BQ * LDH);
  static constexpr size_t DO = QS + align128(sizeof(bf16) * BQ * LDH);
  static constexpr size_t DK = DO + align128(sizeof(bf16) * BQ * LDH);
  static constexpr size_t DV = DK + align128(sizeof(float) * BK * LDA);
  static constexpr size_t ST = DV + align128(sizeof(float) * BK * LDA);
  static constexpr size_t DPT = ST + align128(sizeof(float) * BK * LDS);
  static constexpr size_t PT = DPT + align128(sizeof(float) * BK * LDS);
  static constexpr size_t DST = PT + align128(sizeof(bf16) * BK * LDP);
  static constexpr size_t LSE = DST + align128(sizeof(bf16) * BK * LDP);
  static constexpr size_t DELTA = LSE + align128(sizeof(float) * BQ);
  static constexpr size_t BYTES = DELTA + align128(sizeof(float) * BQ);
  static_assert(BYTES <= 232448, "flash_bwd_dkv: shared memory");
};

template <int D, int NW, int BQ>
__global__ void __launch_bounds__(32 * NW)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dO, const float* __restrict__ lse,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq, int Hkv,
                         Strides s, float scale, int window) {
  using LY = DkvLayout<D, NW, BQ>;
  constexpr int BK = LY::BK, NT = 32 * NW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + LY::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + LY::V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + LY::Q);
  bf16* QSs = reinterpret_cast<bf16*>(smem + LY::QS);
  bf16* DOs = reinterpret_cast<bf16*>(smem + LY::DO);
  float* DKa = reinterpret_cast<float*>(smem + LY::DK);
  float* DVa = reinterpret_cast<float*>(smem + LY::DV);
  float* St = reinterpret_cast<float*>(smem + LY::ST);
  float* DPt = reinterpret_cast<float*>(smem + LY::DPT);
  bf16* Pt = reinterpret_cast<bf16*>(smem + LY::PT);
  bf16* DSt = reinterpret_cast<bf16*>(smem + LY::DST);
  float* Ls = reinterpret_cast<float*>(smem + LY::LSE);
  float* Dl = reinterpret_cast<float*>(smem + LY::DELTA);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;   // this warp's kv rows in the tile

  load_rows<D, BK, LY::LDH, NT>(Ks, k + b * s.ksb + hk * s.ksh, s.kst, k0, T);
  load_rows<D, BK, LY::LDH, NT>(Vs, v + b * s.vsb + hk * s.vsh, s.vst, k0, T);
  for (int i = threadIdx.x; i < BK * LY::LDA; i += NT) {
    DKa[i] = 0.f;
    DVa[i] = 0.f;
  }

  // live q tiles: rows q >= k0 (causal) and q < k_last + window
  const int k_last = min(k0 + BK, T) - 1;
  const int i_lo = k0 / BQ;
  int i_hi = (T - 1) / BQ;
  if (window > 0) i_hi = min(i_hi, (k_last + window - 1) / BQ);

  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    const bf16* qh = q + b * s.qsb + h * s.qsh;
    const bf16* oh = o + b * s.osb + h * s.osh;
    const bf16* dh = dO + b * s.dsb + h * s.dsh;
    const float* lh = lse + (static_cast<long long>(b) * Hq + h) * T;
    for (int it = i_lo; it <= i_hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();   // everyone is done with the previous q tile
      load_rows<D, BQ, LY::LDH, NT>(Qs, qh, s.qst, q0, T, QSs, scale);
      load_rows<D, BQ, LY::LDH, NT>(DOs, dh, s.dst, q0, T);
      __syncthreads();
      row_stats<D, BQ, NW, LY::LDH>(Dl, Ls, DOs, oh, s.ost, lh, q0, T);
      __syncthreads();

      // this warp's 16 kv rows: Sᵀ = K·qsᵀ and dPᵀ = V·dOᵀ
      rows_by_rows_t<D, BQ / 16>(St + row0 * LY::LDS, LY::LDS, Ks + row0 * LY::LDH, LY::LDH,
                                 QSs, LY::LDH);
      rows_by_rows_t<D, BQ / 16>(DPt + row0 * LY::LDS, LY::LDS, Vs + row0 * LY::LDH, LY::LDH,
                                 DOs, LY::LDH);
      __syncwarp();
      for (int i = 0; i < 16; ++i) {
        const int r = row0 + i;
        const int kpos = k0 + r;
        for (int c = lane; c < BQ; c += 32) {
          const int qpos = q0 + c;
          bool ok = kpos <= qpos && qpos < T;
          if (window > 0) ok = ok && kpos > qpos - window;
          const float p = ok ? expf(St[r * LY::LDS + c] - Ls[c]) : 0.f;
          const float ds = p * (DPt[r * LY::LDS + c] - Dl[c]) * scale;
          Pt[r * LY::LDP + c] = __float2bfloat16(p);
          DSt[r * LY::LDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      // dV += bf16(Pᵀ)·dO; dK += bf16(dSᵀ)·q
      accumulate_rows<D, BQ>(DVa + row0 * LY::LDA, LY::LDA, Pt + row0 * LY::LDP, LY::LDP, DOs,
                             LY::LDH);
      accumulate_rows<D, BQ>(DKa + row0 * LY::LDA, LY::LDA, DSt + row0 * LY::LDP, LY::LDP, Qs,
                             LY::LDH);
    }
  }
  __syncthreads();
  // dk, dv [B,T,Hkv,D] contiguous: each warp writes its own rows
  for (int i = 0; i < 16; ++i) {
    const int t = k0 + row0 + i;
    if (t >= T) break;
    const long long at = ((static_cast<long long>(b) * T + t) * Hkv + hk) * D;
    for (int c = lane; c < D; c += 32) {
      dk[at + c] = __float2bfloat16(DKa[(row0 + i) * LY::LDA + c]);
      dv[at + c] = __float2bfloat16(DVa[(row0 + i) * LY::LDA + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV for D <= 128: accumulators in registers, q tiles double-buffered
// ---------------------------------------------------------------------------
// The same work as flash_bwd_dkv_kernel with dK and dV held as D/16 16x16
// register fragments a warp (its 16 kv rows): the shared memory they free
// holds a second (q, dO) stage, so the next (q head, q tile) step's tiles
// load by cp.async while this one is computed.

template <int D>
struct DkvRegLayout {
  static constexpr int BK = 64, BQ = 64;
  static constexpr int LDH = D + 8;
  static constexpr int LDS = BQ + 4;
  static constexpr int LDP = BQ + 8;
  static constexpr size_t TILE = align128(sizeof(bf16) * 64 * LDH);
  static constexpr size_t K = 0;
  static constexpr size_t V = K + TILE;
  static constexpr size_t STAGES = V + TILE;        // 2 x (q tile, dO tile)
  static constexpr size_t QS = STAGES + 4 * TILE;
  static constexpr size_t ST = QS + TILE;
  static constexpr size_t DPT = ST + align128(sizeof(float) * BK * LDS);
  static constexpr size_t PT = DPT + align128(sizeof(float) * BK * LDS);
  static constexpr size_t DST = PT + align128(sizeof(bf16) * BK * LDP);
  static constexpr size_t LSE = DST + align128(sizeof(bf16) * BK * LDP);
  static constexpr size_t DELTA = LSE + align128(sizeof(float) * BQ);
  static constexpr size_t BYTES = DELTA + align128(sizeof(float) * BQ);
  static_assert(BYTES <= 232448, "flash_bwd_dkv: shared memory");
};

template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_reg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ o,
                             const bf16* __restrict__ dO, const float* __restrict__ lse,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq,
                             int Hkv, Strides s, float scale, int window) {
  using LY = DkvRegLayout<D>;
  constexpr int BK = LY::BK, BQ = LY::BQ, NT = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + LY::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + LY::V);
  bf16* QSs = reinterpret_cast<bf16*>(smem + LY::QS);
  float* St = reinterpret_cast<float*>(smem + LY::ST);
  float* DPt = reinterpret_cast<float*>(smem + LY::DPT);
  bf16* Pt = reinterpret_cast<bf16*>(smem + LY::PT);
  bf16* DSt = reinterpret_cast<bf16*>(smem + LY::DST);
  float* Ls = reinterpret_cast<float*>(smem + LY::LSE);
  float* Dl = reinterpret_cast<float*>(smem + LY::DELTA);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;   // this warp's kv rows in the tile

  // live q tiles: rows q >= k0 (causal) and q < k_last + window
  const int k_last = min(k0 + BK, T) - 1;
  const int i_lo = k0 / BQ;
  int i_hi = (T - 1) / BQ;
  if (window > 0) i_hi = min(i_hi, (k_last + window - 1) / BQ);
  const int n_it = i_hi - i_lo + 1;
  const int n_steps = g * n_it;   // (q head of the group, q tile)
  auto qtile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + LY::STAGES + (st % 2) * 2 * LY::TILE);
  };
  auto dotile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + LY::STAGES + (st % 2) * 2 * LY::TILE + LY::TILE);
  };
  auto prefetch = [&](int st) {
    if (st < n_steps) {
      const int h = hk * g + st / n_it, q0 = (i_lo + st % n_it) * BQ;
      load_rows_async<D, BQ, LY::LDH, NT>(qtile(st), q + b * s.qsb + h * s.qsh, s.qst, q0, T);
      load_rows_async<D, BQ, LY::LDH, NT>(dotile(st), dO + b * s.dsb + h * s.dsh, s.dst, q0,
                                          T);
    }
    cp_async_commit();
  };

  load_rows_async<D, BK, LY::LDH, NT>(Ks, k + b * s.ksb + hk * s.ksh, s.kst, k0, T);
  load_rows_async<D, BK, LY::LDH, NT>(Vs, v + b * s.vsb + hk * s.vsh, s.vst, k0, T);
  cp_async_commit();
  prefetch(0);

  FragC dka[D / 16], dva[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }
  for (int st = 0; st < n_steps; ++st) {
    const int h = hk * g + st / n_it, q0 = (i_lo + st % n_it) * BQ;
    __syncthreads();   // everyone is done with step st - 1 (its stage, QS, stats)
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();   // step st's q and dO tiles (and K/V) landed
    const bf16* Qs = qtile(st);
    const bf16* DOs = dotile(st);
    scale_rows<D, BQ, LY::LDH, NT>(QSs, Qs, scale);
    row_stats<D, BQ, 4, LY::LDH>(Dl, Ls, DOs, o + b * s.osb + h * s.osh, s.ost,
                                 lse + (static_cast<long long>(b) * Hq + h) * T, q0, T);
    __syncthreads();

    // this warp's 16 kv rows: Sᵀ = K·qsᵀ and dPᵀ = V·dOᵀ
    rows_by_rows_t<D, BQ / 16>(St + row0 * LY::LDS, LY::LDS, Ks + row0 * LY::LDH, LY::LDH, QSs,
                               LY::LDH);
    rows_by_rows_t<D, BQ / 16>(DPt + row0 * LY::LDS, LY::LDS, Vs + row0 * LY::LDH, LY::LDH, DOs,
                               LY::LDH);
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const int r = row0 + i;
      const int kpos = k0 + r;
      for (int c = lane; c < BQ; c += 32) {
        const int qpos = q0 + c;
        bool ok = kpos <= qpos && qpos < T;
        if (window > 0) ok = ok && kpos > qpos - window;
        const float p = ok ? expf(St[r * LY::LDS + c] - Ls[c]) : 0.f;
        const float ds = p * (DPt[r * LY::LDS + c] - Dl[c]) * scale;
        Pt[r * LY::LDP + c] = __float2bfloat16(p);
        DSt[r * LY::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    // dV += bf16(Pᵀ)·dO; dK += bf16(dSᵀ)·q
    accumulate_regs<D, BQ>(dva, Pt + row0 * LY::LDP, LY::LDP, DOs, LY::LDH);
    accumulate_regs<D, BQ>(dka, DSt + row0 * LY::LDP, LY::LDP, Qs, LY::LDH);
  }
  cp_async_wait<0>();
  __syncthreads();
  // dk, dv [B,T,Hkv,D] contiguous: each warp writes its own rows
  float* scratch = St + warp * 256;
  const int rows = min(16, T - (k0 + row0));
  const long long at = ((static_cast<long long>(b) * T + k0 + row0) * Hkv + hk) * D;
  write_rows<D>(dka, scratch, dk + at, static_cast<long long>(Hkv) * D, rows);
  write_rows<D>(dva, scratch, dv + at, static_cast<long long>(Hkv) * D, rows);
}

// ---------------------------------------------------------------------------
// dQ: block = (64 q rows, q head, batch); kv tiles of BK rows
// ---------------------------------------------------------------------------
// dQ lives in registers (D/16 fragments a warp); the K/V tiles of the next
// kv step load by cp.async while this one is computed.

template <int D, int BK>
struct DqLayout {
  static constexpr int BQ = 64;
  static constexpr int LDH = D + 8;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = BK + 8;
  static constexpr size_t KVT = align128(sizeof(bf16) * BK * LDH);
  static constexpr size_t QS = 0;
  static constexpr size_t DO = QS + align128(sizeof(bf16) * BQ * LDH);
  static constexpr size_t KV = DO + align128(sizeof(bf16) * BQ * LDH);   // 2 x (K, V)
  static constexpr size_t S = KV + 4 * KVT;
  static constexpr size_t DP = S + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t DS = DP + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t LSE = DS + align128(sizeof(bf16) * BQ * LDP);
  static constexpr size_t DELTA = LSE + align128(sizeof(float) * BQ);
  static constexpr size_t BYTES = DELTA + align128(sizeof(float) * BQ);
  static_assert(BYTES <= 232448, "flash_bwd_dq: shared memory");
};

template <int D, int BK>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dO, const float* __restrict__ lse,
                        bf16* __restrict__ dq, int T, int Hq, int Hkv, Strides s, float scale,
                        int window) {
  using LY = DqLayout<D, BK>;
  constexpr int BQ = LY::BQ, NT = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* QSs = reinterpret_cast<bf16*>(smem + LY::QS);
  bf16* DOs = reinterpret_cast<bf16*>(smem + LY::DO);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  float* DPs = reinterpret_cast<float*>(smem + LY::DP);
  bf16* DSs = reinterpret_cast<bf16*>(smem + LY::DS);
  float* Ls = reinterpret_cast<float*>(smem + LY::LSE);
  float* Dl = reinterpret_cast<float*>(smem + LY::DELTA);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;   // this warp's q rows in the tile

  const int q_last = min(q0 + BQ, T) - 1;
  const int j_hi = q_last / BK;
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / BK;
  const bf16* kh = k + b * s.ksb + hk * s.ksh;
  const bf16* vh = v + b * s.vsb + hk * s.vsh;
  auto ktile = [&](int j) {
    return reinterpret_cast<bf16*>(smem + LY::KV + ((j - j_lo) % 2) * 2 * LY::KVT);
  };
  auto vtile = [&](int j) {
    return reinterpret_cast<bf16*>(smem + LY::KV + ((j - j_lo) % 2) * 2 * LY::KVT + LY::KVT);
  };
  auto prefetch = [&](int j) {
    if (j <= j_hi) {
      load_rows_async<D, BK, LY::LDH, NT>(ktile(j), kh, s.kst, j * BK, T);
      load_rows_async<D, BK, LY::LDH, NT>(vtile(j), vh, s.vst, j * BK, T);
    }
    cp_async_commit();
  };

  const bf16* qh = q + b * s.qsb + h * s.qsh;
  const bf16* dh = dO + b * s.dsb + h * s.dsh;
  load_rows_async<D, BQ, LY::LDH, NT>(DOs, dh, s.dst, q0, T);
  load_rows_async<D, BQ, LY::LDH, NT>(QSs, qh, s.qst, q0, T);
  cp_async_commit();
  prefetch(j_lo);
  cp_async_wait<1>();
  __syncthreads();
  row_stats<D, BQ, 4, LY::LDH>(Dl, Ls, DOs, o + b * s.osb + h * s.osh, s.ost,
                               lse + (static_cast<long long>(b) * Hq + h) * T, q0, T);
  // q scaled in f32 and rounded to bf16, in place (dq needs no raw copy)
  scale_rows<D, BQ, LY::LDH, NT>(QSs, QSs, scale);

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // everyone is done with K/V tile j - 1 and its stage
    prefetch(j + 1);
    cp_async_wait<1>();
    __syncthreads();   // K/V tile j landed
    const bf16* Ks = ktile(j);
    const bf16* Vs = vtile(j);

    rows_by_rows_t<D, BK / 16>(Ss + row0 * LY::LDS, LY::LDS, QSs + row0 * LY::LDH, LY::LDH, Ks,
                               LY::LDH);
    rows_by_rows_t<D, BK / 16>(DPs + row0 * LY::LDS, LY::LDS, DOs + row0 * LY::LDH, LY::LDH, Vs,
                               LY::LDH);
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const int r = row0 + i;
      const int qpos = q0 + r;
      for (int c = lane; c < BK; c += 32) {
        const int kpos = k0 + c;
        bool ok = kpos <= qpos && qpos < T;
        if (window > 0) ok = ok && kpos > qpos - window;
        const float p = ok ? expf(Ss[r * LY::LDS + c] - Ls[r]) : 0.f;
        DSs[r * LY::LDP + c] = __float2bfloat16(p * (DPs[r * LY::LDS + c] - Dl[r]) * scale);
      }
    }
    __syncwarp();
    accumulate_regs<D, BK>(acc, DSs + row0 * LY::LDP, LY::LDP, Ks, LY::LDH);   // dQ += bf16(dS)·K
  }
  cp_async_wait<0>();
  __syncthreads();
  float* scratch = Ss + warp * 256;
  write_rows<D>(acc, scratch, dq + ((static_cast<long long>(b) * T + q0 + row0) * Hq + h) * D,
                static_cast<long long>(Hq) * D, min(16, T - (q0 + row0)));
}

template <int D, int NW, int BQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dO,
                       const void* lse, void* dk, void* dv, int B, int T, int Hq, int Hkv,
                       const Strides& s, float scale, int window, cudaStream_t stream) {
  using LY = DkvLayout<D, NW, BQ>;
  static cudaError_t attr = set_smem(flash_bwd_dkv_kernel<D, NW, BQ>, LY::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + LY::BK - 1) / LY::BK, Hkv, B);
  flash_bwd_dkv_kernel<D, NW, BQ><<<grid, 32 * NW, LY::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq, Hkv, s, scale, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_reg(const void* q, const void* k, const void* v, const void* o,
                           const void* dO, const void* lse, void* dk, void* dv, int B, int T,
                           int Hq, int Hkv, const Strides& s, float scale, int window,
                           cudaStream_t stream) {
  using LY = DkvRegLayout<D>;
  static cudaError_t attr = set_smem(flash_bwd_dkv_reg_kernel<D>, LY::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + LY::BK - 1) / LY::BK, Hkv, B);
  flash_bwd_dkv_reg_kernel<D><<<grid, 128, LY::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq, Hkv, s, scale, window);
  return cudaGetLastError();
}

template <int D, int BK>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dO,
                      const void* lse, void* dq, int B, int T, int Hq, int Hkv, const Strides& s,
                      float scale, int window, cudaStream_t stream) {
  using LY = DqLayout<D, BK>;
  static cudaError_t attr = set_smem(flash_bwd_dq_kernel<D, BK>, LY::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + LY::BQ - 1) / LY::BQ, Hq, B);
  flash_bwd_dq_kernel<D, BK><<<grid, 128, LY::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), T, Hq, Hkv, s, scale, window);
  return cudaGetLastError();
}

}  // namespace

#define KOIFISH_BWD_ARGS                                                                      \
  int B, int T, int Hq, int Hkv, int D, long long qsb, long long qst, long long qsh,         \
      long long ksb, long long kst, long long ksh, long long vsb, long long vst, long long vsh, \
      long long osb, long long ost, long long osh, long long dsb, long long dst, long long dsh, \
      float scale, int window, void* stream

KOIFISH_API int koifish_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                      const void* dO, const void* lse, void* dk, void* dv,
                                      KOIFISH_BWD_ARGS) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0) return cudaErrorInvalidValue;
  const Strides s{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, dsb, dst, dsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv_reg<64>(q, k, v, o, dO, lse, dk, dv, B, T, Hq, Hkv, s, scale, window, st);
    case 128:
      return launch_dkv_reg<128>(q, k, v, o, dO, lse, dk, dv, B, T, Hq, Hkv, s, scale, window,
                                 st);
    case 256:
      return launch_dkv<256, 2, 32>(q, k, v, o, dO, lse, dk, dv, B, T, Hq, Hkv, s, scale, window,
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}

KOIFISH_API int koifish_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dO, const void* lse, void* dq,
                                     KOIFISH_BWD_ARGS) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0) return cudaErrorInvalidValue;
  const Strides s{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, dsb, dst, dsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64, 64>(q, k, v, o, dO, lse, dq, B, T, Hq, Hkv, s, scale, window, st);
    case 128:
      return launch_dq<128, 64>(q, k, v, o, dO, lse, dq, B, T, Hq, Hkv, s, scale, window, st);
    case 256:
      return launch_dq<256, 32>(q, k, v, o, dO, lse, dq, B, T, Hq, Hkv, s, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}
