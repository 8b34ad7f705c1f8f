// Flash attention backward (causal, optional sliding window, GQA) for Hopper.
//
// Replaces the Pallas backward kernels of koifish_tpu/ops/pallas/flash.py:
// _bwd_fused (:375), _bwd_twopass (:495 dK/dV sweep, :534 dQ sweep),
// _bwd_cols_fused (:932) and _bwd_cols_twopass (:1054, :1077). On the TPU
// the four variants exist for layout and tiling only; here they are one
// strided pair: q, o, dO [B,T,Hq,D] and k, v [B,T,Hkv,D] bf16 through their
// strides (unit stride on D), lse [B,Hq,T] f32 from the forward, outputs
// dq [B,T,Hq,D] and dk, dv [B,T,Hkv,D] bf16, contiguous. No atomics: dk and
// dv sum over the GQA group in f32 inside one block and round once.
//
// Rounding follows the Pallas kernels: qs = bf16(q·scale); p = exp(s − lse)
// with masked entries giving p = 0; bf16(p) feeds dV; delta =
// rowsum(f32(dO)·f32(O)); ds = p·(dp − delta)·scale rounds to bf16 before
// dK (against the unscaled q) and dQ.
//
// What bounds them on the H100: at T = 1024, D = 128 the seven products
// (S and dP in both kernels, dV, dK, dQ) are ~600 flops per byte of q, k,
// v, o, dO read and dq, dk, dv written, above the card's ~295 bf16
// flops/byte ridge: the tensor cores bound them in principle, and p, ds (an
// exp and a handful of flops per score, twice) are the second cost.
//
// D = 64 and 128 (the training paths): warp-specialised wgmma kernels.
//   flash_bwd_delta: delta for every row, once, into an f32 [B,Hq,T]
//     buffer (launched by the dkv entry, or the dq entry when it is not
//     given one): the Pallas kernels recompute it per q tile, which here
//     would read O again for every kv tile.
//   flash_bwd_dkv: one block per (128 kv rows, kv head, batch); consumer
//     warpgroup w owns kv rows 64w..64w+63. The producer warpgroup streams
//     each step's (q head of the group, live q tile of 64 rows from the
//     causal diagonal, inside the window) q, dO, lse and delta by cp.async
//     through 3 stages, and writes qs = bf16(q·scale) beside q once its own
//     copies landed. The consumers compute Sᵀ = K·qsᵀ and dPᵀ = V·dOᵀ by
//     wgmma into registers, turn Pᵀ and dSᵀ into bf16 register fragments,
//     and issue dV += Pᵀ·dO and dK += dSᵀ·q with those fragments as the A
//     operand (dO and q read MN-major from the same swizzled tiles): S, P,
//     dP and dS never touch shared memory, and dK, dV stay in registers.
//     At D = 128 the q tile is taken in four parts of 16 columns, so that
//     S, dP and their fragments fit beside the 128 accumulator registers.
//   flash_bwd_dq: one block per (128 q rows, q head, batch); the live kv
//     tiles of 64 rows stream through 2 stages; S = qs·Kᵀ and dP = dO·Vᵀ by
//     wgmma, dS as the register A operand of dQ += dS·K.
//   Tiles with no masked entry skip the mask arithmetic; dead tiles (above
//   the diagonal, outside the window) are skipped; the blocks with the most
//   live tiles are launched first (the grid's slowest index), so the last
//   wave is short.
//
// D = 256 keeps the WMMA kernels (flash_bwd_dkv_kernel, flash_bwd_dq_kernel
// below): a warpgroup's dK and dV accumulators for 64 rows of D = 256 are
// 256 registers a thread, more than a thread has. They recompute delta per
// q tile and stage S, dP, P and dS through shared memory.
#include "flash_ws.cuh"

#include <mma.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// D = 64, 128: warp-specialised wgmma kernels
// ---------------------------------------------------------------------------
// Each block has three warpgroups: 0 and 1 consume (wgmma, 64 rows each),
// 2 produces (its 128 threads stream tiles by cp.async into a ring of
// STAGES buffers in B128-swizzled shared memory; each buffer has a "full"
// mbarrier that the copies complete and an "empty" one that the 8 consumer
// warps release). The producer gives its registers to the consumers
// (setmaxnreg), which hold S, dP and the accumulators in registers.

// delta[b, h, t] = Σ_d f32(dO)·f32(O), one warp a row, rows in [B,Hq,T] order
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                           float* __restrict__ delta, int T, int Hq, long long rows, Strides s) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int t = static_cast<int>(row % T);
  const long long bh = row / T;
  const int h = static_cast<int>(bh % Hq), b = static_cast<int>(bh / Hq);
  constexpr int PER = D / 32;   // 2 or 4 values a lane
  const bf16* orow = o + b * s.osb + t * s.ost + h * s.osh + lane * PER;
  const bf16* drow = dO + b * s.dsb + t * s.dst + h * s.dsh + lane * PER;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) acc += __bfloat162float(drow[k]) * __bfloat162float(orow[k]);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// p = exp(s − lse) (as 2^(s·log2 e − lse·log2 e)) on live entries, else 0;
// ds = p·(dp − delta)·scale — written back over s and dp. lse2 = lse·log2 e.
__device__ __forceinline__ void p_and_ds(float& s, float& dp, bool ok, float lse2, float dl,
                                         float scale) {
  const float p = ok ? exp2f(fmaf(s, LOG2E, -lse2)) : 0.f;
  dp = p * (dp - dl) * scale;
  s = p;
}

// n floats from[r0 ...] (zero past T) by 4-byte copies, thread i0 of NT
template <int N, int NT>
__device__ __forceinline__ void copy_floats(unsigned char* dst, const float* src, int r0, int T,
                                            int i0) {
  for (int i = i0; i < N; i += NT) {
    const bool in = r0 + i < T;
    cp_async4(dst + 4 * i, in ? src + r0 + i : src, in ? 4 : 0);
  }
}

// rows (lane/4, +8) of this warp's 16 of a 64 x D accumulator -> bf16 rows
// of a [.., D] output with row stride ld (rows at or past `rows` skipped)
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, long long ld, const float (&d)[D / 2],
                                          int rows) {
  const int lane = threadIdx.x % 32;
  const int r = lane / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (r + 8 * h) * ld + c) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

template <int D>
struct DkvWs {
  static constexpr int BK = 128, BQ = 64, STAGES = 3;
  static constexpr uint32_t KV_TILE = BK * D * 2, Q_TILE = BQ * D * 2;
  static constexpr uint32_t K = 0, V = KV_TILE, STAGE0 = 2 * KV_TILE;
  // a stage: q, qs (scaled by the producer), dO, lse, delta
  static constexpr uint32_t SQ = 0, SQS = Q_TILE, SDO = 2 * Q_TILE, SLSE = 3 * Q_TILE,
                            SDELTA = SLSE + BQ * 4;
  static constexpr uint32_t STAGE = align1024(SDELTA + BQ * 4);
  static constexpr uint32_t BAR = STAGE0 + STAGES * STAGE;   // full[S], empty[S], kv
  static constexpr uint32_t ALLOC = BAR + 8 * (2 * STAGES + 1) + 1024;
  static_assert(ALLOC <= 232448, "flash_bwd_dkv: shared memory");
};

// dK / dV: block = (128 kv rows, kv head, batch), consumer warpgroup w owns
// kv rows 64w..64w+63. Steps: (q head of the group, live q tile of 64 rows).
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dkv_ws_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dO,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq, int Hkv,
                            Strides s, float scale, int window) {
  using LY = DkvWs<D>;
  constexpr int BK = LY::BK, BQ = LY::BQ, S = LY::STAGES, HQ = D == 128 ? 16 : BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + S;
  uint64_t* kvfull = empty + S;

  // grid (kv head, batch, kv tile): the first kv tiles, which see the most
  // q tiles, are launched first
  const int k0 = blockIdx.z * BK, hk = blockIdx.x, b = blockIdx.y, g = Hq / Hkv;
  const int k_last = min(k0 + BK, T) - 1;
  const int i_lo = k0 / BQ;
  int i_hi = (T - 1) / BQ;
  if (window > 0) i_hi = min(i_hi, (k_last + window - 1) / BQ);
  const int n_it = i_hi - i_lo + 1;
  const int n_steps = g * n_it;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&empty[i], 8);
    }
    mbar_init(kvfull, 128);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg == 2) {   // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    copy_rows<D, BK, 128>(sm + LY::K, k + b * s.ksb + hk * s.ksh, s.kst, k0, T, t128);
    copy_rows<D, BK, 128>(sm + LY::V, v + b * s.vsb + hk * s.vsh, s.vst, k0, T, t128);
    cp_async_arrive(kvfull);
    for (int st = 0; st < n_steps; ++st) {
      const int stage = st % S;
      mbar_wait(&empty[stage], ((st / S) & 1) ^ 1);
      const int h = hk * g + st / n_it, q0 = (i_lo + st % n_it) * BQ;
      unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
      copy_rows<D, BQ, 128>(sp + LY::SQ, q + b * s.qsb + h * s.qsh, s.qst, q0, T, t128);
      copy_rows<D, BQ, 128>(sp + LY::SDO, dO + b * s.dsb + h * s.dsh, s.dst, q0, T, t128);
      const long long bh = (static_cast<long long>(b) * Hq + h) * T;
      copy_floats<BQ, 128>(sp + LY::SLSE, lse + bh, q0, T, t128);
      copy_floats<BQ, 128>(sp + LY::SDELTA, delta + bh, q0, T, t128);
      // qs = bf16(q·scale) from the chunks this thread copied, once they
      // landed; then a plain arrive (the barrier counts the 128 producers)
      cp_async_wait_all();
      scale_tile<D, BQ>(sp + LY::SQS, sp + LY::SQ, 0, BQ, scale, t128, 128);
      fence_proxy_async();
      mbar_arrive(&full[stage]);
    }
  } else {   // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = t128 / 32, lane = t128 % 32;
    const uint32_t sK = smem_u32(sm + LY::K), sV = smem_u32(sm + LY::V);
    const int kw0 = k0 + wg * 64;                     // this warpgroup's first kv row
    const int kr = kw0 + warp * 16 + lane / 4;        // this thread's rows kr, kr + 8
    float dka[D / 2], dva[D / 2];
    zero(dka);
    zero(dva);
    mbar_wait(kvfull, 0);
    fence_proxy_async();
    for (int st = 0; st < n_steps; ++st) {
      const int stage = st % S;
      mbar_wait(&full[stage], (st / S) & 1);
      fence_proxy_async();
      const int q0 = (i_lo + st % n_it) * BQ;
      unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
      const bool live = kw0 < T && kw0 <= q0 + BQ - 1 &&
                        !(window > 0 && kw0 + 63 <= q0 - window);
      if (live) {
        const uint32_t sQ = smem_u32(sp + LY::SQ), sQS = smem_u32(sp + LY::SQS),
                       sDO = smem_u32(sp + LY::SDO);
        const float* Ls = reinterpret_cast<const float*>(sp + LY::SLSE);
        const float* Dl = reinterpret_cast<const float*>(sp + LY::SDELTA);
        // the q tile in column parts of HQ (D = 128: four parts of 16, so
        // that S, dP and their fragments fit beside the dK, dV accumulators)
#pragma unroll 1
        for (int c0 = 0; c0 < BQ; c0 += HQ) {
          float sa[HQ / 2], dpa[HQ / 2];
          zero(sa);
          zero(dpa);
          // Sᵀ = K·qsᵀ and dPᵀ = V·dOᵀ for this warpgroup's 64 kv rows
          wgmma_fence();
          qk_t<D, HQ>(sa, sK, BK, wg * 64, sQS, BQ, c0);
          qk_t<D, HQ>(dpa, sV, BK, wg * 64, sDO, BQ, c0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sa);
          fence_regs(dpa);
          // no entry of this part is masked: every kv row <= every q row,
          // all q rows < T, all inside the window
          const int qa = q0 + c0;
          const bool inner = kw0 + 63 <= qa && qa + HQ <= T &&
                             (window == 0 || kw0 > qa + HQ - 1 - window);
          auto elementwise = [&](auto masked) {
#pragma unroll
            for (int j = 0; j < HQ / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = c0 + j * 8 + (lane % 4) * 2 + (e & 1);
                bool ok = true;
                if constexpr (decltype(masked)::value) {
                  const int kpos = kr + (e & 2 ? 8 : 0), qpos = q0 + c;
                  ok = kpos <= qpos && qpos < T && (window == 0 || kpos > qpos - window);
                }
                p_and_ds(sa[4 * j + e], dpa[4 * j + e], ok, Ls[c] * LOG2E, Dl[c], scale);
              }
          };
          if (inner)
            elementwise(std::false_type{});
          else
            elementwise(std::true_type{});
          uint32_t pf[HQ / 16][4], df[HQ / 16][4];
          acc_to_frags<HQ>(pf, sa);
          acc_to_frags<HQ>(df, dpa);
          // dV += bf16(Pᵀ)·dO; dK += bf16(dSᵀ)·q over this part's q rows
          wgmma_fence();
          pv<D, HQ / 16>(dva, pf, sDO, BQ, c0);
          pv<D, HQ / 16>(dka, df, sQ, BQ, c0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    // dk, dv [B,T,Hkv,D] contiguous
    const int r0 = kw0 + warp * 16;
    const long long ld = static_cast<long long>(Hkv) * D;
    const long long at = ((static_cast<long long>(b) * T + r0) * Hkv + hk) * D;
    store_acc<D>(dk + at, ld, dka, T - r0);
    store_acc<D>(dv + at, ld, dva, T - r0);
  }
}

template <int D>
struct DqWs {
  static constexpr int BQ = 128, BN = 64, STAGES = 2;
  static constexpr uint32_t Q_TILE = BQ * D * 2, KV_TILE = BN * D * 2;
  // q (scaled in place to qs), dO, lse, delta; then the K/V ring
  static constexpr uint32_t Q = 0, DO = Q_TILE, LSE = 2 * Q_TILE, DELTA = LSE + BQ * 4;
  static constexpr uint32_t STAGE0 = align1024(DELTA + BQ * 4);
  static constexpr uint32_t SK = 0, SV = KV_TILE, STAGE = 2 * KV_TILE;
  static constexpr uint32_t BAR = STAGE0 + STAGES * STAGE;   // full[S], empty[S], q
  static constexpr uint32_t ALLOC = BAR + 8 * (2 * STAGES + 1) + 1024;
  static_assert(ALLOC <= 232448, "flash_bwd_dq: shared memory");
};

// dQ: block = (128 q rows, q head, batch), consumer warpgroup w owns q rows
// 64w..64w+63; the live kv tiles of 64 rows stream through the ring.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dq_ws_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dO,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, int T, int Hq, int Hkv, Strides s, float scale,
                           int window) {
  using LY = DqWs<D>;
  constexpr int BQ = LY::BQ, BN = LY::BN, S = LY::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;

  // grid (q head, batch, q tile): the last q tiles, which see the most kv
  // tiles, are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + BQ, T) - 1;
  const int j_hi = q_last / BN;
  const int j_lo = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BN : 0;
  const int n = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&empty[i], 8);
    }
    mbar_init(qfull, 128);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg == 2) {   // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    copy_rows<D, BQ, 128>(sm + LY::Q, q + b * s.qsb + h * s.qsh, s.qst, q0, T, t128);
    copy_rows<D, BQ, 128>(sm + LY::DO, dO + b * s.dsb + h * s.dsh, s.dst, q0, T, t128);
    const long long bh = (static_cast<long long>(b) * Hq + h) * T;
    copy_floats<BQ, 128>(sm + LY::LSE, lse + bh, q0, T, t128);
    copy_floats<BQ, 128>(sm + LY::DELTA, delta + bh, q0, T, t128);
    cp_async_arrive(qfull);
    const bf16* kh = k + b * s.ksb + hk * s.ksh;
    const bf16* vh = v + b * s.vsb + hk * s.vsh;
    for (int i = 0; i < n; ++i) {
      const int stage = i % S;
      mbar_wait(&empty[stage], ((i / S) & 1) ^ 1);
      unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
      copy_rows<D, BN, 128>(sp + LY::SK, kh, s.kst, (j_lo + i) * BN, T, t128);
      copy_rows<D, BN, 128>(sp + LY::SV, vh, s.vst, (j_lo + i) * BN, T, t128);
      cp_async_arrive(&full[stage]);
    }
    cp_async_wait_all();
  } else {   // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = t128 / 32, lane = t128 % 32;
    const int wq0 = q0 + wg * 64;                     // this warpgroup's first q row
    const int lr = wg * 64 + warp * 16 + lane / 4;    // this thread's rows lr, lr + 8 in the tile
    const int qr = q0 + lr;
    mbar_wait(qfull, 0);
    fence_proxy_async();
    // qs = bf16(q·scale) in place, this warpgroup's 64 rows
    scale_tile<D, BQ>(sm + LY::Q, sm + LY::Q, wg * 64, 64, scale, t128, 128);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    const float* Ls = reinterpret_cast<const float*>(sm + LY::LSE);
    const float* Dl = reinterpret_cast<const float*>(sm + LY::DELTA);
    const float l0 = Ls[lr] * LOG2E, l1 = Ls[lr + 8] * LOG2E, d0 = Dl[lr], d1 = Dl[lr + 8];
    const uint32_t sQ = smem_u32(sm + LY::Q), sDO = smem_u32(sm + LY::DO);
    const int w_last = min(wq0 + 63, T - 1);
    float dqa[D / 2];
    zero(dqa);
    for (int i = 0; i < n; ++i) {
      const int stage = i % S;
      mbar_wait(&full[stage], (i / S) & 1);
      fence_proxy_async();
      const int k0 = (j_lo + i) * BN;
      const bool live = wq0 < T && k0 <= w_last && !(window > 0 && k0 + BN - 1 <= wq0 - window);
      if (live) {
        unsigned char* sp = sm + LY::STAGE0 + stage * LY::STAGE;
        const uint32_t sK = smem_u32(sp + LY::SK), sV = smem_u32(sp + LY::SV);
        float sa[BN / 2], dpa[BN / 2];
        zero(sa);
        zero(dpa);
        // S = qs·Kᵀ and dP = dO·Vᵀ for this warpgroup's 64 q rows
        wgmma_fence();
        qk_t<D, BN>(sa, sQ, BQ, wg * 64, sK, BN);
        qk_t<D, BN>(dpa, sDO, BQ, wg * 64, sV, BN);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa);
        fence_regs(dpa);
        // no entry of this warpgroup's tile is masked
        const bool inner = k0 + BN - 1 <= wq0 && wq0 + 64 <= T &&
                           (window == 0 || k0 > wq0 + 63 - window);
        auto elementwise = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bool ok = true;
              if constexpr (decltype(masked)::value) {
                const int qpos = qr + (e & 2 ? 8 : 0);
                const int kpos = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
                ok = kpos <= qpos && qpos < T && (window == 0 || kpos > qpos - window);
              }
              p_and_ds(sa[4 * j + e], dpa[4 * j + e], ok, e & 2 ? l1 : l0, e & 2 ? d1 : d0,
                       scale);
            }
        };
        if (inner)
          elementwise(std::false_type{});
        else
          elementwise(std::true_type{});
        uint32_t df[BN / 16][4];
        acc_to_frags<BN>(df, dpa);
        // dQ += bf16(dS)·K
        wgmma_fence();
        pv<D, BN / 16>(dqa, df, sK, BN);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    const int r0 = wq0 + warp * 16;
    const long long ld = static_cast<long long>(Hq) * D;
    store_acc<D>(dq + ((static_cast<long long>(b) * T + r0) * Hq + h) * D, ld, dqa, T - r0);
  }
}

template <int D>
cudaError_t launch_delta(const void* o, const void* dO, void* delta, int B, int T, int Hq,
                         const Strides& s, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Hq * T;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<float*>(delta), T,
      Hq, rows, s);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_ws(const void* q, const void* k, const void* v, const void* o,
                          const void* dO, const void* lse, void* delta, int make_delta, void* dk,
                          void* dv, int B, int T, int Hq, int Hkv, const Strides& s, float scale,
                          int window, cudaStream_t stream) {
  using LY = DkvWs<D>;
  static cudaError_t attr = set_smem(flash_bwd_dkv_ws_kernel<D>, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  if (make_delta) {
    const cudaError_t e = launch_delta<D>(o, dO, delta, B, T, Hq, s, stream);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hkv, B, (T + LY::BK - 1) / LY::BK);
  flash_bwd_dkv_ws_kernel<D><<<grid, WS_THREADS, LY::ALLOC, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq,
      Hkv, s, scale, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_ws(const void* q, const void* k, const void* v, const void* o,
                         const void* dO, const void* lse, void* delta, int make_delta, void* dq,
                         int B, int T, int Hq, int Hkv, const Strides& s, float scale, int window,
                         cudaStream_t stream) {
  using LY = DqWs<D>;
  static cudaError_t attr = set_smem(flash_bwd_dq_ws_kernel<D>, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  if (make_delta) {
    const cudaError_t e = launch_delta<D>(o, dO, delta, B, T, Hq, s, stream);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hq, B, (T + LY::BQ - 1) / LY::BQ);
  flash_bwd_dq_ws_kernel<D><<<grid, WS_THREADS, LY::ALLOC, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), T, Hq, Hkv, s, scale, window);
  return cudaGetLastError();
}

}  // namespace

#define KOIFISH_BWD_ARGS                                                                      \
  int B, int T, int Hq, int Hkv, int D, long long qsb, long long qst, long long qsh,         \
      long long ksb, long long kst, long long ksh, long long vsb, long long vst, long long vsh, \
      long long osb, long long ost, long long osh, long long dsb, long long dst, long long dsh, \
      float scale, int window, int make_delta, void* stream

// delta: f32 [B,Hq,T], computed first when make_delta, else read (D <= 128;
// the D = 256 kernels recompute it and ignore the buffer)
KOIFISH_API int koifish_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                      const void* dO, const void* lse, void* delta, void* dk,
                                      void* dv, KOIFISH_BWD_ARGS) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0) return cudaErrorInvalidValue;
  const Strides s{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, dsb, dst, dsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv_ws<64>(q, k, v, o, dO, lse, delta, make_delta, dk, dv, B, T, Hq, Hkv, s,
                               scale, window, st);
    case 128:
      return launch_dkv_ws<128>(q, k, v, o, dO, lse, delta, make_delta, dk, dv, B, T, Hq, Hkv, s,
                                scale, window, st);
    case 256:
      return launch_dkv<256, 2, 32>(q, k, v, o, dO, lse, dk, dv, B, T, Hq, Hkv, s, scale, window,
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}

KOIFISH_API int koifish_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dO, const void* lse, void* delta, void* dq,
                                     KOIFISH_BWD_ARGS) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0) return cudaErrorInvalidValue;
  const Strides s{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, dsb, dst, dsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq_ws<64>(q, k, v, o, dO, lse, delta, make_delta, dq, B, T, Hq, Hkv, s,
                              scale, window, st);
    case 128:
      return launch_dq_ws<128>(q, k, v, o, dO, lse, delta, make_delta, dq, B, T, Hq, Hkv, s,
                               scale, window, st);
    case 256:
      return launch_dq<256, 32>(q, k, v, o, dO, lse, dq, B, T, Hq, Hkv, s, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}
