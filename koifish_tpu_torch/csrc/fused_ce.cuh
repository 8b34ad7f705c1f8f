// Fused classifier cross-entropy for Hopper, both flavours: lse / gold, dx
// and dw of CE(x · w) without ever writing the [m, V] logits.
//
// Replaces the Pallas kernels of koifish_tpu/ops/pallas/fused_ce.py:
// _fwd_call (:117, call :126), _dx_call (:209, call :217) and _dw_call (:278,
// call :302), in their bf16 flavour (fused_ce.cu) and their int8 flavour
// (fused_ce_int8.cu, int8=True). Both sources include this header and
// instantiate only their own flavour, so the two build in parallel.
//
// bf16: x [m, E] bf16 row-major; the head w [E, V] bf16 read through its
// strides, [E, V] storage (an untied head) or [V, E] storage (the tied wte
// read in place as wte.T). Logits in f32 from bf16 products (WMMA 16x16x16,
// f32 accumulate).
// int8: xq [m, E] int8 + sx [m] f32 (row scales), wq int8 in [V, E] storage
// (the column-quantized head; the wrapper brings an untied head's codes to
// that order) + sw [V] f32. Logits = (xq · wq)_int32 · sx · sw (int8
// mma.sync m16n8k32, exact int32 sums), as _tile_logits computes them. dx
// multiplies dlogits by bf16(wq · sw), dequantized per tile in shared
// memory; dw multiplies the TRUE bf16 x by dlogits (int8 wgrad measured
// harmful in the JAX package).
// Both: tgt [m] int32, lse / wtok [m] f32; the vocab tail masked in-kernel.
//
//   fwd: one block of 8 warps per (64-row tile, vocab split) with its x rows
//     resident in shared memory; [64 e x 64 v] head chunks stream through a
//     cp.async ring; each [64, 64] logits tile folds into a running (max,
//     sumexp, gold) per row; with the vocab split, the partials go to a
//     workspace that a second pass merges in split order.
//   dx: one block per (32-row tile, vocab split, E part). The x rows stay in
//     shared memory, the [32, E part] f32 dx accumulator in registers; each
//     32-wide vocab tile's [32, E] head tile is loaded once (the next one in
//     flight when shared memory allows), its logits recomputed over the whole
//     E, turned into dlogits = bf16((p − onehot)·wtok), and dx[:, part] +=
//     dlogits·w[part]ᵀ.
//   dw: one block per (32-column vocab tile, E part): the [E, 32] head tile
//     stays in shared memory, the [E part, 32] accumulator in registers; it
//     walks all rows in 32-row x tiles (double-buffered when shared memory
//     allows), recomputes the logits and dlogits and adds x[:, part]ᵀ·dlogits.
//
// E up to 1280 (GPT2-774M): the accumulators are E/64 16x16 fragments a warp
// when a block owns the whole E, and 20 fragments (160 registers a thread)
// do not fit beside the rest. So E is split into parts of at most 16 chunks
// of 64 (E 1280: two parts of 640), each a block of its own that recomputes
// the full-E logits tile: dx and dw do 1.5x the operations at E 1280 and none
// more at E <= 1024. The alternatives were more warps a block (128 registers
// a thread at 512 threads: spills) or part of the accumulator in shared
// memory (a load and store of it per vocab tile). A part's accumulator size
// is a template parameter (1..16 chunks); so is E where one part covers it
// (E <= 1024: the logits loop unrolls fully), and E 1088..1280 run with E
// a run-time value.
//
// Why these tilings: the TPU sweeps carry a [BM, E] or [E, BV] f32
// accumulator in VMEM across a sequential grid axis (up to 16 MB); a Hopper
// block has 227 KB of shared memory and 64K registers, so a block owns a
// narrow row or vocab tile, keeps the accumulator in registers and the tiles
// it re-uses in shared memory, and loops over the other axis itself. Nothing
// is summed with atomics: every sum has one order, so two runs give the same
// bits.
//
// What bounds them on the H100: 2·m·E·V (fwd) and 4·m·E·V (dx, dw)
// operations on the tensor cores, the logits half at the int8 rate in the
// int8 flavour. In this design the bound is the traffic from L2 that the
// narrow tiles cause (the head is read m/64 times by fwd and m/32 times by
// dx; x is read V/32 times by dw) and the round trips of logits and dlogits
// through shared memory; the products use WMMA and mma.sync, not wgmma, and
// the loads cp.async, not TMA.
#pragma once

#include "int8.cuh"

#include <mma.h>

#include <algorithm>
#include <type_traits>

namespace fce {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr int NSM_TARGET = 2 * 132;   // blocks to aim for: two per H100 SM
constexpr int EC = 64;                // E chunk
constexpr int NT = 256;               // threads per block: 8 warps
constexpr int E_MAX = 1280;
constexpr int NCP_MAX = 16;           // E chunks of one part (accumulator fragments a warp)
constexpr size_t SMEM_MAX = 232448;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <typename L>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, L>;

inline bool bad_shape(int m, int E, int V) {
  return m < 1 || V < 1 || E < EC || E % EC != 0 || E > E_MAX;
}

inline int splits_for(int row_tiles, int n_tiles) {
  const int want = (NSM_TARGET + row_tiles - 1) / row_tiles;
  return std::max(1, std::min(want, n_tiles));
}

// E parts of at most NCP_MAX chunks, as even as possible
inline void parts_for(int E, int& parts, int& ncp) {
  const int nc = E / EC;
  parts = (nc + NCP_MAX - 1) / NCP_MAX;
  ncp = (nc + parts - 1) / parts;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  // the byte count depends on E: set the attribute on every call (cheap)
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  return set_smem(kernel, bytes);
}

// Rows [r0, r0 + R) of a row-major matrix of T (row stride ldx elements),
// columns [c0, c0 + C), into shared memory rows of LD elements by cp.async
// (the caller commits and waits); rows past m are zero. C·sizeof(T) % 16 == 0.
template <int R, typename T>
__device__ __forceinline__ void load_rows_async(T* X, int LD, const T* x, long long ldx, int r0,
                                                int c0, int C, int m) {
  constexpr int PER = 16 / sizeof(T);
  const int ch = C / PER;
  for (int i = threadIdx.x; i < R * ch; i += NT) {
    const int r = i / ch, c = (i % ch) * PER;
    const bool in = r0 + r < m;
    cp_async16(X + r * LD + c, in ? x + static_cast<long long>(r0 + r) * ldx + c0 + c : x,
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// forward: per-row (max, sumexp, gold) over a vocab range
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BV = 64, F_ST = 3;   // rows, vocab tile, stages
constexpr int F_LDL = F_BV + 4;

// A staged bf16 head chunk: EC e-values × VC v-values starting at (e0, v0).
// VE (w stored [V, E], unit e stride): smem W[v][e], row stride EC + 8.
// EV (w stored [E, V], unit v stride): smem W[e][v], row stride VC + 8.
// Values past V are zero.
template <bool VE, int VC>
struct HeadTile {
  static constexpr int LD = VE ? EC + 8 : VC + 8;
  static constexpr size_t BYTES = sizeof(bf16) * (VE ? VC : EC) * LD;
  // B operand of logits = x·w: element (k = e, n = v)
  using LogitsB = std::conditional_t<VE, wmma::col_major, wmma::row_major>;
  __device__ static const bf16* logits_b(const bf16* W, int kk, int n0) {
    return VE ? W + n0 * LD + kk : W + kk * LD + n0;
  }
  __device__ static void load_async(bf16* W, const bf16* w, long long swe, long long swv, int e0,
                                    int v0, int V) {
    if (VE) {   // VC rows of v, EC contiguous e each
      for (int i = threadIdx.x; i < VC * (EC / 8); i += NT) {
        const int r = i / (EC / 8), c = (i % (EC / 8)) * 8;
        const bool in = v0 + r < V;
        cp_async16(W + r * LD + c, in ? w + (v0 + r) * swv + e0 + c : w, in ? 16 : 0);
      }
    } else {    // EC rows of e, VC contiguous v each; the vocab tail zero-filled
      for (int i = threadIdx.x; i < EC * (VC / 8); i += NT) {
        const int r = i / (VC / 8), c = (i % (VC / 8)) * 8;
        const int n = min(8, V - (v0 + c));
        cp_async16(W + r * LD + c, n > 0 ? w + (e0 + r) * swe + v0 + c : w, n > 0 ? 2 * n : 0);
      }
    }
  }
};

// A staged int8 head chunk: F_BV v rows of EC e bytes ([V, E] storage).
struct HeadTile8 {
  static constexpr int LD = EC + 16;
  static constexpr size_t BYTES = F_BV * LD;
  __device__ static void load_async(int8_t* W, const int8_t* w, long long ldw, int e0, int v0,
                                    int V) {
    for (int i = threadIdx.x; i < F_BV * (EC / 16); i += NT) {
      const int r = i / (EC / 16), c = (i % (EC / 16)) * 16;
      const bool in = v0 + r < V;
      cp_async16(W + r * LD + c, in ? w + (v0 + r) * ldw + e0 + c : w, in ? 16 : 0);
    }
  }
};

// shared memory of the forward: the head-chunk ring, the logits tile, the
// row columns (max, sumexp, gold, target, x scale), then the x rows
template <bool INT8, bool VE>
struct FwdLayout {
  static constexpr size_t STAGE = align128(INT8 ? HeadTile8::BYTES : HeadTile<VE, F_BV>::BYTES);
  static constexpr size_t W = 0;
  static constexpr size_t L = W + F_ST * STAGE;
  static constexpr size_t M = L + align128(sizeof(float) * F_BM * F_LDL);
  static constexpr size_t S = M + align128(sizeof(float) * F_BM);
  static constexpr size_t G = S + align128(sizeof(float) * F_BM);
  static constexpr size_t TG = G + align128(sizeof(float) * F_BM);
  static constexpr size_t SX = TG + align128(sizeof(int) * F_BM);
  static constexpr size_t X = SX + align128(sizeof(float) * F_BM);
  __host__ __device__ static int ldx(int E) { return INT8 ? E + 16 : E + 8; }
  __host__ __device__ static size_t bytes(int E) {
    return X + (INT8 ? 1 : sizeof(bf16)) * F_BM * ldx(E);
  }
};

// fold a [64, 64] logits tile (row stride F_LDL) into the running (max,
// sumexp, gold): 8 rows per warp
__device__ __forceinline__ void fold_tile(const float* L, float* Mr, float* Sr, float* Gr,
                                          const int* Tg, int v0, int V) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < F_BM / 8; ++i) {
    const int r = warp * (F_BM / 8) + i;
    float l[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = lane + 32 * cc;
      l[cc] = v0 + col < V ? L[r * F_LDL + col] : NEG_INF;
    }
    const float m_prev = Mr[r];
    const float m_new = fmaxf(m_prev, warp_max(fmaxf(l[0], l[1])));
    const float sum = warp_sum(expf(l[0] - m_new) + expf(l[1] - m_new));
    if (lane == 0) {
      Sr[r] = Sr[r] * expf(m_prev - m_new) + sum;
      Mr[r] = m_new;
      const int tg = Tg[r];
      if (tg >= v0 && tg < v0 + F_BV && tg < V) Gr[r] += L[r * F_LDL + tg - v0];
    }
    __syncwarp();
  }
}

// The head chunks of a block's vocab range form one stream of steps (vocab
// tile t, E chunk c); a ring of F_ST staged chunks keeps the next ones in
// flight (cp.async) while the current one is multiplied. INT8: x, w are the
// codes, sx / sw their scales (ldw the row stride of wq's [V, E] storage).
template <bool INT8, bool VE>
__global__ void __launch_bounds__(NT)
    fce_fwd_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   const int* __restrict__ tgt, float* __restrict__ lse_out,
                   float* __restrict__ gold_out, float* __restrict__ ws, int m, int E, int V,
                   long long swe, long long swv, int tiles_per_split) {
  using LY = FwdLayout<INT8, VE>;
  using T = std::conditional_t<INT8, int8_t, bf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem + LY::L);
  float* Mr = reinterpret_cast<float*>(smem + LY::M);
  float* Sr = reinterpret_cast<float*>(smem + LY::S);
  float* Gr = reinterpret_cast<float*>(smem + LY::G);
  int* Tg = reinterpret_cast<int*>(smem + LY::TG);
  float* Sx = reinterpret_cast<float*>(smem + LY::SX);
  T* Xs = reinterpret_cast<T*>(smem + LY::X);
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const int LDX = LY::ldx(E);

  const int r0 = blockIdx.x * F_BM;
  const int split = blockIdx.y;
  const int n_tiles = (V + F_BV - 1) / F_BV;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int nc = E / EC;
  const int n_steps = max(0, t_end - t_begin) * nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // logits tile [64, 64]: warp -> 16 rows x 32 columns
  const int lr = (warp / 2) * 16, lc = (warp % 2) * 32;
  auto stage = [&](int step) { return reinterpret_cast<T*>(smem + LY::W + (step % F_ST) * LY::STAGE); };
  auto prefetch = [&](int step) {
    if (step < n_steps) {
      const int e0 = (step % nc) * EC, v0 = (t_begin + step / nc) * F_BV;
      if constexpr (INT8)
        HeadTile8::load_async(stage(step), w, swv, e0, v0, V);
      else
        HeadTile<VE, F_BV>::load_async(stage(step), w, swe, swv, e0, v0, V);
    }
    cp_async_commit();
  };

  load_rows_async<F_BM>(Xs, LDX, x, E, r0, 0, E, m);   // first group: x rows
  for (int i = threadIdx.x; i < F_BM; i += NT) {
    Mr[i] = NEG_INF;
    Sr[i] = 0.f;
    Gr[i] = 0.f;
    Tg[i] = r0 + i < m ? tgt[r0 + i] : -1;
    if (INT8) Sx[i] = r0 + i < m ? sx[r0 + i] : 0.f;
  }
  for (int st = 0; st < F_ST - 1; ++st) prefetch(st);

  FragC acc[2];
  int iacc[4][4];
  if constexpr (INT8) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) iacc[n][i] = 0;
  } else {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<F_ST - 2>();
    __syncthreads();   // chunk `step` landed; the slot of step - 1 is free
    prefetch(step + F_ST - 1);
    const int c = step % nc;
    const T* Wb = stage(step);
    if constexpr (INT8) {
#pragma unroll
      for (int kk = 0; kk < EC; kk += 32) {
        uint32_t a[4];
        load_a_s8(a, Xs, LDX, lr, c * EC + kk);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b0, b1;
          load_b_s8(b0, b1, Wb, HeadTile8::LD, lc + n * 8, kk);
          mma_s8(iacc[n], a, b0, b1);
        }
      }
    } else {
      using HT = HeadTile<VE, F_BV>;
#pragma unroll
      for (int kk = 0; kk < EC; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, Xs + lr * LDX + c * EC + kk, LDX);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          FragB<typename HT::LogitsB> fb;
          wmma::load_matrix_sync(fb, HT::logits_b(Wb, kk, lc + n * 16), HT::LD);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
    }
    if (c != nc - 1) continue;
    const int v0 = (t_begin + step / nc) * F_BV;
    if constexpr (INT8) {
      // logits = (int32 sum · sx) · sw, as _tile_logits
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = lr + g + (i < 2 ? 0 : 8), col = lc + n * 8 + 2 * tq + (i & 1);
          const float s = v0 + col < V ? sw[v0 + col] : 0.f;
          L[row * F_LDL + col] = __fmul_rn(__fmul_rn(static_cast<float>(iacc[n][i]), Sx[row]), s);
          iacc[n][i] = 0;
        }
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::store_matrix_sync(L + lr * F_LDL + lc + n * 16, acc[n], F_LDL, wmma::mem_row_major);
        wmma::fill_fragment(acc[n], 0.f);
      }
    }
    __syncthreads();
    // the next store to L is nc steps (and as many block syncs) away
    fold_tile(L, Mr, Sr, Gr, Tg, v0, V);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < F_BM; i += NT) {
    const int row = r0 + i;
    if (row >= m) continue;
    if (ws == nullptr) {
      lse_out[row] = Mr[i] + logf(fmaxf(Sr[i], 1e-30f));
      gold_out[row] = Gr[i];
    } else {
      float* p = ws + (static_cast<long long>(split) * m + row) * 3;
      p[0] = Mr[i];
      p[1] = Sr[i];
      p[2] = Gr[i];
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

template <bool INT8, bool VE>
cudaError_t launch_fwd(const void* x, const void* w, const float* sx, const float* sw,
                       const void* tgt, void* lse, void* gold, void* ws, int m, int E, int V,
                       long long swe, long long swv, cudaStream_t st) {
  const int row_tiles = (m + F_BM - 1) / F_BM, n_tiles = (V + F_BV - 1) / F_BV;
  const int splits = splits_for(row_tiles, n_tiles);
  if ((splits > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  const int per = (n_tiles + splits - 1) / splits;
  const size_t bytes = FwdLayout<INT8, VE>::bytes(E);
  cudaError_t err = prepare(fce_fwd_kernel<INT8, VE>, bytes);
  if (err != cudaSuccess) return err;
  float* wsf = static_cast<float*>(ws);
  fce_fwd_kernel<INT8, VE><<<dim3(row_tiles, splits), NT, bytes, st>>>(
      x, w, sx, sw, static_cast<const int*>(tgt), static_cast<float*>(lse),
      static_cast<float*>(gold), wsf, m, E, V, swe, swv, per);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  fce_fwd_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(wsf, static_cast<float*>(lse),
                                                        static_cast<float*>(gold), m, splits);
  return cudaGetLastError();
}

}  // namespace fce

#include "fused_ce_bwd.cuh"
