// Fused classifier cross-entropy for Hopper: lse / gold, dx and dw of
// CE(x · w) without ever writing the [m, V] logits.
//
// Replaces the bf16 flavour of the Pallas kernels of
// koifish_tpu/ops/pallas/fused_ce.py: _fwd_call (:126), _dx_call (:217) and
// _dw_call (:302). x is [m, E] bf16 row-major; the head w [E, V] bf16 is
// read through its strides, either [E, V] storage (an untied head) or
// [V, E] storage (the tied wte read in place as wte.T, no transposed copy);
// tgt [m] int32, lse / wtok [m] f32. Each kernel recomputes its logits tile
// in f32 from bf16 products (WMMA 16x16x16 on the tensor cores, f32
// accumulate) and masks the vocab tail in-kernel (151936 and 50304 are not
// multiples of a wide tile):
//
//   fused_ce_fwd: one block of 8 warps per (64-row tile, vocab split) with
//     its x rows resident in shared memory; [64 e x 64 v] head chunks stream
//     through a cp.async ring; each [64, 64] logits tile folds into a
//     running (max, sumexp, gold) per row and, when the vocab is split, the
//     partials go to a workspace that a second pass merges in split order.
//   fused_ce_dx: one block per (32-row tile, vocab split) owning the WHOLE
//     E: the x rows stay in shared memory and the [32, E] f32 dx
//     accumulator in registers (E / 64 fragments a warp, E fixed at compile
//     time); each 32-wide vocab tile's [32, E] head tile is loaded once
//     (the next one in flight), its logits recomputed, turned into dlogits
//     = bf16((p − onehot)·wtok), and dx += dlogits·wᵀ. With the vocab split
//     (few rows), f32 partials go to a workspace summed in split order.
//   fused_ce_dw: one block per 32-column vocab tile owning the whole E: the
//     [E, 32] head tile stays in shared memory, the [E, 32] f32 accumulator
//     in registers; it walks all rows in double-buffered 32-row x tiles,
//     recomputes the logits and dlogits and adds xᵀ·dlogits. dw is written
//     [E, V] or, for the tied head, into the [V, E] gradient of wte.
//
// Why these tilings: the TPU sweeps carry a [BM, E] or [E, BV] f32
// accumulator in VMEM across a sequential grid axis (up to 16 MB); a
// Hopper block has 227 KB of shared memory and 64K registers, so a block
// owns a narrow row or vocab tile together with the whole E, keeps the
// accumulator in registers and the tiles it re-uses in shared memory, and
// loops over the other axis itself. E <= 1024. Nothing is summed with
// atomics: every sum has one order, so two runs give the same bits.
//
// What bounds them on the H100: 2·m·E·V (fwd) and 4·m·E·V (dx, dw) flops on
// the tensor cores — ~990 flops per byte of x and w at the Qwen3 slice
// shape, far above the card's ridge. In this design the bound is the
// traffic from L2 that the narrow tiles cause (the head is read m/64 times
// by fwd and m/32 times by dx; x is read V/32 times by dw: ~40-80 GB a call
// at the Qwen3 slice shape, 32-64 flops per byte) and the round trips of
// logits and dlogits through shared memory; the products use WMMA, not
// wgmma, and the loads cp.async, not TMA.
#include "common.cuh"

#include <mma.h>

#include <algorithm>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NSM_TARGET = 2 * 132;   // blocks to aim for: two per H100 SM
constexpr int EC = 64;                // E chunk of a staged head tile
constexpr int NT = 256;               // threads per block: 8 warps

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <typename L>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, L>;

// A staged head tile: EC e-values × VC v-values starting at (e0, v0).
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
  // B operand of dx = dlogits·wᵀ: element (k = v, n = e)
  using DxB = std::conditional_t<VE, wmma::row_major, wmma::col_major>;
  __device__ static const bf16* dx_b(const bf16* W, int kk, int n0) {
    return VE ? W + kk * LD + n0 : W + n0 * LD + kk;
  }

  // start the tile's cp.async copies (the caller commits and waits)
  template <int NT>
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

// Rows [r0, r0 + R) of x [m, E] (columns [c0, c0 + C)) into smem with row
// stride LD by cp.async (the caller commits and waits); rows past m are zero.
template <int R, int NT>
__device__ __forceinline__ void load_x_async(bf16* X, int LD, const bf16* x, int E, int r0,
                                             int c0, int C, int m) {
  const int ch = C / 8;
  for (int i = threadIdx.x; i < R * ch; i += NT) {
    const int r = i / ch, c = (i % ch) * 8;
    const bool in = r0 + r < m;
    cp_async16(X + r * LD + c, in ? x + static_cast<long long>(r0 + r) * E + c0 + c : x,
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// forward: per-row (max, sumexp, gold) over a vocab range
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BV = 64, F_ST = 3;   // rows, vocab tile, stages

template <bool VE>
struct FwdLayout {
  using HT = HeadTile<VE, F_BV>;
  static constexpr int LDL = F_BV + 4;
  static constexpr size_t STAGE = align128(HT::BYTES);
  static constexpr size_t W = 0;
  static constexpr size_t L = W + F_ST * STAGE;
  static constexpr size_t M = L + align128(sizeof(float) * F_BM * LDL);
  static constexpr size_t S = M + align128(sizeof(float) * F_BM);
  static constexpr size_t G = S + align128(sizeof(float) * F_BM);
  static constexpr size_t TG = G + align128(sizeof(float) * F_BM);
  static constexpr size_t X = TG + align128(sizeof(int) * F_BM);
  __host__ __device__ static size_t bytes(int E) { return X + sizeof(bf16) * F_BM * (E + 8); }
};

// The head chunks of a block's vocab range form one stream of steps
// (vocab tile t, E chunk c); a ring of F_ST staged chunks keeps the next
// ones in flight (cp.async) while the current one is multiplied.
template <bool VE>
__global__ void __launch_bounds__(NT)
    fce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ tgt, float* __restrict__ lse_out,
                   float* __restrict__ gold_out, float* __restrict__ ws, int m, int E, int V,
                   long long swe, long long swv, int tiles_per_split) {
  using LY = FwdLayout<VE>;
  using HT = typename LY::HT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem + LY::L);
  float* Mr = reinterpret_cast<float*>(smem + LY::M);
  float* Sr = reinterpret_cast<float*>(smem + LY::S);
  float* Gr = reinterpret_cast<float*>(smem + LY::G);
  int* Tg = reinterpret_cast<int*>(smem + LY::TG);
  bf16* Xs = reinterpret_cast<bf16*>(smem + LY::X);
  const int LDX = E + 8;

  const int r0 = blockIdx.x * F_BM;
  const int split = blockIdx.y;
  const int n_tiles = (V + F_BV - 1) / F_BV;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int nc = E / EC;
  const int n_steps = max(0, t_end - t_begin) * nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // logits tile [64, 64]: warp -> 16 rows x 32 columns (two fragments)
  const int lr = (warp / 2) * 16, lc = (warp % 2) * 32;
  auto stage = [&](int step) {
    return reinterpret_cast<bf16*>(smem + LY::W + (step % F_ST) * LY::STAGE);
  };
  auto prefetch = [&](int step) {
    if (step < n_steps)
      HT::template load_async<NT>(stage(step), w, swe, swv, (step % nc) * EC,
                                  (t_begin + step / nc) * F_BV, V);
    cp_async_commit();
  };

  load_x_async<F_BM, NT>(Xs, LDX, x, E, r0, 0, E, m);   // first group: x rows
  for (int i = threadIdx.x; i < F_BM; i += NT) {
    Mr[i] = NEG_INF;
    Sr[i] = 0.f;
    Gr[i] = 0.f;
    Tg[i] = r0 + i < m ? tgt[r0 + i] : -1;
  }
  for (int st = 0; st < F_ST - 1; ++st) prefetch(st);

  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<F_ST - 2>();
    __syncthreads();   // chunk `step` landed; the slot of step - 1 is free
    prefetch(step + F_ST - 1);
    const int c = step % nc;
    const bf16* Wb = stage(step);
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
    if (c != nc - 1) continue;
    const int v0 = (t_begin + step / nc) * F_BV;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      wmma::store_matrix_sync(L + lr * LY::LDL + lc + n * 16, acc[n], LY::LDL,
                              wmma::mem_row_major);
      wmma::fill_fragment(acc[n], 0.f);
    }
    __syncthreads();
    // fold 8 rows per warp into the running (max, sumexp, gold); the next
    // store to L is nc steps (and as many block syncs) away
    for (int i = 0; i < F_BM / 8; ++i) {
      const int r = warp * (F_BM / 8) + i;
      float l[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = lane + 32 * cc;
        l[cc] = v0 + col < V ? L[r * LY::LDL + col] : NEG_INF;
      }
      const float m_prev = Mr[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(l[0], l[1])));
      const float sum = warp_sum(expf(l[0] - m_new) + expf(l[1] - m_new));
      if (lane == 0) {
        Sr[r] = Sr[r] * expf(m_prev - m_new) + sum;
        Mr[r] = m_new;
        const int tg = Tg[r];
        if (tg >= v0 && tg < v0 + F_BV && tg < V) Gr[r] += L[r * LY::LDL + tg - v0];
      }
      __syncwarp();
    }
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

// ---------------------------------------------------------------------------
// dx and dw: f32 accumulators in registers, E fixed at compile time
// ---------------------------------------------------------------------------
// Both kernels recompute a [32 rows, 32 vocab] logits tile, turn it into
// dlogits and add its product into an accumulator that spans the whole E:
// dx [32 rows, E] or dw [E, 32 columns]. The accumulator lives in
// registers: each of the 8 warps holds NC = E / 64 16x16 fragments, one
// per 64-wide E chunk, so E is a template parameter (64..1024) and every
// loop over the chunks is unrolled. That leaves shared memory for whole
// tiles: the [32 v, E] head tile of a vocab tile in dx (read once for the
// logits and the dx product) and, in dw, the block's head tile for all
// row tiles plus two [32 rows, E] x tiles (the next one loading while
// the current one is used).

constexpr int T32 = 32;   // rows (dx) or vocab columns (dw) per block

// A whole-E head tile of 32 vocab columns: VE storage gives smem
// W[v][e] (row stride E + 8), EV storage W[e][v] (row stride 40).
template <bool VE, int E>
struct WideHead {
  static constexpr int LD = VE ? E + 8 : T32 + 8;
  static constexpr size_t BYTES = sizeof(bf16) * (VE ? T32 : E) * LD;
  using LogitsB = std::conditional_t<VE, wmma::col_major, wmma::row_major>;
  // B of logits = x·w: (k = e, n = v)
  __device__ static const bf16* logits_b(const bf16* W, int e, int v) {
    return VE ? W + v * LD + e : W + e * LD + v;
  }
  using DxB = std::conditional_t<VE, wmma::row_major, wmma::col_major>;
  // B of dx = dlogits·wᵀ: (k = v, n = e)
  __device__ static const bf16* dx_b(const bf16* W, int v, int e) {
    return VE ? W + v * LD + e : W + e * LD + v;
  }
  __device__ static void load_async(bf16* W, const bf16* w, long long swe, long long swv,
                                    int v0, int V) {
    if (VE) {
      for (int i = threadIdx.x; i < T32 * (E / 8); i += NT) {
        const int r = i / (E / 8), c = (i % (E / 8)) * 8;
        const bool in = v0 + r < V;
        cp_async16(W + r * LD + c, in ? w + (v0 + r) * swv + c : w, in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < E * (T32 / 8); i += NT) {
        const int r = i / (T32 / 8), c = (i % (T32 / 8)) * 8;
        const int n = min(8, V - (v0 + c));
        cp_async16(W + r * LD + c, n > 0 ? w + r * swe + v0 + c : w, n > 0 ? 2 * n : 0);
      }
    }
  }
};

template <bool VE, int E, int WST>
struct WideLayout {
  using HW = WideHead<VE, E>;
  static constexpr int LDX = E + 8;   // bf16 x rows
  static constexpr int LDL = T32 + 4;  // f32 logits partials
  static constexpr int LDD = T32 + 8;  // bf16 dlogits
  static constexpr size_t XT = align128(sizeof(bf16) * T32 * LDX);
  static constexpr size_t WT = align128(HW::BYTES);
  static constexpr size_t PART = align128(sizeof(float) * 2 * T32 * LDL);
  static constexpr size_t DG = align128(sizeof(bf16) * T32 * LDD);
  static constexpr size_t COLS = align128(sizeof(float) * T32) * 3;
  // dx: an x tile, then WST head tiles; dw: a head tile, then WST x
  // tiles; then the logits partials, dlogits and the row columns
  static constexpr size_t DX_BYTES = XT + WST * WT + PART + DG + COLS;
  static constexpr size_t DW_BYTES = WT + WST * XT + PART + DG + COLS;
};

// logits partial of this warp: split-K over the two warp halves (warp w
// takes the E chunks of parity w / 4) for fragment f = w % 4 of the
// [32, 32] tile; stored to its half of the partials buffer
template <typename HW, int NC>
__device__ __forceinline__ void logits_partial(float* part, int ldl, const bf16* X, int ldx,
                                               const bf16* W) {
  const int warp = threadIdx.x / 32, f = warp % 4, half = warp / 4;
  const int r0 = (f / 2) * 16, c0 = (f % 2) * 16;
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c % 2 != half) continue;
#pragma unroll
    for (int kk = 0; kk < EC; kk += 16) {
      FragA fa;
      FragB<typename HW::LogitsB> fb;
      wmma::load_matrix_sync(fa, X + r0 * ldx + c * EC + kk, ldx);
      wmma::load_matrix_sync(fb, HW::logits_b(W, c * EC + kk, c0), HW::LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  wmma::store_matrix_sync(part + half * T32 * ldl + r0 * ldl + c0, acc, ldl,
                          wmma::mem_row_major);
}

// dlogits of the [32, 32] tile from the two logits partials
__device__ __forceinline__ void dlogits32(bf16* Dg, int ldd, const float* part, int ldl,
                                          const float* lse, const float* wtok, const int* tgt,
                                          int r0, int v0, int m, int V) {
  for (int i = threadIdx.x; i < T32 * T32; i += NT) {
    const int r = i / T32, c = i % T32;
    float d = 0.f;
    if (r0 + r < m && v0 + c < V) {
      const float l = part[r * ldl + c] + part[T32 * ldl + r * ldl + c];
      const float p = expf(l - lse[r]);
      d = (v0 + c == tgt[r] ? p - 1.f : p) * wtok[r];
    }
    Dg[r * ldd + c] = __float2bfloat16(d);
  }
}

// one accumulator fragment of this warp (16x16 f32) to global memory
// through a per-warp scratch tile, row r of the fragment going to
// out + r * ld_row, column c to + c * ld_col, rows at or past `rows` and
// columns at or past `cols` skipped; bf16 or f32 output
template <typename Out>
__device__ __forceinline__ void write_fragment(const FragC& f, float* scratch, Out* out,
                                               long long ld_row, long long ld_col, int rows,
                                               int cols) {
  const int lane = threadIdx.x % 32;
  wmma::store_matrix_sync(scratch, f, 16, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 256; i += 32) {
    const int r = i / 16, c = i % 16;
    if (r < rows && c < cols) {
      const float v = scratch[i];
      if constexpr (std::is_same<Out, float>::value)
        out[r * ld_row + c * ld_col] = v;
      else
        out[r * ld_row + c * ld_col] = __float2bfloat16(v);
    }
  }
  __syncwarp();
}

// dx: block = (32 rows, vocab split); the x rows stay resident, the head
// tile of each 32-wide vocab tile is loaded once (WST = 2: the next one in
// flight) and used for both the logits and the dx product.
template <bool VE, int NC>
__global__ void __launch_bounds__(NT)
    fce_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ tgt, const float* __restrict__ lse,
                  const float* __restrict__ wtok, bf16* __restrict__ dx, float* __restrict__ ws,
                  int m, int V, long long swe, long long swv, int tiles_per_split) {
  constexpr int E = NC * EC;
  constexpr int WST = VE ? 2 : 1;   // [E, 40] head tiles of EV storage fit once
  using LY = WideLayout<VE, E, WST>;
  using HW = typename LY::HW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  unsigned char* wbase = smem + LY::XT;
  float* Part = reinterpret_cast<float*>(wbase + WST * LY::WT);
  bf16* Dg = reinterpret_cast<bf16*>(wbase + WST * LY::WT + LY::PART);
  float* Ls = reinterpret_cast<float*>(wbase + WST * LY::WT + LY::PART + LY::DG);
  float* Wt = Ls + LY::COLS / 3 / sizeof(float);
  int* Tg = reinterpret_cast<int*>(Wt + LY::COLS / 3 / sizeof(float));

  const int r0 = blockIdx.x * T32;
  const int split = blockIdx.y;
  const int n_tiles = (V + T32 - 1) / T32;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 4) * 16, ac = (warp % 4) * 16;   // accumulator block
  auto wtile = [&](int t) {
    return reinterpret_cast<bf16*>(wbase + ((t - t_begin) % WST) * LY::WT);
  };
  auto prefetch = [&](int t) {
    if (t < t_end) HW::load_async(wtile(t), w, swe, swv, t * T32, V);
    cp_async_commit();
  };

  load_x_async<T32, NT>(Xs, LY::LDX, x, E, r0, 0, E, m);
  cp_async_commit();
  for (int i = threadIdx.x; i < T32; i += NT) {
    const bool in = r0 + i < m;
    Ls[i] = in ? lse[r0 + i] : 0.f;
    Wt[i] = in ? wtok[r0 + i] : 0.f;
    Tg[i] = in ? tgt[r0 + i] : -1;
  }
  for (int t = t_begin; t < t_begin + WST - 1; ++t) prefetch(t);

  FragC acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wmma::fill_fragment(acc[c], 0.f);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();   // everyone is done with tile t - 1 and its slot
    prefetch(t + WST - 1);
    cp_async_wait<WST - 1>();
    __syncthreads();   // tile t (and the x rows) landed
    const bf16* W = wtile(t);
    logits_partial<HW, NC>(Part, LY::LDL, Xs, LY::LDX, W);
    __syncthreads();
    dlogits32(Dg, LY::LDD, Part, LY::LDL, Ls, Wt, Tg, r0, t * T32, m, V);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NC; ++c) {   // dx[:, chunk c] += dlogits · w[chunk, tile]ᵀ
#pragma unroll
      for (int kk = 0; kk < T32; kk += 16) {
        FragA fa;
        FragB<typename HW::DxB> fb;
        wmma::load_matrix_sync(fa, Dg + ar * LY::LDD + kk, LY::LDD);
        wmma::load_matrix_sync(fb, HW::dx_b(W, kk, c * EC + ac), HW::LD);
        wmma::mma_sync(acc[c], fa, fb, acc[c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* scratch = Part + warp * 256;    // the partials buffer, reused
  const int rows = min(16, m - (r0 + ar));
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const long long at = static_cast<long long>(r0 + ar) * E + c * EC + ac;
    if (ws == nullptr)
      write_fragment(acc[c], scratch, dx + at, E, 1, rows, 16);
    else
      write_fragment(acc[c], scratch, ws + static_cast<long long>(split) * m * E + at, E, 1,
                     rows, 16);
  }
}

// sum the splits' f32 partials of dx in split order, round to bf16
__global__ void fce_dx_merge_kernel(const float* __restrict__ ws, bf16* __restrict__ dx,
                                    long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += ws[s * n + i];
  dx[i] = __float2bfloat16(acc);
}

// dw: block = 32 vocab columns; the head tile stays resident, x tiles of
// 32 rows are double-buffered, and each is used for both the logits and
// the xᵀ·dlogits product.
template <bool VE, int NC>
__global__ void __launch_bounds__(NT)
    fce_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ tgt, const float* __restrict__ lse,
                  const float* __restrict__ wtok, bf16* __restrict__ dw, int m, int V,
                  long long swe, long long swv, long long sde, long long sdv) {
  constexpr int E = NC * EC;
  using LY = WideLayout<VE, E, 2>;
  using HW = typename LY::HW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W = reinterpret_cast<bf16*>(smem);
  unsigned char* xbase = smem + LY::WT;
  float* Part = reinterpret_cast<float*>(xbase + 2 * LY::XT);
  bf16* Dg = reinterpret_cast<bf16*>(xbase + 2 * LY::XT + LY::PART);
  float* Ls = reinterpret_cast<float*>(xbase + 2 * LY::XT + LY::PART + LY::DG);
  float* Wt = Ls + LY::COLS / 3 / sizeof(float);
  int* Tg = reinterpret_cast<int*>(Wt + LY::COLS / 3 / sizeof(float));

  const int v0 = blockIdx.x * T32;
  const int n_mt = (m + T32 - 1) / T32;
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 2) * 16, ac = (warp % 2) * 16;   // accumulator block
  auto xtile = [&](int mt) { return reinterpret_cast<bf16*>(xbase + (mt % 2) * LY::XT); };
  auto prefetch = [&](int mt) {
    if (mt < n_mt) load_x_async<T32, NT>(xtile(mt), LY::LDX, x, E, mt * T32, 0, E, m);
    cp_async_commit();
  };

  HW::load_async(W, w, swe, swv, v0, V);
  cp_async_commit();
  prefetch(0);

  FragC acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wmma::fill_fragment(acc[c], 0.f);
  for (int mt = 0; mt < n_mt; ++mt) {
    const int r0 = mt * T32;
    __syncthreads();   // everyone is done with x tile mt - 1 and its slot
    prefetch(mt + 1);
    cp_async_wait<1>();
    for (int i = threadIdx.x; i < T32; i += NT) {
      const bool in = r0 + i < m;
      Ls[i] = in ? lse[r0 + i] : 0.f;
      Wt[i] = in ? wtok[r0 + i] : 0.f;
      Tg[i] = in ? tgt[r0 + i] : -1;
    }
    __syncthreads();   // x tile mt (and the head tile) landed
    const bf16* X = xtile(mt);
    logits_partial<HW, NC>(Part, LY::LDL, X, LY::LDX, W);
    __syncthreads();
    dlogits32(Dg, LY::LDD, Part, LY::LDL, Ls, Wt, Tg, r0, v0, m, V);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NC; ++c) {   // dw[chunk c, cols] += x[rows, chunk c]ᵀ · dlogits
#pragma unroll
      for (int kk = 0; kk < T32; kk += 16) {
        FragAc fa;   // A(e, r) = x[r][e]: column-major view of the x tile
        FragB<wmma::row_major> fb;
        wmma::load_matrix_sync(fa, X + kk * LY::LDX + c * EC + ar, LY::LDX);
        wmma::load_matrix_sync(fb, Dg + kk * LY::LDD + ac, LY::LDD);
        wmma::mma_sync(acc[c], fa, fb, acc[c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* scratch = Part + warp * 256;    // the partials buffer, reused
  const int cols = min(16, V - (v0 + ac));
#pragma unroll
  for (int c = 0; c < NC; ++c)
    write_fragment(acc[c], scratch, dw + (c * EC + ar) * sde + (v0 + ac) * sdv, sde, sdv, 16,
                   cols);
}

int splits_for(int row_tiles, int n_tiles) {
  const int want = (NSM_TARGET + row_tiles - 1) / row_tiles;
  return std::max(1, std::min(want, n_tiles));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  // the byte count depends on E: set the attribute on every call (cheap)
  if (bytes > 232448) return cudaErrorInvalidValue;
  return set_smem(kernel, bytes);
}

}  // namespace

// Vocab splits the forward (which = 0) or dx (which = 1) kernel uses for
// m rows: the caller allocates a [splits, m, 3] / [splits, m, E] f32
// workspace when this is above 1.
KOIFISH_API int koifish_fused_ce_splits(int which, int m, int V) {
  if (which == 0) return splits_for((m + F_BM - 1) / F_BM, (V + F_BV - 1) / F_BV);
  return splits_for((m + T32 - 1) / T32, (V + T32 - 1) / T32);
}

static bool bad_shape(int m, int E, int V) {
  return m < 1 || V < 1 || E < EC || E % EC != 0 || E > 1024;
}

KOIFISH_API int koifish_fused_ce_fwd(const void* x, const void* w, const void* tgt, void* lse,
                                     void* gold, void* ws, int m, int E, int V, long long swe,
                                     long long swv, void* stream) {
  if (bad_shape(m, E, V) || (swe != 1 && swv != 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (m + F_BM - 1) / F_BM, n_tiles = (V + F_BV - 1) / F_BV;
  const int splits = splits_for(row_tiles, n_tiles);
  if ((splits > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  const int per = (n_tiles + splits - 1) / splits;
  dim3 grid(row_tiles, splits);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err;
  if (swe == 1) {
    const size_t bytes = FwdLayout<true>::bytes(E);
    if ((err = prepare(fce_fwd_kernel<true>, bytes)) != cudaSuccess) return err;
    fce_fwd_kernel<true><<<grid, NT, bytes, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(tgt),
        static_cast<float*>(lse), static_cast<float*>(gold), wsf, m, E, V, swe, swv, per);
  } else {
    const size_t bytes = FwdLayout<false>::bytes(E);
    if ((err = prepare(fce_fwd_kernel<false>, bytes)) != cudaSuccess) return err;
    fce_fwd_kernel<false><<<grid, NT, bytes, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(tgt),
        static_cast<float*>(lse), static_cast<float*>(gold), wsf, m, E, V, swe, swv, per);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  fce_fwd_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(wsf, static_cast<float*>(lse),
                                                        static_cast<float*>(gold), m, splits);
  return cudaGetLastError();
}

#define KOIFISH_NC_CASES(F)                                                                   \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15) F(16)

template <bool VE, int NC>
cudaError_t launch_dx(const void* x, const void* w, const void* tgt, const void* lse,
                      const void* wtok, void* dx, float* ws, int m, int V, long long swe,
                      long long swv, dim3 grid, int per, cudaStream_t st) {
  constexpr size_t bytes = WideLayout<VE, NC * EC, VE ? 2 : 1>::DX_BYTES;
  static_assert(bytes <= 232448, "fused_ce_dx: shared memory");
  cudaError_t err = prepare(fce_dx_kernel<VE, NC>, bytes);
  if (err != cudaSuccess) return err;
  fce_dx_kernel<VE, NC><<<grid, NT, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(wtok), static_cast<bf16*>(dx),
      ws, m, V, swe, swv, per);
  return cudaGetLastError();
}

template <bool VE, int NC>
cudaError_t launch_dw(const void* x, const void* w, const void* tgt, const void* lse,
                      const void* wtok, void* dw, int m, int V, long long swe, long long swv,
                      long long sde, long long sdv, cudaStream_t st) {
  constexpr size_t bytes = WideLayout<VE, NC * EC, 2>::DW_BYTES;
  static_assert(bytes <= 232448, "fused_ce_dw: shared memory");
  cudaError_t err = prepare(fce_dw_kernel<VE, NC>, bytes);
  if (err != cudaSuccess) return err;
  fce_dw_kernel<VE, NC><<<(V + T32 - 1) / T32, NT, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(wtok), static_cast<bf16*>(dw),
      m, V, swe, swv, sde, sdv);
  return cudaGetLastError();
}

KOIFISH_API int koifish_fused_ce_dx(const void* x, const void* w, const void* tgt, const void* lse,
                                    const void* wtok, void* dx, void* ws, int m, int E, int V,
                                    long long swe, long long swv, void* stream) {
  if (bad_shape(m, E, V) || (swe != 1 && swv != 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (m + T32 - 1) / T32, n_tiles = (V + T32 - 1) / T32;
  const int splits = splits_for(row_tiles, n_tiles);
  if ((splits > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid(row_tiles, splits);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  switch (E / EC) {
#define KOIFISH_DX_CASE(n)                                                                  \
  case n:                                                                                   \
    err = swe == 1 ? launch_dx<true, n>(x, w, tgt, lse, wtok, dx, wsf, m, V, swe, swv, grid, \
                                        per, st)                                            \
                   : launch_dx<false, n>(x, w, tgt, lse, wtok, dx, wsf, m, V, swe, swv,     \
                                         grid, per, st);                                   \
    break;
    KOIFISH_NC_CASES(KOIFISH_DX_CASE)
#undef KOIFISH_DX_CASE
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(m) * E;
  fce_dx_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      wsf, static_cast<bf16*>(dx), n, splits);
  return cudaGetLastError();
}

KOIFISH_API int koifish_fused_ce_dw(const void* x, const void* w, const void* tgt, const void* lse,
                                    const void* wtok, void* dw, int m, int E, int V, long long swe,
                                    long long swv, long long sde, long long sdv, void* stream) {
  if (bad_shape(m, E, V) || (swe != 1 && swv != 1) || (sde != 1 && sdv != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E / EC) {
#define KOIFISH_DW_CASE(n)                                                                  \
  case n:                                                                                   \
    return swe == 1                                                                         \
               ? launch_dw<true, n>(x, w, tgt, lse, wtok, dw, m, V, swe, swv, sde, sdv, st) \
               : launch_dw<false, n>(x, w, tgt, lse, wtok, dw, m, V, swe, swv, sde, sdv, st);
    KOIFISH_NC_CASES(KOIFISH_DW_CASE)
#undef KOIFISH_DW_CASE
  }
  return cudaErrorInvalidValue;
}
