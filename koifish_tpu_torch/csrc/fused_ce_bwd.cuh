// The dx and dw kernels of the fused classifier CE, both flavours (see
// fused_ce.cuh): f32 accumulators in registers, E split into parts.
//
// Both kernels recompute a [32 rows, 32 vocab] logits tile over the whole E,
// turn it into dlogits and add its product into an accumulator that spans
// one E part: dx [32 rows, part] or dw [part, 32 columns]. Each of the 8
// warps holds NCP 16x16 f32 fragments, one per 64-wide E chunk of the part
// (NCP a template parameter, 1..16; a part has np <= NCP chunks), so every
// loop over them is unrolled. Shared memory holds whole tiles: the x rows
// and the [32 v, E] head tile(s) in dx; the block's head tile and the x row
// tile(s) in dw. A second stage (the next tile loading while the current
// one is used) is taken when it fits. The int8 flavour adds the bf16 tile
// the product needs: bf16(wq·sw) of the part in dx, the bf16 x rows of the
// part in dw.
#pragma once

namespace fce {

constexpr int T32 = 32;            // rows (dx) or vocab columns (dw) per block
constexpr int LDL = T32 + 4;       // logits partials (f32 or int32)
constexpr int LDD = T32 + 8;       // bf16 dlogits

// Shared memory of a dx or dw block: offsets computed from E, the part
// width EP and the stage count, on the host and in the kernel alike.
template <bool INT8>
struct WideLayout {
  int ldx, ldw, ldb;   // row strides: x tile, head tile (elements), bf16 part tile
  size_t xt, wt, bt, part, dg, cols, total;
  __host__ __device__ WideLayout(bool ve, bool dx, int E, int EP, int stages) {
    const size_t esz = INT8 ? 1 : sizeof(bf16);
    ldx = INT8 ? E + 16 : E + 8;
    ldw = ve ? ldx : T32 + 8;
    ldb = EP + 8;
    xt = align128(esz * T32 * ldx);
    wt = align128(esz * (ve ? T32 : E) * ldw);
    bt = INT8 ? align128(sizeof(bf16) * T32 * ldb) : 0;
    part = align128(sizeof(float) * 2 * T32 * LDL);
    dg = align128(sizeof(bf16) * T32 * LDD);
    cols = align128(sizeof(float) * T32) * 5;   // lse, wtok, tgt, sx, sw
    // dx: x tile, stages x head tile, bf16 head part; dw: head tile, stages x
    // (x tile, bf16 x part); then the partials, dlogits and row columns
    total = (dx ? xt + stages * wt + bt : wt + stages * (xt + bt)) + part + dg + cols;
  }
};

// a whole-E head tile of 32 vocab columns into shared memory: VE storage
// gives W[v][e] (row stride ldw), EV storage (bf16 only) W[e][v]
template <typename T, bool VE>
__device__ __forceinline__ void load_head_async(T* W, int ldw, const T* w, long long swe,
                                                long long swv, int v0, int V, int E) {
  constexpr int PER = 16 / sizeof(T);
  if (VE) {
    for (int i = threadIdx.x; i < T32 * (E / PER); i += NT) {
      const int r = i / (E / PER), c = (i % (E / PER)) * PER;
      const bool in = v0 + r < V;
      cp_async16(W + r * ldw + c, in ? w + (v0 + r) * swv + c : w, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < E * (T32 / PER); i += NT) {
      const int r = i / (T32 / PER), c = (i % (T32 / PER)) * PER;
      const int n = min(PER, V - (v0 + c));
      cp_async16(W + r * ldw + c, n > 0 ? w + r * swe + v0 + c : w,
                 n > 0 ? static_cast<int>(sizeof(T)) * n : 0);
    }
  }
}

// logits partial of this warp over the whole E: split-K over the two warp
// halves (half h takes the E chunks, or the k32 steps, of parity h) for the
// 16x16 block f = warp % 4 of the [32, 32] tile; stored to its half of the
// partials buffer (f32 in the bf16 flavour, exact int32 in the int8 one)
template <bool VE, int EF>
__device__ __forceinline__ void logits_partial(float* part, const bf16* X, int ldx, const bf16* W,
                                               int ldw, int E) {
  const int warp = threadIdx.x / 32, f = warp % 4, half = warp / 4;
  const int r0 = (f / 2) * 16, c0 = (f % 2) * 16;
  using LB = std::conditional_t<VE, wmma::col_major, wmma::row_major>;
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  auto chunk = [&](int c) {
#pragma unroll
    for (int kk = 0; kk < EC; kk += 16) {
      const int e = c * EC + kk;
      FragA fa;
      FragB<LB> fb;
      wmma::load_matrix_sync(fa, X + r0 * ldx + e, ldx);
      wmma::load_matrix_sync(fb, VE ? W + c0 * ldw + e : W + e * ldw + c0, ldw);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  };
  if constexpr (EF > 0) {   // E fixed at compile time: every chunk unrolled
#pragma unroll
    for (int c = 0; c < EF / EC; ++c)
      if (c % 2 == half) chunk(c);
  } else {
    for (int c = half; c < E / EC; c += 2) chunk(c);
  }
  wmma::store_matrix_sync(part + half * T32 * LDL + r0 * LDL + c0, acc, LDL, wmma::mem_row_major);
}

__device__ __forceinline__ void logits_partial_s8(int* part, const int8_t* X, int ldx,
                                                  const int8_t* W, int ldw, int E) {
  const int warp = threadIdx.x / 32, f = warp % 4, half = warp / 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = (f / 2) * 16, n0 = (f % 2) * 16;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int k = half * 32; k < E; k += 64) {
    uint32_t a[4];
    load_a_s8(a, X, ldx, r0, k);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t b0, b1;
      load_b_s8(b0, b1, W, ldw, n0 + n * 8, k);
      mma_s8(acc[n], a, b0, b1);
    }
  }
  int* P = part + half * T32 * LDL;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      P[(r0 + g + (i < 2 ? 0 : 8)) * LDL + n0 + n * 8 + 2 * tq + (i & 1)] = acc[n][i];
}

// dlogits of the [32, 32] tile from the two logits partials; INT8: the
// logits are (int32 sum · sx[row]) · sw[column]
template <bool INT8>
__device__ __forceinline__ void dlogits32(bf16* Dg, const void* partv, const float* lse,
                                          const float* wtok, const int* tgt, const float* sxr,
                                          const float* swc, int r0, int v0, int m, int V) {
  for (int i = threadIdx.x; i < T32 * T32; i += NT) {
    const int r = i / T32, c = i % T32;
    float d = 0.f;
    if (r0 + r < m && v0 + c < V) {
      float l;
      if constexpr (INT8) {
        const int* part = static_cast<const int*>(partv);
        const int s = part[r * LDL + c] + part[T32 * LDL + r * LDL + c];
        l = __fmul_rn(__fmul_rn(static_cast<float>(s), sxr[r]), swc[c]);
      } else {
        const float* part = static_cast<const float*>(partv);
        l = part[r * LDL + c] + part[T32 * LDL + r * LDL + c];
      }
      const float p = expf(l - lse[r]);
      d = (v0 + c == tgt[r] ? p - 1.f : p) * wtok[r];
    }
    Dg[r * LDD + c] = __float2bfloat16(d);
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

// wait for the current tile: with two stages the next one stays in flight
__device__ __forceinline__ void wait_stages(int stages) {
  if (stages == 2)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// dx: block = (32 rows, vocab split, E part). INT8: x = xq, w = wq ([V, E]
// storage, row stride swv), sx / sw their scales.
template <bool INT8, bool VE, int NCP, int EF>
__global__ void __launch_bounds__(NT)
    fce_dx_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const int* __restrict__ tgt, const float* __restrict__ lse,
                  const float* __restrict__ wtok, bf16* __restrict__ dx, float* __restrict__ ws,
                  int m, int E_run, int V, long long swe, long long swv, int tiles_per_split,
                  int ncp, int stages_run) {
  // EF: E fixed at compile time (one part, whose chunks are all NCP; the
  // bf16 [V, E] head then always takes two stages)
  const int E = EF > 0 ? EF : E_run;
  const int stages = EF > 0 && VE && !INT8 ? 2 : stages_run;
  using T = std::conditional_t<INT8, int8_t, bf16>;
  const WideLayout<INT8> LY(VE, true, E, ncp * EC, stages);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  unsigned char* wbase = smem + LY.xt;
  bf16* Wd = reinterpret_cast<bf16*>(wbase + stages * LY.wt);   // INT8: bf16(wq·sw) of the part
  unsigned char* rest = wbase + stages * LY.wt + LY.bt;
  void* Part = rest;
  bf16* Dg = reinterpret_cast<bf16*>(rest + LY.part);
  float* Ls = reinterpret_cast<float*>(rest + LY.part + LY.dg);   // 32-float columns
  float* Wt = Ls + T32;
  int* Tg = reinterpret_cast<int*>(Wt + T32);
  float* Sxs = reinterpret_cast<float*>(Tg + T32);
  float* Swc = Sxs + T32;
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);

  const int r0 = blockIdx.x * T32;
  const int split = blockIdx.y;
  const int c0 = EF > 0 ? 0 : blockIdx.z * ncp;   // this block's E chunks
  const int np = EF > 0 ? NCP : min(ncp, E / EC - c0);
  const int n_tiles = (V + T32 - 1) / T32;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 4) * 16, ac = (warp % 4) * 16;   // accumulator block
  auto wtile = [&](int t) { return reinterpret_cast<T*>(wbase + ((t - t_begin) % stages) * LY.wt); };
  auto prefetch = [&](int t) {
    if (t < t_end) load_head_async<T, VE>(wtile(t), LY.ldw, w, swe, swv, t * T32, V, E);
    cp_async_commit();
  };

  load_rows_async<T32>(Xs, LY.ldx, x, E, r0, 0, E, m);
  cp_async_commit();
  for (int i = threadIdx.x; i < T32; i += NT) {
    const bool in = r0 + i < m;
    Ls[i] = in ? lse[r0 + i] : 0.f;
    Wt[i] = in ? wtok[r0 + i] : 0.f;
    Tg[i] = in ? tgt[r0 + i] : -1;
    if (INT8) Sxs[i] = in ? sx[r0 + i] : 0.f;
  }
  for (int t = t_begin; t < t_begin + stages - 1; ++t) prefetch(t);

  FragC acc[NCP];
#pragma unroll
  for (int c = 0; c < NCP; ++c) wmma::fill_fragment(acc[c], 0.f);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();   // everyone is done with tile t - 1 and its slot
    prefetch(t + stages - 1);
    const int v0 = t * T32;
    if (INT8)
      for (int i = threadIdx.x; i < T32; i += NT) Swc[i] = v0 + i < V ? sw[v0 + i] : 0.f;
    wait_stages(stages);
    __syncthreads();   // tile t (and the x rows) landed
    const T* W = wtile(t);
    if constexpr (INT8) {
      logits_partial_s8(static_cast<int*>(Part), Xs, LY.ldx, W, LY.ldw, E);
      // bf16(wq · sw) of this part, zero past V (_dx_kernel's wt): a warp
      // per vocab row, 8 codes a lane per step
      const int EPn = np * EC, lane = threadIdx.x % 32;
      for (int v = warp; v < T32; v += NT / 32) {
        const float s = Swc[v];
        const int8_t* src = W + v * LY.ldw + c0 * EC;
        bf16* dst = Wd + v * LY.ldb;
        for (int e = lane * 8; e < EPn; e += 256) {
          const uint2 u = *reinterpret_cast<const uint2*>(src + e);
          const int8_t* b = reinterpret_cast<const int8_t*>(&u);
          __align__(16) __nv_bfloat162 o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            o[k] = __floats2bfloat162_rn(__fmul_rn(static_cast<float>(b[2 * k]), s),
                                         __fmul_rn(static_cast<float>(b[2 * k + 1]), s));
          *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(o);
        }
      }
    } else {
      logits_partial<VE, EF>(static_cast<float*>(Part), Xs, LY.ldx, W, LY.ldw, E);
    }
    __syncthreads();
    dlogits32<INT8>(Dg, Part, Ls, Wt, Tg, Sxs, Swc, r0, v0, m, V);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NCP; ++c) {   // dx[:, chunk] += dlogits · w[chunk, tile]ᵀ
      if (c >= np) break;
#pragma unroll
      for (int kk = 0; kk < T32; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, Dg + ar * LDD + kk, LDD);
        if constexpr (INT8) {
          FragB<wmma::row_major> fb;   // B(k = v, n = e) = Wd[v][e]
          wmma::load_matrix_sync(fb, Wd + kk * LY.ldb + c * EC + ac, LY.ldb);
          wmma::mma_sync(acc[c], fa, fb, acc[c]);
        } else {
          using DxB = std::conditional_t<VE, wmma::row_major, wmma::col_major>;
          const int e = (c0 + c) * EC + ac;
          FragB<DxB> fb;
          wmma::load_matrix_sync(fb, VE ? W + kk * LY.ldw + e : W + e * LY.ldw + kk, LY.ldw);
          wmma::mma_sync(acc[c], fa, fb, acc[c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* scratch = static_cast<float*>(Part) + warp * 256;   // the partials buffer, reused
  const int rows = min(16, m - (r0 + ar));
#pragma unroll
  for (int c = 0; c < NCP; ++c) {
    if (c >= np) break;
    const long long at = static_cast<long long>(r0 + ar) * E + (c0 + c) * EC + ac;
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

// dw: block = (32 vocab columns, E part); the head tile stays resident, x
// tiles of 32 rows stream through (double-buffered when they fit), each used
// for the logits and the x[:, part]ᵀ·dlogits product. INT8: xq / wq feed the
// logits, the bf16 x the product.
template <bool INT8, bool VE, int NCP, int EF>
__global__ void __launch_bounds__(NT)
    fce_dw_kernel(const bf16* __restrict__ x, const void* __restrict__ xlv,
                  const void* __restrict__ wv, const float* __restrict__ sx,
                  const float* __restrict__ sw, const int* __restrict__ tgt,
                  const float* __restrict__ lse, const float* __restrict__ wtok,
                  bf16* __restrict__ dw, int m, int E_run, int V, long long swe, long long swv,
                  long long sde, long long sdv, int ncp, int stages_run) {
  // EF: E fixed at compile time (one part, whose chunks are all NCP; the
  // bf16 [V, E] head then always takes two stages)
  const int E = EF > 0 ? EF : E_run;
  const int stages = EF > 0 && VE && !INT8 ? 2 : stages_run;
  using T = std::conditional_t<INT8, int8_t, bf16>;
  const WideLayout<INT8> LY(VE, false, E, ncp * EC, stages);
  extern __shared__ __align__(128) unsigned char smem[];
  T* W = reinterpret_cast<T*>(smem);
  unsigned char* xbase = smem + LY.wt;
  unsigned char* rest = xbase + stages * (LY.xt + LY.bt);
  void* Part = rest;
  bf16* Dg = reinterpret_cast<bf16*>(rest + LY.part);
  float* Ls = reinterpret_cast<float*>(rest + LY.part + LY.dg);   // 32-float columns
  float* Wt = Ls + T32;
  int* Tg = reinterpret_cast<int*>(Wt + T32);
  float* Sxs = reinterpret_cast<float*>(Tg + T32);
  float* Swc = Sxs + T32;
  const T* xl = static_cast<const T*>(xlv);   // the logits operand: x or xq
  const T* w = static_cast<const T*>(wv);

  const int v0 = blockIdx.x * T32;
  const int c0 = EF > 0 ? 0 : blockIdx.y * ncp;
  const int np = EF > 0 ? NCP : min(ncp, E / EC - c0);
  const int n_mt = (m + T32 - 1) / T32;
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 2) * 16, ac = (warp % 2) * 16;   // accumulator block
  auto xtile = [&](int mt) { return reinterpret_cast<T*>(xbase + (mt % stages) * (LY.xt + LY.bt)); };
  auto btile = [&](int mt) {   // INT8: the bf16 x rows of the part
    return reinterpret_cast<bf16*>(xbase + (mt % stages) * (LY.xt + LY.bt) + LY.xt);
  };
  auto prefetch = [&](int mt) {
    if (mt < n_mt) {
      load_rows_async<T32>(xtile(mt), LY.ldx, xl, E, mt * T32, 0, E, m);
      if (INT8) load_rows_async<T32>(btile(mt), LY.ldb, x, E, mt * T32, c0 * EC, np * EC, m);
    }
    cp_async_commit();
  };

  load_head_async<T, VE>(W, LY.ldw, w, swe, swv, v0, V, E);
  cp_async_commit();
  for (int i = threadIdx.x; i < T32; i += NT) Swc[i] = INT8 && v0 + i < V ? sw[v0 + i] : 0.f;
  for (int mt = 0; mt < stages - 1; ++mt) prefetch(mt);

  FragC acc[NCP];
#pragma unroll
  for (int c = 0; c < NCP; ++c) wmma::fill_fragment(acc[c], 0.f);
  for (int mt = 0; mt < n_mt; ++mt) {
    const int r0 = mt * T32;
    __syncthreads();   // everyone is done with x tile mt - 1 and its slot
    prefetch(mt + stages - 1);
    wait_stages(stages);
    for (int i = threadIdx.x; i < T32; i += NT) {
      const bool in = r0 + i < m;
      Ls[i] = in ? lse[r0 + i] : 0.f;
      Wt[i] = in ? wtok[r0 + i] : 0.f;
      Tg[i] = in ? tgt[r0 + i] : -1;
      if (INT8) Sxs[i] = in ? sx[r0 + i] : 0.f;
    }
    __syncthreads();   // x tile mt (and the head tile) landed
    const T* X = xtile(mt);
    if constexpr (INT8)
      logits_partial_s8(static_cast<int*>(Part), X, LY.ldx, W, LY.ldw, E);
    else
      logits_partial<VE, EF>(static_cast<float*>(Part), X, LY.ldx, W, LY.ldw, E);
    __syncthreads();
    dlogits32<INT8>(Dg, Part, Ls, Wt, Tg, Sxs, Swc, r0, v0, m, V);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NCP; ++c) {   // dw[chunk, cols] += x[rows, chunk]ᵀ · dlogits
      if (c >= np) break;
#pragma unroll
      for (int kk = 0; kk < T32; kk += 16) {
        FragAc fa;   // A(e, r) = x[r][e]: column-major view of the bf16 x rows
        if constexpr (INT8)
          wmma::load_matrix_sync(fa, btile(mt) + kk * LY.ldb + c * EC + ar, LY.ldb);
        else
          wmma::load_matrix_sync(fa, X + kk * LY.ldx + (c0 + c) * EC + ar, LY.ldx);
        FragB<wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Dg + kk * LDD + ac, LDD);
        wmma::mma_sync(acc[c], fa, fb, acc[c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* scratch = static_cast<float*>(Part) + warp * 256;   // the partials buffer, reused
  const int cols = min(16, V - (v0 + ac));
#pragma unroll
  for (int c = 0; c < NCP; ++c) {
    if (c >= np) break;
    write_fragment(acc[c], scratch, dw + ((c0 + c) * EC + ar) * sde + (v0 + ac) * sdv, sde, sdv,
                   16, cols);
  }
}

// the stage count that fits (2 if it does, else 1; 0 if neither)
template <bool INT8>
inline int stages_for(bool ve, bool dx, int E, int EP) {
  if (WideLayout<INT8>(ve, dx, E, EP, 2).total <= SMEM_MAX) return 2;
  return WideLayout<INT8>(ve, dx, E, EP, 1).total <= SMEM_MAX ? 1 : 0;
}

// one part (E <= 1024): E = 64·NCP fixed at compile time; two parts (E
// 1088..1280): E at run time, 9 or 10 chunks a part
#define KOIFISH_NCP_CASES(F)                                                                  \
  F(1, 64) F(2, 128) F(3, 192) F(4, 256) F(5, 320) F(6, 384) F(7, 448) F(8, 512) F(9, 576)    \
  F(10, 640) F(11, 704) F(12, 768) F(13, 832) F(14, 896) F(15, 960) F(16, 1024)               \
  F(9, 0) F(10, 0)

template <bool INT8, bool VE>
cudaError_t launch_dx(const void* x, const void* w, const float* sx, const float* sw,
                      const void* tgt, const void* lse, const void* wtok, void* dx, void* ws,
                      int m, int E, int V, long long swe, long long swv, cudaStream_t st) {
  const int row_tiles = (m + T32 - 1) / T32, n_tiles = (V + T32 - 1) / T32;
  const int splits = splits_for(row_tiles, n_tiles);
  if ((splits > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  const int per = (n_tiles + splits - 1) / splits;
  int parts, ncp;
  parts_for(E, parts, ncp);
  const int stages = stages_for<INT8>(VE, true, E, ncp * EC);
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t bytes = WideLayout<INT8>(VE, true, E, ncp * EC, stages).total;
  const dim3 grid(row_tiles, splits, parts);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  const int key = parts == 1 ? ncp * 1000 + ncp * EC : ncp * 1000;
  switch (key) {
#define KOIFISH_DX_CASE(n, ef)                                                              \
  case n * 1000 + ef:                                                                       \
    if ((err = prepare(fce_dx_kernel<INT8, VE, n, ef>, bytes)) != cudaSuccess) return err;  \
    fce_dx_kernel<INT8, VE, n, ef><<<grid, NT, bytes, st>>>(                                \
        x, w, sx, sw, static_cast<const int*>(tgt), static_cast<const float*>(lse),         \
        static_cast<const float*>(wtok), static_cast<bf16*>(dx), wsf, m, E, V, swe, swv,    \
        per, ncp, stages);                                                                  \
    err = cudaGetLastError();                                                               \
    break;
    KOIFISH_NCP_CASES(KOIFISH_DX_CASE)
#undef KOIFISH_DX_CASE
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(m) * E;
  fce_dx_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      wsf, static_cast<bf16*>(dx), n, splits);
  return cudaGetLastError();
}

template <bool INT8, bool VE>
cudaError_t launch_dw(const void* x, const void* xl, const void* w, const float* sx,
                      const float* sw, const void* tgt, const void* lse, const void* wtok,
                      void* dw, int m, int E, int V, long long swe, long long swv, long long sde,
                      long long sdv, cudaStream_t st) {
  int parts, ncp;
  parts_for(E, parts, ncp);
  const int stages = stages_for<INT8>(VE, false, E, ncp * EC);
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t bytes = WideLayout<INT8>(VE, false, E, ncp * EC, stages).total;
  const dim3 grid((V + T32 - 1) / T32, parts);
  cudaError_t err = cudaErrorInvalidValue;
  const int key = parts == 1 ? ncp * 1000 + ncp * EC : ncp * 1000;
  switch (key) {
#define KOIFISH_DW_CASE(n, ef)                                                              \
  case n * 1000 + ef:                                                                       \
    if ((err = prepare(fce_dw_kernel<INT8, VE, n, ef>, bytes)) != cudaSuccess) return err;  \
    fce_dw_kernel<INT8, VE, n, ef><<<grid, NT, bytes, st>>>(                                \
        static_cast<const bf16*>(x), xl, w, sx, sw, static_cast<const int*>(tgt),           \
        static_cast<const float*>(lse), static_cast<const float*>(wtok),                    \
        static_cast<bf16*>(dw), m, E, V, swe, swv, sde, sdv, ncp, stages);                  \
    err = cudaGetLastError();                                                               \
    break;
    KOIFISH_NCP_CASES(KOIFISH_DW_CASE)
#undef KOIFISH_DW_CASE
  }
  return err;
}

}  // namespace fce
