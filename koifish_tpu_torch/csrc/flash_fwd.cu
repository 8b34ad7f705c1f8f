// Flash attention forward (causal, optional sliding window, GQA) for Hopper.
//
// Replaces the Pallas forward kernels of koifish_tpu/ops/pallas/flash.py:
// _fwd_cols_single/_fwd_cols_single_kernel (:844/:868),
// _flash_cols_fwd_call/_fwd_cols_kernel (:732/:773),
// _flash_fwd_call/_fwd_kernel (:194/:234) and
// _fwd_single/_fwd_single_kernel (:283/:318). The column and head-major
// layouts differ only in strides, so one kernel takes q [B,T,Hq,D] and
// k/v [B,T,Hkv,D] through their strides (unit stride on D).
//
// What bounds it on the H100: at the serving prefill (T = 128, D = 128)
// each q row meets at most 128 keys, so the work is ~2·2·T²/2·D flops per
// head against 4·T·D·2 bytes moved — about 64 flops per byte, under the
// card's ~295 bf16 flops/byte ridge, so bytes bound it in principle; in
// this simple kernel the shared-memory round trips of S, P and O bound it.
// Design: one block of 4 warps per (q tile of 64 rows, q head, batch); the
// kv head is h / g, so K/V are never repeated. K/V tiles of 64 rows are
// staged in shared memory; Q·Kᵀ and P·V run on the tensor cores (WMMA,
// bf16 in, f32 accumulate); each warp owns 16 q rows of S, P and the f32
// output accumulator, so the online softmax needs only warp-level syncs.
// Tiles past the causal diagonal (and before the window) are skipped.
// Rounding follows the Pallas kernels: q scaled in f32 then rounded to
// bf16, p rounded to bf16 before PV, masked logits -1e30, l >= 1e-30.
#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // each warp owns 16 q rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

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
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T,
                   int Hq, int Hkv, long long qsb, long long qst, long long qsh, long long ksb,
                   long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                   float scale, int window, cudaStream_t stream) {
  static cudaError_t attr = set_smem(flash_fwd_kernel<D>, Layout<D>::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, Layout<D>::BYTES, stream>>>(
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
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
                        vsh, scale, window, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
                         vsh, scale, window, s);
    case 256:
      return launch<256>(q, k, v, o, lse, B, T, Hq, Hkv, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
                         vsh, scale, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
