// Absmax int8 quantization of the lines of a 2-D tensor, for Hopper.
//
// Replaces the Pallas kernels of koifish_tpu/ops/pallas/quantize.py: rowquant
// (:45, call :53) and colquant (:93, calls :101 and :112), and performs the
// int8 training quantizers the JAX package leaves to XLA
// (ops/int8_train.py:46-59 _rowwise_q8 / _colwise_q8; the fused CE's
// _q8_row and column quantizer, ops/pallas/fused_ce.py:362-385). The three
// rounding conventions are in int8.cuh.
//
// The kernels see the tensor as its storage: R rows of C contiguous
// elements (row stride ld), bf16 or f32, and write int8 codes in the same
// layout, so a transposed view (the tied head wte.T) is quantized in place
// with no transposed copy:
//   quant_rows: one scale per storage row. A warp owns a row: an absmax
//     pass and a quantize pass over its C elements, 16-byte loads.
//   quant_cols: one scale per storage column. Pass 1: a block of 256
//     threads takes 256 columns x 256 rows and writes the partial column
//     maxima to a [chunks, C] workspace; pass 2: each thread merges its
//     column's partials in chunk order (no atomics), then quantizes its
//     column over its 256-row chunk.
//
// What bounds them on the H100: bytes. Each input element is read twice
// (once per pass; the second read mostly hits L2) and one code byte written:
// 3 bytes per bf16 element of traffic, against 1 read and 1 write at the
// bound. x [16384, 1280] bf16: 0.019 ms at 3.35 TB/s.
#include "int8.cuh"

namespace {

constexpr int NT = 256;
constexpr int CHUNK = 256;   // rows per block of the column kernels

template <typename T>
struct Vec;
template <>
struct Vec<bf16> {   // 8 bf16 per 16 bytes
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {  // 4 f32 per 16 bytes
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// one warp per storage row; C % Vec::N == 0 and 16-byte aligned rows
template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
    quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                      int R, int C, long long ldx, long long ldq) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (r >= R) return;
  const T* xr = x + r * ldx;
  float a = 0.f;
  for (int c = lane * N; c < C; c += 32 * N) {
    float v[N];
    V::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) a = fmaxf(a, fabsf(v[i]));
  }
  const Q8 s = q8_scale<MODE>(warp_max(a));
  int8_t* qr = q + r * ldq;
  for (int c = lane * N; c < C; c += 32 * N) {
    float v[N];
    V::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<uint32_t*>(qr + c + i) =
          pack4(q8_code<MODE>(v[i], s), q8_code<MODE>(v[i + 1], s), q8_code<MODE>(v[i + 2], s),
                q8_code<MODE>(v[i + 3], s));
  }
  if (lane == 0) scale[r] = s.scale;
}

// pass 1: partial maxima of |x| of 256 columns over a 256-row chunk
template <typename T>
__global__ void __launch_bounds__(NT)
    col_absmax_kernel(const T* __restrict__ x, float* __restrict__ ws, int R, int C,
                      long long ldx) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * CHUNK, r1 = min(R, r0 + CHUNK);
  float a = 0.f;
  for (int r = r0; r < r1; ++r) a = fmaxf(a, fabsf(to_f(x[r * ldx + c])));
  ws[static_cast<long long>(blockIdx.y) * C + c] = a;
}

// pass 2: merge the column's partials in chunk order, quantize the chunk
template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
    col_quant_kernel(const T* __restrict__ x, const float* __restrict__ ws,
                     int8_t* __restrict__ q, float* __restrict__ scale, int R, int C,
                     long long ldx, long long ldq, int chunks) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  float a = 0.f;
  for (int k = 0; k < chunks; ++k) a = fmaxf(a, ws[static_cast<long long>(k) * C + c]);
  const Q8 s = q8_scale<MODE>(a);
  if (blockIdx.y == 0) scale[c] = s.scale;
  const int r0 = blockIdx.y * CHUNK, r1 = min(R, r0 + CHUNK);
  for (int r = r0; r < r1; ++r)
    q[r * ldq + c] = static_cast<int8_t>(q8_code<MODE>(to_f(x[r * ldx + c]), s));
}

template <typename T>
cudaError_t launch_rows(const void* x, void* q, void* scale, int R, int C, long long ldx,
                        long long ldq, int mode, cudaStream_t st) {
  const dim3 grid((R + NT / 32 - 1) / (NT / 32));
  auto xx = static_cast<const T*>(x);
  auto qq = static_cast<int8_t*>(q);
  auto ss = static_cast<float*>(scale);
  if (mode == PALLAS)
    quant_rows_kernel<T, PALLAS><<<grid, NT, 0, st>>>(xx, qq, ss, R, C, ldx, ldq);
  else if (mode == JIT)
    quant_rows_kernel<T, JIT><<<grid, NT, 0, st>>>(xx, qq, ss, R, C, ldx, ldq);
  else
    quant_rows_kernel<T, EAGER><<<grid, NT, 0, st>>>(xx, qq, ss, R, C, ldx, ldq);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const void* x, void* q, void* scale, void* ws, int R, int C,
                        long long ldx, long long ldq, int mode, cudaStream_t st) {
  const int chunks = (R + CHUNK - 1) / CHUNK;
  const dim3 grid((C + NT - 1) / NT, chunks);
  auto xx = static_cast<const T*>(x);
  auto qq = static_cast<int8_t*>(q);
  auto ss = static_cast<float*>(scale);
  auto ww = static_cast<float*>(ws);
  col_absmax_kernel<T><<<grid, NT, 0, st>>>(xx, ww, R, C, ldx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (mode == PALLAS)
    col_quant_kernel<T, PALLAS><<<grid, NT, 0, st>>>(xx, ww, qq, ss, R, C, ldx, ldq, chunks);
  else if (mode == JIT)
    col_quant_kernel<T, JIT><<<grid, NT, 0, st>>>(xx, ww, qq, ss, R, C, ldx, ldq, chunks);
  else
    col_quant_kernel<T, EAGER><<<grid, NT, 0, st>>>(xx, ww, qq, ss, R, C, ldx, ldq, chunks);
  return cudaGetLastError();
}

bool bad(int R, int C, int dtype, int mode) {
  return R < 1 || C < 1 || dtype < 0 || dtype > 1 || mode < PALLAS || mode > EAGER;
}

}  // namespace

// rows of the [chunks, C] f32 workspace the column kernels need for R rows
KOIFISH_API int koifish_quant_cols_chunks(int R) { return (R + CHUNK - 1) / CHUNK; }

// one scale per storage row of x (dtype 0 bf16, 1 f32); C a multiple of 8
// (bf16) or 4 (f32), rows 16-byte aligned
KOIFISH_API int koifish_quant_rows(const void* x, void* q, void* scale, int R, int C,
                                   long long ldx, long long ldq, int dtype, int mode,
                                   void* stream) {
  if (bad(R, C, dtype, mode) || C % (dtype == 0 ? 8 : 4) != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows<bf16>(x, q, scale, R, C, ldx, ldq, mode, st)
                    : launch_rows<float>(x, q, scale, R, C, ldx, ldq, mode, st);
}

// one scale per storage column of x; ws is [koifish_quant_cols_chunks(R), C] f32
KOIFISH_API int koifish_quant_cols(const void* x, void* q, void* scale, void* ws, int R, int C,
                                   long long ldx, long long ldq, int dtype, int mode,
                                   void* stream) {
  if (bad(R, C, dtype, mode)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_cols<bf16>(x, q, scale, ws, R, C, ldx, ldq, mode, st)
                    : launch_cols<float>(x, q, scale, ws, R, C, ldx, ldq, mode, st);
}
