// Shared helpers of the koifish_tpu_torch CUDA kernels.
//
// Every library has a plain C interface (loaded with ctypes): a host entry
// that launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() as an int, plus koifish_error_string() to name it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define KOIFISH_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

KOIFISH_API const char* koifish_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation and byte count).
template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
