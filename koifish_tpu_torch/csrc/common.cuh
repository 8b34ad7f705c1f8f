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

// cp.async: a 16-byte global -> shared copy that does not pass through
// registers; src_bytes < 16 zero-fills the rest (0 = all zero, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
