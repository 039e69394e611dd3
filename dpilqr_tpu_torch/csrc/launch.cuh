// Helpers shared by the kernels that size their dynamic shared memory at
// launch (the three backward kernels and forward_batched.cu): the device's
// opt-in limit their plans (plan.h) are made under, the launch itself, and
// the CTA-wide asynchronous copy into shared memory.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "plan.h"

namespace {

// The shared memory a block may opt into on the current device, or -1.
inline long long max_shared_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// Opt the kernel into `bytes` of dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, dim3 blocks, int threads, size_t bytes,
                     void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Asynchronous copy of n values by `nth` threads of which this is number
// `tid` (default: the whole CTA): 16 bytes a request where both ends are
// 16-byte aligned and n fills whole requests, else one value.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n, int tid,
                                           int nth) {
  constexpr int PER = 16 / sizeof(T);
  const bool wide =
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
      n % PER == 0;
  if (wide) {
    for (int i = tid * PER; i < n; i += nth * PER)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  } else {
    for (int i = tid; i < n; i += nth)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  }
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  copy_async(dst, src, n, (int)threadIdx.x, (int)blockDim.x);
}

}  // namespace
