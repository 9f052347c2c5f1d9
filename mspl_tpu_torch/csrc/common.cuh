// Shared helpers of the mspl_tpu_torch CUDA kernels.
//
// Every source in this directory is compiled on its own into a shared
// library with a plain C interface (see ops/_cuda.py) for sm_90a.  Kernels
// launch on the stream the caller passes (PyTorch's current stream),
// allocate nothing, and each C entry point returns cudaGetLastError() after
// its launches so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
#define MSPL_F32 0
#define MSPL_BF16 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float prelu(float x, float alpha) {
  // max(x, 0) + alpha * min(x, 0), as the reference writes it
  return fmaxf(x, 0.f) + alpha * fminf(x, 0.f);
}

static inline unsigned int mspl_blocks(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

extern "C" const char* mspl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
