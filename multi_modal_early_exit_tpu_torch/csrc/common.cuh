// Shared by every kernel library of the port. Each .cu file is compiled
// into its own shared library with a plain C interface (loaded through
// ctypes); every launcher returns cudaGetLastError() as an int, and
// mmee_error_string turns that code into CUDA's message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* mmee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float mmee_to_float(float x) { return x; }
__device__ __forceinline__ float mmee_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T mmee_from_float(float x);
template <>
__device__ __forceinline__ float mmee_from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 mmee_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
