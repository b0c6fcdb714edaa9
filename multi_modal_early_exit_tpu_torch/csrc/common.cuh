// Shared by every kernel library of the port. Each .cu file is compiled
// into its own shared library with a plain C interface (loaded through
// ctypes); every launcher returns cudaGetLastError() as an int, and
// mmee_error_string turns that code into CUDA's message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// codes from this value up are a failed TMA tensor-map encode (sm90.cuh):
// the value plus the driver's CUresult
#define MMEE_TENSOR_MAP_ERROR 10000

extern "C" const char* mmee_error_string(int code) {
  if (code >= MMEE_TENSOR_MAP_ERROR) {
    return "cuTensorMapEncodeTiled failed (the code less 10000 is the driver's CUresult)";
  }
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

// operands of type T are f32 (else bf16)
template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

template <typename T>
__device__ __forceinline__ float mmee_round(float x) {  // x rounded to T and back
  return mmee_to_float(mmee_from_float<T>(x));
}

// bf16 helpers shared by the kernels

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two adjacent outputs, as bf16 or f32
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// d += a * b for one m16n8k16 tile: a is 16x16 row-major (4 regs), b is
// 16x8 column-major (2 regs), d is 16x8 f32 (4 regs).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
