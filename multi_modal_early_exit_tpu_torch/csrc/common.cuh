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

// bf16 tensor-core helpers shared by the attention kernels

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// ---------------------------------------------------------------------------
// f32 operands on the tensor cores by 3xTF32: x = hi + lo with hi = tf32(x)
// and lo = tf32(x - hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with f32
// accumulation; the dropped a_lo b_lo is about 2^-22 of the product, so the
// result is good to about f32's precision (plain TF32 keeps ~3 digits).
// mma.sync m16n8k8 fragments (g = lane / 4, t = lane % 4): A a0 (row g,
// k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g),
// b1 (k t + 4, n g); the accumulator as m16n8k16's: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the four A values of one k step, split
__device__ __forceinline__ void split_frag(const float (&a)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (4 accumulators) += A B for one k step of f32 operands: A split by the
// caller, B's two values split here
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32_1688(d, alo, h0, h1);
  mma_tf32_1688(d, ahi, l0, l1);
  mma_tf32_1688(d, ahi, h0, h1);
}

// f32 [row][d] shared tiles have a pitch of 68 floats (272 B): every
// fragment load below hits 32 distinct banks
constexpr int kLD32 = 68;

// this warp's 16 rows (from wr) of a [row][d] f32 tile as raw A values of
// 8 k steps over d
__device__ __forceinline__ void load_a_frags(float (&a)[8][4], const float* tile, int wr, int g,
                                             int t) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const float* p = &tile[(wr + g) * kLD32 + ks * 8 + t];
    a[ks][0] = p[0];
    a[ks][1] = p[8 * kLD32];
    a[ks][2] = p[4];
    a[ks][3] = p[8 * kLD32 + 4];
  }
}

// acc[nt] (16 x 64) = A (16 x 64 over d) times tile^T, tile [col][d] f32
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[8][4], const float (&a)[8][4],
                                                 const float* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t hi[4], lo[4];
    split_frag(a[ks], hi, lo);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* p = &tile[(nt * 8 + g) * kLD32 + ks * 8 + t];
      mma_3xtf32(acc[nt], hi, lo, p[0], p[4]);
    }
  }
}

// out[dt] (16 x 64 over d) += X (16 x 64 over columns, f32 accumulators, not
// rounded) times tile, tile [column][d] f32. The sum over columns is taken
// in a permuted order: k step ks's logical k t and t + 4 are columns
// 8 ks + 2t and 8 ks + 2t + 1, which this thread's accumulators already
// hold, so no shuffle is needed, and B reads the tile's rows 8 ks + 2t, +1.
__device__ __forceinline__ void mma_acc_by_rows(float (&out)[8][4], const float (&x)[8][4],
                                                const float* tile, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const float a[4] = {x[ks][0], x[ks][2], x[ks][1], x[ks][3]};
    uint32_t hi[4], lo[4];
    split_frag(a, hi, lo);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const float* p = &tile[(ks * 8 + 2 * t) * kLD32 + dt * 8 + g];
      mma_3xtf32(out[dt], hi, lo, p[0], p[kLD32]);
    }
  }
}
