// table_grads: the gradients of the three relative-position bias tables,
// the backward of materialize_bias.
//
//   dT1[r, h] = sum of g[b, h, i, j] over the (b, i, j), i, j < S, with
//               bkt1(pos_j - pos_i) = r;  dTx, dTy likewise with x0 / y1 and
//               the 2D buckets (the buckets of materialize_bias.cu).
//
// Replaces the TPU kernel `_table_grads_kernel` behind `_table_grads`
// (multi_modal_early_exit_tpu/ops/fused_bias_attention.py:362 and :438).
//
// Bound on an H100: the kernel must read the cotangent g once (B=16, H=12,
// P=768, bf16: 226.5 MB, 68 us at 3.35 TB/s); its outputs are (32 + 2*64) x
// 12 floats. The Pallas kernel turns the scatter into one-hot matmuls on
// the MXU; here it is a histogram in shared memory, (nb1 + 2*nb2) x H f32
// (7.5 KB at H=12), filled with shared-memory atomics:
//
// - one CTA per (16 rows i, batch b), 256 threads = 16 half-warps, one row
//   each; lane l of a half-warp owns head l (H <= 16), so the 16 lanes add
//   into one bucket row at 16 distinct heads and never collide;
// - a half-warp walks its row in chunks of 16 columns: each lane reads 16
//   consecutive g values of its head (32 bytes, one whole sector for bf16);
//   the three buckets of each (i, j) are the same for all lanes, computed
//   from the vectors and the bucket lookup tables staged in shared memory;
// - a lane keeps a running sum per table and adds it to the histogram only
//   when the bucket changes, which along a row of the 1D table (and of a
//   page's sorted y coordinates) is rare;
// - at the end each CTA adds its histogram to the zeroed f32 outputs with
//   global atomicAdd. Float atomics make the order of the sums, and so the
//   last bits, vary from run to run; the tests state the tolerance.
//
// Rows and columns at or beyond S (the true length) are skipped: the pad
// rows of the bias are finite and must not reach the tables.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 16;  // one row per half-warp
constexpr int kChunk = 16;            // columns per lane load

__device__ __forceinline__ void load16(float (&dst)[kChunk], const __nv_bfloat16* src) {
  const uint4 a = reinterpret_cast<const uint4*>(src)[0];
  const uint4 b = reinterpret_cast<const uint4*>(src)[1];
  const __nv_bfloat16* ea = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* eb = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = __bfloat162float(ea[e]);
    dst[8 + e] = __bfloat162float(eb[e]);
  }
}

__device__ __forceinline__ void load16(float (&dst)[kChunk], const float* src) {
#pragma unroll
  for (int e = 0; e < kChunk / 4; ++e) {
    const float4 a = reinterpret_cast<const float4*>(src)[e];
    dst[4 * e] = a.x;
    dst[4 * e + 1] = a.y;
    dst[4 * e + 2] = a.z;
    dst[4 * e + 3] = a.w;
  }
}

// a running (bucket, sum) of one lane for one table
struct Run {
  int bucket = -1;
  float sum = 0.0f;
  __device__ __forceinline__ void add(float* hist, int H, int h, int bkt, float x) {
    if (bkt != bucket) {
      if (bucket >= 0) atomicAdd(&hist[bucket * H + h], sum);
      bucket = bkt;
      sum = 0.0f;
    }
    sum += x;
  }
  __device__ __forceinline__ void flush(float* hist, int H, int h) {
    if (bucket >= 0) atomicAdd(&hist[bucket * H + h], sum);
  }
};

template <typename GT>
__global__ void __launch_bounds__(kThreads) table_grads_kernel(
    const int* __restrict__ pos, const int* __restrict__ cx,
    const int* __restrict__ cy,                              // (B, S)
    const int* __restrict__ lut1, const int* __restrict__ lut2,
    const GT* __restrict__ g,                                // (B, H, P, P)
    float* __restrict__ out,  // dT1 (nb1, H), then dTx, dTy (nb2, H), zeroed
    int S, int P, int H, int nb1, int nb2, int max1, int max2) {
  extern __shared__ float smem[];
  const int n_hist = (nb1 + 2 * nb2) * H;
  float* s_hist = smem;
  int* s_pos = reinterpret_cast<int*>(s_hist + n_hist);
  int* s_cx = s_pos + S;
  int* s_cy = s_cx + S;
  int* s_l1 = s_cy + S;
  int* s_l2 = s_l1 + (max1 + 1);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  for (int e = tid; e < n_hist; e += kThreads) s_hist[e] = 0.0f;
  for (int e = tid; e < S; e += kThreads) {
    s_pos[e] = pos[b * S + e];
    s_cx[e] = cx[b * S + e];
    s_cy[e] = cy[b * S + e];
  }
  for (int e = tid; e <= max1; e += kThreads) s_l1[e] = lut1[e];
  for (int e = tid; e <= max2; e += kThreads) s_l2[e] = lut2[e];
  __syncthreads();

  const int i = blockIdx.x * kRows + tid / 16;
  const int h = tid % 16;
  if (i < S && h < H) {
    float* hist1 = s_hist;
    float* histx = hist1 + nb1 * H;
    float* histy = histx + nb2 * H;
    const int half1 = nb1 / 2, half2 = nb2 / 2;
    const int pi = s_pos[i], xi = s_cx[i], yi = s_cy[i];
    const GT* grow = g + ((static_cast<size_t>(b) * H + h) * P + i) * static_cast<size_t>(P);
    Run r1, rx, ry;
    for (int j0 = 0; j0 < S; j0 += kChunk) {
      float x[kChunk];
      load16(x, grow + j0);  // j0 + 16 <= P: P is a multiple of 128, S <= P
      const int n = min(kChunk, S - j0);
      for (int e = 0; e < n; ++e) {
        const int j = j0 + e;
        const int d1 = s_pos[j] - pi, dx = s_cx[j] - xi, dy = s_cy[j] - yi;
        r1.add(hist1, H, h, (d1 > 0 ? half1 : 0) + s_l1[min(abs(d1), max1)], x[e]);
        rx.add(histx, H, h, (dx > 0 ? half2 : 0) + s_l2[min(abs(dx), max2)], x[e]);
        ry.add(histy, H, h, (dy > 0 ? half2 : 0) + s_l2[min(abs(dy), max2)], x[e]);
      }
    }
    r1.flush(hist1, H, h);
    rx.flush(histx, H, h);
    ry.flush(histy, H, h);
  }
  __syncthreads();
  for (int e = tid; e < n_hist; e += kThreads) {
    const float val = s_hist[e];
    if (val != 0.0f) atomicAdd(&out[e], val);
  }
}

}  // namespace

extern "C" int mmee_table_grads(const void* pos, const void* cx,
                                const void* cy, const void* lut1,
                                const void* lut2, const void* g, int g_is_bf16,
                                void* out, int B, int S, int P, int H, int nb1,
                                int nb2, int max1, int max2, void* stream) {
  const dim3 grid((S + kRows - 1) / kRows, B);
  const size_t smem = sizeof(float) * static_cast<size_t>(nb1 + 2 * nb2) * H +
                      sizeof(int) * (3 * static_cast<size_t>(S) + max1 + 1 + max2 + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* x = static_cast<const int*>(cx);
  const int* y = static_cast<const int*>(cy);
  const int* l1 = static_cast<const int*>(lut1);
  const int* l2 = static_cast<const int*>(lut2);
  float* o = static_cast<float*>(out);
  if (g_is_bf16) {
    auto kernel = table_grads_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kThreads, smem, st>>>(
        p, x, y, l1, l2, static_cast<const __nv_bfloat16*>(g), o, S, P, H, nb1,
        nb2, max1, max2);
  } else {
    auto kernel = table_grads_kernel<float>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kThreads, smem, st>>>(
        p, x, y, l1, l2, static_cast<const float*>(g), o, S, P, H, nb1, nb2,
        max1, max2);
  }
  return static_cast<int>(cudaGetLastError());
}
