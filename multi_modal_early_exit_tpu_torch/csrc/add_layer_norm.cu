// add_layer_norm: out = LayerNorm(x + residual) over the last dimension, the
// residual add and LayerNorm of the encoder's no-grad path
// (models/layoutlmv3/modeling.py::layer_norm).
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses it. Composed of PyTorch ops it is 14 launches, each a full f32 pass,
// plus the bf16 residual add: about 74 bytes of traffic an element. The
// kernel reads x and the residual once and writes the output once: 6 bytes
// an element in bf16. LayerNorm does a few operations a byte, far below the
// card's ridge point, so the output write and the two reads bound it (at
// 49,152 rows of 768 in bf16 with a residual: 226.5 MB, 68 us at 3.35 TB/s).
//
// Design: one warp per row, the row in registers (32 * kN elements, kN per
// lane, loaded and stored as vectors of up to 16 bytes, neighbouring lanes on
// neighbouring vectors). The warps persist: each loads the weight and bias
// once into registers and walks rows gridDim.x * kWarps apart, so no row
// touches shared memory or synchronises the block.
//
// Arithmetic: the composed path's, in f32. The sum x + residual is rounded
// to the input type first, as the composed `x + residual` is; then two-pass
// moments from the registers (the mean, then the mean of (x - mean)^2), the
// normalised value times rsqrt(var + eps), times the weight, plus the bias,
// each product and sum rounded in the composed order (no fused multiply-add),
// and one rounding to the input type. Only the two row sums differ from
// PyTorch's reductions: their order (a warp's butterfly), and the squares'
// sum, which accumulates by fused multiply-adds.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows in flight per block, one a warp

// elements of T in one lane's vector: the largest power of two up to 16
// bytes that divides the lane's kN elements
template <typename T>
__host__ __device__ constexpr int vec_elems(int n) {
  int e = 16 / static_cast<int>(sizeof(T));
  while (n % e != 0) e /= 2;
  return e;
}

template <typename T, int kE>
struct alignas(sizeof(T) * kE) Pack {
  T v[kE];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kN>
__global__ void __launch_bounds__(kWarps * 32) add_layer_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ res,  // (rows, H); res may be null
    const T* __restrict__ weight, const T* __restrict__ bias,  // (H,)
    T* __restrict__ out, int rows, float eps) {
  constexpr int kE = vec_elems<T>(kN);
  constexpr int kV = kN / kE;  // vectors a lane
  constexpr int kH = 32 * kN;
  using P = Pack<T, kE>;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (first >= rows) return;

  // element j of a lane's vector v is column (v * 32 + lane) * kE + j
  float w[kN], b[kN];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int col = (v * 32 + lane) * kE + j;
      w[v * kE + j] = mmee_to_float(weight[col]);
      b[v * kE + j] = mmee_to_float(bias[col]);
    }
  }

  const float inv_h = 1.0f / kH;
  for (int row = first; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * kH;
    const P* xr = reinterpret_cast<const P*>(x + base);
    P px[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) px[v] = xr[v * 32 + lane];
    float s[kN];
    if (res != nullptr) {
      const P* rr = reinterpret_cast<const P*>(res + base);
      P pr[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) pr[v] = rr[v * 32 + lane];
#pragma unroll
      for (int v = 0; v < kV; ++v)
#pragma unroll
        for (int j = 0; j < kE; ++j)
          s[v * kE + j] = mmee_round<T>(mmee_to_float(px[v].v[j]) + mmee_to_float(pr[v].v[j]));
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v)
#pragma unroll
        for (int j = 0; j < kE; ++j) s[v * kE + j] = mmee_to_float(px[v].v[j]);
    }

    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kN; ++i) sum += s[i];
    const float mean = warp_sum(sum) * inv_h;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      s[i] = __fsub_rn(s[i], mean);
      sq = __fmaf_rn(s[i], s[i], sq);
    }
    const float rsig = rsqrtf(__fadd_rn(warp_sum(sq) * inv_h, eps));

    P* orow = reinterpret_cast<P*>(out + base);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      P po;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int i = v * kE + j;
        const float y = __fmul_rn(s[i], rsig);
        po.v[j] = mmee_from_float<T>(__fadd_rn(__fmul_rn(y, w[i]), b[i]));
      }
      orow[v * 32 + lane] = po;
    }
  }
}

// blocks that fill the card once: resident blocks an SM times the SMs,
// looked up once an instantiation (the grid's size moves no result)
template <typename T, int kN>
int persistent_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, add_layer_norm_kernel<T, kN>,
                                                  kWarps * 32, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks;
}

template <typename T, int kN>
int launch(const void* x, const void* res, const void* weight, const void* bias, void* out,
           int rows, float eps, cudaStream_t stream) {
  const int needed = (rows + kWarps - 1) / kWarps;
  const int blocks = needed < persistent_blocks<T, kN>() ? needed : persistent_blocks<T, kN>();
  add_layer_norm_kernel<T, kN><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(weight),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* x, const void* res, const void* weight, const void* bias,
                 void* out, int rows, int width, float eps, cudaStream_t s) {
  switch (width) {  // ops/layer_norm.py's WIDTHS
    case 64: return launch<T, 2>(x, res, weight, bias, out, rows, eps, s);
    case 128: return launch<T, 4>(x, res, weight, bias, out, rows, eps, s);
    case 256: return launch<T, 8>(x, res, weight, bias, out, rows, eps, s);
    case 384: return launch<T, 12>(x, res, weight, bias, out, rows, eps, s);
    case 512: return launch<T, 16>(x, res, weight, bias, out, rows, eps, s);
    case 768: return launch<T, 24>(x, res, weight, bias, out, rows, eps, s);
    case 1024: return launch<T, 32>(x, res, weight, bias, out, rows, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, residual (null: none) and out are (rows, width) row-major, 16-byte
// aligned; weight and bias (width,); all bf16 or all f32
extern "C" int mmee_add_layer_norm(const void* x, const void* residual, const void* weight,
                                   const void* bias, void* out, int is_bf16, int rows,
                                   int width, float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_width<__nv_bfloat16>(x, residual, weight, bias, out, rows, width, eps, s)
      : launch_width<float>(x, residual, weight, bias, out, rows, width, eps, s);
}
