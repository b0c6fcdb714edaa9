// materialize_bias: the (B, H, P, P) additive attention bias of LayoutLMv3.
//
// Replaces the TPU kernel `_bias_tile_kernel` behind `materialize_bias`
// (multi_modal_early_exit_tpu/ops/fused_bias_attention.py:244 and :280).
//
//   out[b, h, i, j] = (T1[bkt1(pos_j - pos_i), h] + Tx[bkt2(x0_j - x0_i), h])
//                     + Ty[bkt2(y1_j - y1_i), h]      (+ -1e30 where key j is
//                                                       masked or j >= S)
//
// Bound on an H100: the kernel reads a few KB and writes B*H*P*P elements,
// so it is bound by the output write (B=16, H=12, P=768, bf16: 226.5 MB,
// 68 us at 3.35 TB/s). The design spends nothing else on memory: one thread
// per output column (b, i, j) writes all H heads, neighbouring threads write
// neighbouring j (coalesced), and each block walks ROWS rows i so the tables
// and bucket lookups it stages in shared memory are reused ROWS times.
//
// The Pallas kernel gathers from the tables with a bf16 one-hot matmul (the
// TPU has no vector gather); here the tables (at most 64 x 12 f32) are read
// from shared memory and summed in f32 in a fixed order, then rounded once,
// which is what the plain PyTorch version does, bit for bit. The T5 log
// bucket is NOT computed in the kernel: it depends only on sign(rel) and
// min(|rel|, max_distance), so the host builds an int32 table of
// bucket(n) for n = 0..max_distance once and both versions index it (f32
// `log` differs between libraries by an ulp, and the bucket formula lands
// exactly on integers at powers of two).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // key columns j per block
constexpr int kRows = 16;      // query rows i per block

template <typename OutT>
__global__ void __launch_bounds__(kThreads) materialize_bias_kernel(
    const int* __restrict__ pos, const int* __restrict__ cx,
    const int* __restrict__ cy, const int* __restrict__ mask,  // (B, S)
    const float* __restrict__ t1,                              // (nb1, H)
    const float* __restrict__ tx, const float* __restrict__ ty,  // (nb2, H)
    const int* __restrict__ lut1,  // (max1 + 1): bucket of |rel|, 1D table
    const int* __restrict__ lut2,  // (max2 + 1): bucket of |rel|, 2D tables
    OutT* __restrict__ out,        // (B, H, P, P)
    int S, int P, int H, int nb1, int nb2, int max1, int max2) {
  extern __shared__ float smem[];
  float* s_t1 = smem;
  float* s_tx = s_t1 + nb1 * H;
  float* s_ty = s_tx + nb2 * H;
  int* s_l1 = reinterpret_cast<int*>(s_ty + nb2 * H);
  int* s_l2 = s_l1 + (max1 + 1);
  for (int k = threadIdx.x; k < nb1 * H; k += blockDim.x) s_t1[k] = t1[k];
  for (int k = threadIdx.x; k < nb2 * H; k += blockDim.x) {
    s_tx[k] = tx[k];
    s_ty[k] = ty[k];
  }
  for (int k = threadIdx.x; k <= max1; k += blockDim.x) s_l1[k] = lut1[k];
  for (int k = threadIdx.x; k <= max2; k += blockDim.x) s_l2[k] = lut2[k];
  __syncthreads();

  const int b = blockIdx.z;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  // pad positions (>= S) read as 0, as the zero-padded vectors of the plain
  // version; pad keys are masked, pad query rows stay finite
  int pj = 0, xj = 0, yj = 0;
  bool keep = false;
  if (j < S) {
    pj = pos[b * S + j];
    xj = cx[b * S + j];
    yj = cy[b * S + j];
    keep = mask[b * S + j] != 0;
  }
  const float neg = keep ? 0.0f : -1e30f;
  const int half1 = nb1 / 2, half2 = nb2 / 2;
  const size_t plane = static_cast<size_t>(P) * P;
  OutT* out_b = out + static_cast<size_t>(b) * H * plane;

  const int i_end = min(static_cast<int>(blockIdx.y) * kRows + kRows, P);
  for (int i = blockIdx.y * kRows; i < i_end; ++i) {
    int pi = 0, xi = 0, yi = 0;
    if (i < S) {
      pi = pos[b * S + i];
      xi = cx[b * S + i];
      yi = cy[b * S + i];
    }
    const int r1 = pj - pi, rx = xj - xi, ry = yj - yi;
    const int b1 = (r1 > 0 ? half1 : 0) + s_l1[min(abs(r1), max1)];
    const int bx = (rx > 0 ? half2 : 0) + s_l2[min(abs(rx), max2)];
    const int by = (ry > 0 ? half2 : 0) + s_l2[min(abs(ry), max2)];
    OutT* o = out_b + static_cast<size_t>(i) * P + j;
    for (int h = 0; h < H; ++h) {
      float v = (s_t1[b1 * H + h] + s_tx[bx * H + h]) + s_ty[by * H + h];
      v = v + neg;
      o[h * plane] = mmee_from_float<OutT>(v);
    }
  }
}

}  // namespace

extern "C" int mmee_materialize_bias(
    const void* pos, const void* cx, const void* cy, const void* mask,
    const void* t1, const void* tx, const void* ty, const void* lut1,
    const void* lut2, void* out, int out_is_bf16, int B, int S, int P, int H,
    int nb1, int nb2, int max1, int max2, void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, (P + kRows - 1) / kRows, B);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(nb1 + 2 * nb2) * H +
      sizeof(int) * static_cast<size_t>(max1 + 1 + max2 + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* x = static_cast<const int*>(cx);
  const int* y = static_cast<const int*>(cy);
  const int* m = static_cast<const int*>(mask);
  const float* a = static_cast<const float*>(t1);
  const float* bx = static_cast<const float*>(tx);
  const float* by = static_cast<const float*>(ty);
  const int* l1 = static_cast<const int*>(lut1);
  const int* l2 = static_cast<const int*>(lut2);
  if (out_is_bf16) {
    materialize_bias_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        p, x, y, m, a, bx, by, l1, l2, static_cast<__nv_bfloat16*>(out), S, P,
        H, nb1, nb2, max1, max2);
  } else {
    materialize_bias_kernel<float><<<grid, kThreads, smem, s>>>(
        p, x, y, m, a, bx, by, l1, l2, static_cast<float*>(out), S, P, H, nb1,
        nb2, max1, max2);
  }
  return static_cast<int>(cudaGetLastError());
}
