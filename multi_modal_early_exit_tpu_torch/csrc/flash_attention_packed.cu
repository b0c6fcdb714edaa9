// flash_attention_packed: softmax(q k^T * d^-1/2 + bias) v on the packed
// (B, S, H*D) layout, deterministic (no dropout).
//
// Replaces the TPU kernel `_attn_fwd_packed_kernel` behind
// `flash_attention_packed` (multi_modal_early_exit_tpu/ops/flash_attention.py:446
// and :490).
//
// Bound on an H100: the (B, H, P, P) bias read dominates. At B=16, S=709,
// P=768, H=12, D=64 in bf16 the kernel must move 226.5 MB of bias plus
// 4*B*P*H*D*2 = 75.5 MB of q/k/v/o, about 90 us at 3.35 TB/s, while its
// 4*B*P*P*H*D = 29 GFLOP take 29 us at the 989 TFLOP/s bf16 tensor-core
// peak: it is memory-bound. The design reads every byte once: one CTA per
// (64-row q block, head, batch) streams 64-key blocks of k/v through shared
// memory and reads each bias element exactly once, straight into registers,
// keeping scores and probabilities on chip (online softmax, f32 running max
// m and sum l, f32 output accumulator). The products run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate); each of the 4 warps owns
// 16 query rows.
//
// The packed layout is only a stride: q/k/v/o of head h start at column h*D
// of each (H*D)-wide row, so the TPU kernel's 128-lane head grouping is not
// needed. The bias may be wider than S (pre-padded to P >= S); keys j >= S
// are never read and count as masked, query rows >= S are computed from
// zeros and not stored. The running max starts at -inf; key 0 is always a
// real key, so it is finite after the first key block, and a row whose keys
// all carry -1e30 averages v uniformly, as the plain softmax does.

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per CTA (4 warps x 16)
constexpr int kBK = 64;       // keys per block
constexpr int kLD = kD + 8;   // shared row pitch in bf16: 144 B, so the
                              // fragment loads below hit 32 distinct banks
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <typename BiasT>
__global__ void __launch_bounds__(kThreads) flash_attention_packed_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,  // (B, S, H*D)
    const BiasT* __restrict__ bias,       // (B, H, P, P)
    __nv_bfloat16* __restrict__ o,        // (B, S, H*D)
    int S, int H, int P, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_q[kBQ * kLD];
  __shared__ __align__(16) __nv_bfloat16 s_k[kBK * kLD];
  __shared__ __align__(16) __nv_bfloat16 s_vt[kD * kLD];  // v^T: [d][key]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group row / thread in group
  const int hd = H * kD;
  const size_t batch_off = static_cast<size_t>(b) * S * hd + h * kD;
  const __nv_bfloat16* qb = q + batch_off;
  const __nv_bfloat16* kb = k + batch_off;
  const __nv_bfloat16* vb = v + batch_off;

  // q tile: 64 rows x 64 dims, 16-byte vectors, rows >= S read as zero
  for (int idx = tid; idx < kBQ * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) {
      val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(q0 + r) * hd + c);
    }
    *reinterpret_cast<uint4*>(&s_q[r * kLD + c]) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, 4 steps of 16 over D
  const int wr = warp * 16;
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* p = &s_q[(wr + g) * kLD + ks * 16 + 2 * t];
    qa[ks][0] = ld_u32(p);                // row g,   dims 2t, 2t+1
    qa[ks][1] = ld_u32(p + 8 * kLD);      // row g+8
    qa[ks][2] = ld_u32(p + 8);            // row g,   dims 2t+8, 2t+9
    qa[ks][3] = ld_u32(p + 8 * kLD + 8);  // row g+8
  }

  // each thread holds rows g (r=0) and g+8 (r=1) of the warp's 16
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const BiasT* bias_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bias_row[r] = bias + ((static_cast<size_t>(b) * H + h) * P +
                          (row[r] < S ? row[r] : 0)) * static_cast<size_t>(P);
  }
  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  const int n_kb = (S + kBK - 1) / kBK;
  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // the previous block's k/v are consumed
    for (int idx = tid; idx < kBK * (kD / 8); idx += kThreads) {
      const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        const size_t off = static_cast<size_t>(k0 + r) * hd + c;
        kv = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&s_k[r * kLD + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) s_vt[(c + e) * kLD + r] = ve[e];
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* p = &s_k[(nt * 8 + g) * kLD + ks * 16 + 2 * t];
        mma_bf16_16816(s[nt], qa[ks], ld_u32(p), ld_u32(p + 8));
      }
    }

    // scale + bias in f32, keys >= S masked out; running row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = -INFINITY;
        if (col < S) {
          const float bv = row[r] < S ? mmee_to_float(bias_row[r][col]) : 0.0f;
          x = s[nt][e] * scale + bv;
        }
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;  // no (-inf) - (-inf)
      alpha[r] = expf(m_run[r] - m_use[r]);           // 0 on the first block
      m_run[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // o += p v: the score accumulators are the A fragments of p (bf16)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);          // row g
      pa[1] = pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);          // row g+8
      pa[2] = pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);  // row g
      pa[3] = pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);  // row g+8
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* p = &s_vt[(dt * 8 + g) * kLD + ks * 16 + 2 * t];
        mma_bf16_16816(acc[dt], pa, ld_u32(p), ld_u32(p + 8));
      }
    }
  }

  // o / l, packed back at column h*D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float inv = 1.0f / l_run[r];
    __nv_bfloat16* orow = o + batch_off + static_cast<size_t>(row[r]) * hd;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int mmee_flash_attention_packed(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           int bias_is_bf16, void* o, int B,
                                           int S, int H, int P, float scale,
                                           void* stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  if (bias_is_bf16) {
    flash_attention_packed_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, static_cast<const __nv_bfloat16*>(bias), op, S, H, P, scale);
  } else {
    flash_attention_packed_kernel<float><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, static_cast<const float*>(bias), op, S, H, P, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
