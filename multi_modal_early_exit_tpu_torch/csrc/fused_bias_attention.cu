// fused_bias_attention: softmax(q k^T * d^-1/2 + bias) v with the LayoutLMv3
// relative-position bias built inside the kernel, deterministic (no dropout).
//
// Replaces the TPU kernel `_kernel` behind `fused_bias_attention`
// (multi_modal_early_exit_tpu/ops/fused_bias_attention.py:70 and :165).
//
//   bias[b, h, i, j] = (T1[bkt1(pos_j - pos_i), h] + Tx[bkt2(x0_j - x0_i), h])
//                      + Ty[bkt2(y1_j - y1_i), h]   (+ -1e30 where key j is
//                                                     masked)
//
// rounded once to q's type, the model dtype (bf16, or f32: no rounding):
// the value materialize_bias.cu would have written, so this kernel equals
// materialize_bias + flash_attention_packed (in bf16 bit for bit on an H100:
// it shares that kernel's score arithmetic and accumulation order), and no
// (B, H, P, P) tensor exists.
//
// Bound on an H100 at B=16, S=768, H=12, D=64, bf16: the kernel must read
// q/k/v and write o (75.5 MB, 22.6 us at 3.35 TB/s) plus the (B, S) vectors
// and the tables (a few hundred KB); its 4*B*H*S*S*D = 2.9e10 FLOPs take
// 29 us at the 989 TFLOP/s bf16 tensor-core peak, so it is bound by
// operations, where flash_attention_packed is bound by the bias read. In
// f32 the FLOPs take 176 us at 165 TFLOP/s (3xTF32: the 495 TF32 TFLOP/s
// over 3 passes). The bias arithmetic (three bucket lookups and three table
// reads per score) runs on the CUDA cores beside the tensor-core products.
//
// Design. One CTA per (64-row q block, head, batch), 4 warps of 16 rows,
// online softmax over 64-key blocks staged in shared memory, mma.sync
// m16n8k16 bf16 with f32 accumulation. For f32 q/k/v (the template
// parameter T): mma.sync m16n8k8 by 3xTF32 (common.cuh), p not rounded
// before p.v, v staged as stored rather than transposed (an f32 B fragment
// is single elements) and q staged through the k tile, so the tiles fit the
// 48 KB of static shared memory.
// One head per CTA rather than all heads per CTA (as the Pallas kernel
// does, to build the bias tile once for the MXU): the buckets are recomputed
// per head, but a CTA stays small, and the lookups are shared-memory
// gathers, not one-hot matmuls. The CTA stages this head's column of each
// table (f32), the two bucket lookup tables as materialize_bias receives
// them (so the buckets are bit-equal), and each key block's pos/x0/y1/mask;
// each thread keeps its two rows' vectors in registers.
//
// q/k/v/o are (B, H, S, D) tensors given by their strides (the last
// stride 1, the others multiples of 8 elements), so the packed projections'
// (B, S, H*D) layout needs no copy: view (B, S, H, D), transpose(1, 2).
// Keys j >= S do not exist (they count as masked, exactly like the -1e30 of
// a padded key whenever a row has a real key); query rows >= S are computed
// from zeros and not stored.

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per CTA (4 warps x 16)
constexpr int kBK = 64;       // keys per block
constexpr int kLD = kD + 8;   // shared row pitch in bf16 (144 B)
constexpr int kThreads = 128;
constexpr int kMaxBins = 64;      // per table
constexpr int kMaxDistance = 1024;

typedef __nv_bfloat16 bf16;

// the pitch of a [row][d] shared tile of T
template <typename T>
constexpr int kPitch = kIsF32<T> ? kLD32 : kLD;

struct Strides {  // in elements; the stride of d is 1
  long long b, h, s;
};

// rows [r0, r0 + 64) of one (b, h) plane into a [row][d] tile at T's pitch
// (and, bf16 only, its transpose [d][row] when dst_t is given); rows >=
// limit read as zero
template <typename T>
__device__ __forceinline__ void load_plane_rows(T* dst, T* dst_t, const T* src, long long rs,
                                                int r0, int limit, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  for (int idx = tid; idx < 64 * (kD / kVec); idx += kThreads) {
    const int r = idx / (kD / kVec), c = (idx % (kD / kVec)) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    }
    if (dst != nullptr) *reinterpret_cast<uint4*>(&dst[r * kPitch<T> + c]) = val;
    if constexpr (!kIsF32<T>) {
      if (dst_t != nullptr) {
        const bf16* ve = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e) dst_t[(c + e) * kLD + r] = ve[e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_bias_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,  // (B, H, S, D), strided
    Strides sq, Strides sk, Strides sv, Strides so,
    const int* __restrict__ pos, const int* __restrict__ cx,
    const int* __restrict__ cy, const int* __restrict__ mask,   // (B, S)
    const float* __restrict__ t1,                              // (nb1, H)
    const float* __restrict__ tx, const float* __restrict__ ty,  // (nb2, H)
    const int* __restrict__ lut1, const int* __restrict__ lut2,
    int S, int H, int nb1, int nb2, int max1, int max2, float scale) {
  constexpr bool kF32 = kIsF32<T>;
  __shared__ __align__(16) T s_q[kF32 ? 1 : kBQ * kLD];  // bf16 only (f32: q in s_k)
  __shared__ __align__(16) T s_k[kBK * kPitch<T>];        // [key][d]
  __shared__ __align__(16) T s_v[kBK * kPitch<T>];        // bf16: v^T [d][key]; f32: [key][d]
  __shared__ float s_t1[kMaxBins], s_tx[kMaxBins], s_ty[kMaxBins];
  __shared__ int s_l1[kMaxDistance + 1], s_l2[kMaxDistance + 1];
  __shared__ int s_kp[kBK], s_kx[kBK], s_ky[kBK];
  __shared__ float s_kneg[kBK];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int* pos_b = pos + static_cast<size_t>(b) * S;
  const int* cx_b = cx + static_cast<size_t>(b) * S;
  const int* cy_b = cy + static_cast<size_t>(b) * S;
  const int* mask_b = mask + static_cast<size_t>(b) * S;

  for (int e = tid; e < nb1; e += kThreads) s_t1[e] = t1[e * H + h];
  for (int e = tid; e < nb2; e += kThreads) {
    s_tx[e] = tx[e * H + h];
    s_ty[e] = ty[e * H + h];
  }
  for (int e = tid; e <= max1; e += kThreads) s_l1[e] = lut1[e];
  for (int e = tid; e <= max2; e += kThreads) s_l2[e] = lut2[e];
  load_plane_rows<T>(kF32 ? s_k : s_q, nullptr, qb, sq.s, q0, S, tid);
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[4][4];  // bf16 A fragments, 4 k steps over d
  float qa32[8][4];   // f32: raw A values, 8 k steps over d
  if constexpr (kF32) {
    load_a_frags(qa32, s_k, wr, g, t);
  } else {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* p = &s_q[(wr + g) * kLD + ks * 16 + 2 * t];
      qa[ks][0] = ld_u32(p);
      qa[ks][1] = ld_u32(p + 8 * kLD);
      qa[ks][2] = ld_u32(p + 8);
      qa[ks][3] = ld_u32(p + 8 * kLD + 8);
    }
  }

  // each thread holds rows g (r=0) and g+8 (r=1) of its warp's 16; their
  // vectors (0 past S, as materialize_bias pads them)
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  int pi[2], xi[2], yi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < S;
    pi[r] = ok ? pos_b[row[r]] : 0;
    xi[r] = ok ? cx_b[row[r]] : 0;
    yi[r] = ok ? cy_b[row[r]] : 0;
  }
  const int half1 = nb1 / 2, half2 = nb2 / 2;
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
    __syncthreads();  // the previous block's k/v and vectors are consumed
    load_plane_rows<T>(s_k, nullptr, kb, sk.s, k0, S, tid);
    if constexpr (kF32) {
      load_plane_rows<T>(s_v, nullptr, vb, sv.s, k0, S, tid);
    } else {
      load_plane_rows<T>(nullptr, s_v, vb, sv.s, k0, S, tid);
    }
    for (int c = tid; c < kBK; c += kThreads) {
      const int j = k0 + c;
      const bool ok = j < S;
      s_kp[c] = ok ? pos_b[j] : 0;
      s_kx[c] = ok ? cx_b[j] : 0;
      s_ky[c] = ok ? cy_b[j] : 0;
      s_kneg[c] = ok && mask_b[j] != 0 ? 0.0f : -1e30f;
    }
    __syncthreads();

    float s[8][4];
    if constexpr (kF32) {
      mma_rows_by_tile(s, qa32, s_k, g, t);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const bf16* p = &s_k[(nt * 8 + g) * kLD + ks * 16 + 2 * t];
          mma_bf16_16816(s[nt], qa[ks], ld_u32(p), ld_u32(p + 8));
        }
      }
    }

    // scale + the rebuilt bias in f32, keys >= S masked out; row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = nt * 8 + 2 * t + (e & 1);
        float x = -INFINITY;
        if (k0 + c < S) {
          float bv = 0.0f;
          if (row[r] < S) {
            const int d1 = s_kp[c] - pi[r], dx = s_kx[c] - xi[r], dy = s_ky[c] - yi[r];
            const int b1 = (d1 > 0 ? half1 : 0) + s_l1[min(abs(d1), max1)];
            const int bx = (dx > 0 ? half2 : 0) + s_l2[min(abs(dx), max2)];
            const int by = (dy > 0 ? half2 : 0) + s_l2[min(abs(dy), max2)];
            bv = (s_t1[b1] + s_tx[bx]) + s_ty[by];
            bv = bv + s_kneg[c];
            bv = mmee_round<T>(bv);
          }
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
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);
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
    if constexpr (kF32) {
      mma_acc_by_rows(acc, s, s_v, g, t);  // o += p v, p not rounded
    } else {
      // o += p v: the score accumulators are the A fragments of p (bf16)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t pa[4];
        pa[0] = pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);
        pa[1] = pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);
        pa[2] = pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
        pa[3] = pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const bf16* p = &s_v[(dt * 8 + g) * kLD + ks * 16 + 2 * t];
          mma_bf16_16816(acc[dt], pa, ld_u32(p), ld_u32(p + 8));
        }
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float inv = 1.0f / l_run[r];
    T* orow = ob + row[r] * so.s;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      store_pair(orow + dt * 8 + 2 * t, acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
}

template <typename T>
int launch_fused(const void* q, const void* k, const void* v, void* o, const Strides& sq,
                 const Strides& sk, const Strides& sv, const Strides& so, const void* pos,
                 const void* cx, const void* cy, const void* mask, const void* t1,
                 const void* tx, const void* ty, const void* lut1, const void* lut2, int B,
                 int S, int H, int nb1, int nb2, int max1, int max2, float scale,
                 cudaStream_t st) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fused_bias_attention_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, static_cast<const int*>(pos),
      static_cast<const int*>(cx), static_cast<const int*>(cy), static_cast<const int*>(mask),
      static_cast<const float*>(t1), static_cast<const float*>(tx),
      static_cast<const float*>(ty), static_cast<const int*>(lut1),
      static_cast<const int*>(lut2), S, H, nb1, nb2, max1, max2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and o bf16 (qkv_is_bf16 = 1) or f32 (0)
extern "C" int mmee_fused_bias_attention(
    const void* q, const void* k, const void* v, void* o, int qkv_is_bf16,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* pos, const void* cx, const void* cy, const void* mask,
    const void* t1, const void* tx, const void* ty, const void* lut1,
    const void* lut2, int B, int S, int H, int nb1, int nb2, int max1,
    int max2, float scale, void* stream) {
  if (nb1 > kMaxBins || nb2 > kMaxBins || max1 > kMaxDistance || max2 > kMaxDistance) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss},
      so{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_is_bf16) {
    return launch_fused<bf16>(q, k, v, o, sq, sk, sv, so, pos, cx, cy, mask, t1, tx, ty, lut1,
                              lut2, B, S, H, nb1, nb2, max1, max2, scale, st);
  }
  return launch_fused<float>(q, k, v, o, sq, sk, sv, so, pos, cx, cy, mask, t1, tx, ty, lut1,
                             lut2, B, S, H, nb1, nb2, max1, max2, scale, st);
}
