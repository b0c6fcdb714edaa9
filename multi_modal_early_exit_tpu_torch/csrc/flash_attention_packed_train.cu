// flash_attention_packed_train: the training forward and backward of
// softmax(q k^T * d^-1/2 + bias) v on the packed (B, S, H*D) layout, with
// position-hash dropout on the probabilities.
//
// Replaces three TPU kernels of multi_modal_early_exit_tpu/ops/flash_attention.py:
// `_attn_fwd_packed_train_kernel` (:607, behind `_flash_packed_train_fwd_impl`
// :753), `_attn_bwd_packed_kernel` (:652, behind `_flash_packed_bwd_impl`
// :812), the latter in its plain and its chained form (dbias = gbias + ds),
// and `_attn_bwd_packed_tables_kernel` (:1038, behind
// `_flash_packed_bwd_tables_impl` :1186), the backward that reduces ds
// straight into the three relative-position tables.
//
// Bound on an H100, at B=16, S=P=768, H=12, D=64, bf16: both are bound by
// the (B, H, P, P) bias traffic. The forward must read the bias (226.5 MB)
// and q/k/v and write o (75.5 MB) and the f32 lse (0.6 MB): 90 us at
// 3.35 TB/s, against 29 us for its 2.9e10 FLOPs at the 989 TFLOP/s bf16
// peak. The chained backward must read bias and gbias and write dbias
// (679.5 MB), read q/k/v/o/do and write dq/dk/dv (151 MB): 248 us, against
// 73 us for its 7.25e10 FLOPs.
//
// Design. Each CTA holds 64 rows as 4 warps of 16 and runs its products on
// the tensor cores with mma.sync m16n8k16 (bf16 operands, f32 accumulation),
// as the inference kernel does. Scores and probabilities never leave the
// chip; the bias is read straight into registers.
//
// - Forward: one CTA per (64-row q block, head, batch) streams 64-key
//   blocks of k/v through shared memory with an online softmax. The dropout
//   factor c(i, j) multiplies the unnormalised exp before the p.v product,
//   and the final division by the (undropped) row sum makes that equal to
//   dropout applied to the normalised p. lse = m + log(sum) excludes it.
// - Backward, deterministic (no float atomics), in two kernels that each
//   recompute p = exp(s - lse):
//   (A) one CTA per (64-row q block over all P rows, head, batch) computes
//       delta = rowsum(do * o) for its rows, walks every key block and
//       writes dbias = ds (+ gbias) for the whole P x P plane (zero past S),
//       and dq = ds k * scale; it also writes delta (B, H, P) f32 for (B);
//   (B) one CTA per (64-key block, head, batch) walks every q block and
//       accumulates dv = (p c)^T do and dk = ds^T q * scale in registers.
//   ds is rounded to bf16 before the dq/dk products and p c before dv, as
//   the TPU kernel does; dk/dv accumulate in f32 and are rounded once.
// - Backward with table gradients, three kernels, deterministic as well:
//   (A') is (A) over the rows and keys < S only, writing no dbias: each key
//   block's f32 ds tile goes to shared memory, and one thread per (row,
//   table) walks it with a running sum while the bucket stays the same,
//   flushing into that row's own column of a [bin][row] histogram; the CTA
//   then sums each bin over its 64 rows in order into a per-CTA partial;
//   (B) as above; (C) sums the partials of each (bin, head) over (b, q
//   block) in a fixed order. It sums f32 ds: the Pallas kernel's bf16 ds
//   stash only saves VMEM. Bound at B=16, S=P=768, H=12, D=64, bf16: it
//   must read the bias (226.5 MB), q/k/v/o/do (94.4 MB) and the lse, and
//   write dq/dk/dv (56.6 MB): 113 us at 3.35 TB/s, against 73 us for its
//   7.25e10 FLOPs. No (B, H, P, P) cotangent exists.
//
// The dropout mask is a pure function of (seed, b*H + h, i, j) with global
// positions i, j (lowbias32 position hash, ops/hashing.py), so the forward
// and both backward kernels regenerate the same mask under any tiling, and
// it is the JAX package's mask bit for bit. Keys j >= S count as masked and
// query rows >= S are computed from zeros and not stored; the forward writes
// +inf as the lse of rows in [S, P).

#include "common.cuh"

namespace {

constexpr int kD = 64;       // head dim
constexpr int kBQ = 64;      // rows per CTA (4 warps x 16)
constexpr int kBK = 64;      // columns per block
constexpr int kLD = kD + 8;  // shared row pitch in bf16 (144 B)
constexpr int kThreads = 128;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// c(i, j) of one (b, h) plane: 1/keep where the element is kept, else 0
struct Dropout {
  uint32_t state;
  float keep, inv_keep;
  __device__ Dropout(int seed, int bh, float keep_, float inv_keep_)
      : state(lowbias32(static_cast<uint32_t>(seed) ^
                        (static_cast<uint32_t>(bh) * 0x9E3779B1u))),
        keep(keep_), inv_keep(inv_keep_) {}
  __device__ __forceinline__ float scale(int i, int j) const {
    const uint32_t bits = lowbias32(state + static_cast<uint32_t>(i) * 0x85EBCA77u +
                                    static_cast<uint32_t>(j) * 0x27D4EB2Fu);
    const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
    return u < keep ? inv_keep : 0.0f;
  }
};

// rows [r0, r0 + 64) of a (rows, H*D) bf16 matrix at column offset `col`
// into a [row][d] shared tile; rows >= limit read as zero
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int limit, int hd, int tid) {
  for (int idx = tid; idx < 64 * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * hd + c);
    }
    *reinterpret_cast<uint4*>(&dst[r * kLD + c]) = val;
  }
}

// the same rows into a [row][d] tile and its transpose [d][row]
__device__ __forceinline__ void load_rows_both(bf16* dst, bf16* dst_t,
                                               const bf16* src, int r0,
                                               int limit, int hd, int tid) {
  for (int idx = tid; idx < 64 * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * hd + c);
    }
    if (dst != nullptr) *reinterpret_cast<uint4*>(&dst[r * kLD + c]) = val;
    const bf16* ve = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst_t[(c + e) * kLD + r] = ve[e];
  }
}

// this warp's 16 rows of a [row][d] tile as mma A fragments (4 k-steps)
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const bf16* tile,
                                             int wr, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const bf16* p = &tile[(wr + g) * kLD + ks * 16 + 2 * t];
    a[ks][0] = ld_u32(p);
    a[ks][1] = ld_u32(p + 8 * kLD);
    a[ks][2] = ld_u32(p + 8);
    a[ks][3] = ld_u32(p + 8 * kLD + 8);
  }
}

// acc[nt] (16 x 64) = A (16 x 64 over d) times tile^T, tile [col][d]
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[8][4],
                                                 const uint32_t (&a)[4][4],
                                                 const bf16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* p = &tile[(nt * 8 + g) * kLD + ks * 16 + 2 * t];
      mma_bf16_16816(acc[nt], a[ks], ld_u32(p), ld_u32(p + 8));
    }
  }
}

// out[dt] (16 x 64 over d) += X (16 x 64 over columns, f32 accumulators
// rounded to bf16) times tile_t^T, tile_t [d][column]
__device__ __forceinline__ void mma_acc_by_tile_t(float (&out)[8][4],
                                                  const float (&x)[8][4],
                                                  const bf16* tile_t, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(x[2 * ks][0], x[2 * ks][1]);
    pa[1] = pack_bf16x2(x[2 * ks][2], x[2 * ks][3]);
    pa[2] = pack_bf16x2(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    pa[3] = pack_bf16x2(x[2 * ks + 1][2], x[2 * ks + 1][3]);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const bf16* p = &tile_t[(dt * 8 + g) * kLD + ks * 16 + 2 * t];
      mma_bf16_16816(out[dt], pa, ld_u32(p), ld_u32(p + 8));
    }
  }
}

// 16 x 64 f32 accumulators, times `mul`, rounded to bf16 at rows `row`
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[8][4],
                                           const int (&row)[2], int limit, int hd,
                                           float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= limit) continue;
    bf16* orow = dst + static_cast<size_t>(row[r]) * hd;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename BiasT>
__global__ void __launch_bounds__(kThreads) train_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v,       // (B, S, H*D)
    const BiasT* __restrict__ bias,   // (B, H, P, P)
    bf16* __restrict__ o,             // (B, S, H*D)
    float* __restrict__ lse,          // (B, H, P)
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  __shared__ __align__(16) bf16 s_q[kBQ * kLD];
  __shared__ __align__(16) bf16 s_k[kBK * kLD];
  __shared__ __align__(16) bf16 s_vt[kD * kLD];  // v^T: [d][key]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hd = H * kD;
  const size_t plane = static_cast<size_t>(b) * H + h;
  float* lse_bh = lse + plane * P;
  if (q0 >= S) {  // a block of pad rows only: their lse is +inf
    for (int r = tid; r < kBQ; r += kThreads) lse_bh[q0 + r] = INFINITY;
    return;
  }
  const size_t batch_off = static_cast<size_t>(b) * S * hd + h * kD;

  load_rows(s_q, q + batch_off, q0, S, hd, tid);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[4][4];
  load_a_frags(qa, s_q, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const BiasT* bias_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bias_row[r] = bias + (plane * P + (row[r] < S ? row[r] : 0)) * static_cast<size_t>(P);
  }
  const Dropout drop(seed, static_cast<int>(plane), keep, inv_keep);
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
    load_rows(s_k, k + batch_off, k0, S, hd, tid);
    load_rows_both(nullptr, s_vt, v + batch_off, k0, S, hd, tid);
    __syncthreads();

    float s[8][4];
    mma_rows_by_tile(s, qa, s_k, g, t);

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
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[nt][e] - m_use[e >> 1]);
        rs[e >> 1] += p;  // the row sum (and so the lse) excludes dropout
        if (dropout) p *= drop.scale(row[e >> 1], k0 + nt * 8 + 2 * t + (e & 1));
        s[nt][e] = p;
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
    mma_acc_by_tile_t(acc, s, s_vt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (t == 0) lse_bh[row[r]] = row[r] < S ? m_run[r] + logf(l_run[r]) : INFINITY;
    if (row[r] >= S) continue;
    const float inv = 1.0f / l_run[r];
    bf16* orow = o + batch_off + static_cast<size_t>(row[r]) * hd;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// backward (A): delta, dbias (= ds, + gbias when chained) and dq
// ---------------------------------------------------------------------------

template <typename BiasT>
__global__ void __launch_bounds__(kThreads) train_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const BiasT* __restrict__ bias,
    const bf16* __restrict__ dout, const bf16* __restrict__ o,
    const float* __restrict__ lse,     // (B, H, P)
    const BiasT* __restrict__ gbias,   // (B, H, P, P) or null
    bf16* __restrict__ dq,             // (B, S, H*D)
    BiasT* __restrict__ dbias,         // (B, H, P, P)
    float* __restrict__ delta,         // (B, H, P), written here
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  __shared__ __align__(16) bf16 s_a[kBQ * kLD];   // q, then do
  __shared__ __align__(16) bf16 s_k[kBK * kLD];   // [key][d]
  __shared__ __align__(16) bf16 s_kt[kD * kLD];   // [d][key]
  __shared__ __align__(16) bf16 s_v[kBK * kLD];   // [key][d]
  __shared__ float s_delta[kBQ];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hd = H * kD;
  const size_t plane = static_cast<size_t>(b) * H + h;
  const size_t batch_off = static_cast<size_t>(b) * S * hd + h * kD;
  const int wr = warp * 16;

  // delta[i] = sum_d do[i, d] * o[i, d] in f32, one thread per row
  if (tid < kBQ) {
    const int i = q0 + tid;
    float acc = 0.0f;
    if (i < S) {
      const bf16* dr = dout + batch_off + static_cast<size_t>(i) * hd;
      const bf16* orow = o + batch_off + static_cast<size_t>(i) * hd;
#pragma unroll
      for (int c = 0; c < kD; c += 8) {
        const uint4 dv = *reinterpret_cast<const uint4*>(dr + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += __bfloat162float(de[e]) * __bfloat162float(oe[e]);
      }
    }
    s_delta[tid] = acc;
    delta[plane * P + i] = acc;
  }
  uint32_t qa[4][4], da[4][4];
  load_rows(s_a, q + batch_off, q0, S, hd, tid);
  __syncthreads();
  load_a_frags(qa, s_a, wr, g, t);
  __syncthreads();
  load_rows(s_a, dout + batch_off, q0, S, hd, tid);
  __syncthreads();
  load_a_frags(da, s_a, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < S ? lse[plane * P + row[r]] : 0.0f;
    delta_r[r] = s_delta[wr + g + 8 * r];
  }
  const Dropout drop(seed, static_cast<int>(plane), keep, inv_keep);
  float dq_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.0f;
  }

  const int n_kb = P / kBK;  // every column of the plane: dbias is P x P
  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();
    load_rows_both(s_k, s_kt, k + batch_off, k0, S, hd, tid);
    load_rows(s_v, v + batch_off, k0, S, hd, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows_by_tile(s, qa, s_k, g, t);   // q k^T
    mma_rows_by_tile(dp, da, s_v, g, t);  // do v^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = k0 + nt * 8 + 2 * t;
        const size_t off = (plane * P + row[r]) * static_cast<size_t>(P) + col;
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          ds[c] = 0.0f;
          if (row[r] < S && col + c < S) {
            const float p = expf(s[nt][e] * scale + mmee_to_float(bias[off + c]) - lse_r[r]);
            float dpv = dp[nt][e];
            if (dropout) dpv *= drop.scale(row[r], col + c);
            ds[c] = p * (dpv - delta_r[r]);
          }
          s[nt][e] = ds[c];
          float out = ds[c];
          if (gbias != nullptr) out += mmee_to_float(gbias[off + c]);
          dbias[off + c] = mmee_from_float<BiasT>(out);
        }
      }
    }
    mma_acc_by_tile_t(dq_acc, s, s_kt, g, t);  // dq += ds k
  }
  store_rows(dq + batch_off, dq_acc, row, S, hd, scale, t);
}

// ---------------------------------------------------------------------------
// backward (B): dk and dv
// ---------------------------------------------------------------------------

template <typename BiasT>
__global__ void __launch_bounds__(kThreads) train_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const BiasT* __restrict__ bias,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv,  // (B, S, H*D)
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  __shared__ __align__(16) bf16 s_q[kBQ * kLD];    // [query][d]
  __shared__ __align__(16) bf16 s_qt[kD * kLD];    // [d][query]
  __shared__ __align__(16) bf16 s_do[kBQ * kLD];   // [query][d]
  __shared__ __align__(16) bf16 s_dot[kD * kLD];   // [d][query]
  __shared__ float s_lse[kBQ];
  __shared__ float s_delta[kBQ];

  const int j0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hd = H * kD;
  const size_t plane = static_cast<size_t>(b) * H + h;
  const size_t batch_off = static_cast<size_t>(b) * S * hd + h * kD;
  const int wr = warp * 16;

  uint32_t ka[4][4], va[4][4];
  load_rows(s_q, k + batch_off, j0, S, hd, tid);
  load_rows(s_do, v + batch_off, j0, S, hd, tid);
  __syncthreads();
  load_a_frags(ka, s_q, wr, g, t);
  load_a_frags(va, s_do, wr, g, t);

  const int key[2] = {j0 + wr + g, j0 + wr + g + 8};
  const BiasT* bias_col[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bias_col[r] = bias + plane * P * static_cast<size_t>(P) + (key[r] < S ? key[r] : 0);
  }
  const Dropout drop(seed, static_cast<int>(plane), keep, inv_keep);
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.0f;
  }

  const int n_qb = (S + kBQ - 1) / kBQ;
  for (int qbi = 0; qbi < n_qb; ++qbi) {
    const int i0 = qbi * kBQ;
    __syncthreads();
    load_rows_both(s_q, s_qt, q + batch_off, i0, S, hd, tid);
    load_rows_both(s_do, s_dot, dout + batch_off, i0, S, hd, tid);
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool ok = i0 + r < S;
      s_lse[r] = ok ? lse[plane * P + i0 + r] : 0.0f;
      s_delta[r] = ok ? delta[plane * P + i0 + r] : 0.0f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // rows: this warp's keys, columns: queries
    mma_rows_by_tile(st, ka, s_q, g, t);    // k q^T
    mma_rows_by_tile(dpt, va, s_do, g, t);  // v do^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ci = nt * 8 + 2 * t + (e & 1);
        const int i = i0 + ci;
        float pd = 0.0f, ds = 0.0f;
        if (i < S && key[r] < S) {
          const float bv = mmee_to_float(bias_col[r][static_cast<size_t>(i) * P]);
          const float p = expf(st[nt][e] * scale + bv - s_lse[ci]);
          const float c = dropout ? drop.scale(i, key[r]) : 1.0f;
          pd = p * c;
          ds = p * (dpt[nt][e] * c - s_delta[ci]);
        }
        st[nt][e] = pd;
        dpt[nt][e] = ds;
      }
    }
    mma_acc_by_tile_t(dv_acc, st, s_dot, g, t);   // dv += (p c)^T do
    mma_acc_by_tile_t(dk_acc, dpt, s_qt, g, t);   // dk += ds^T q
  }
  store_rows(dk + batch_off, dk_acc, key, S, hd, scale, t);
  store_rows(dv + batch_off, dv_acc, key, S, hd, 1.0f, t);
}

// ---------------------------------------------------------------------------
// backward with table gradients (A'): delta, dq and per-CTA partial sums of
// ds over the three bias tables' buckets; no dbias is written
// ---------------------------------------------------------------------------

// a running (bucket, sum) along one row for one table; flushes into the
// row's own column of a [bin][row] histogram, so no two threads write one
// entry and the sums do not depend on the order in which threads run
struct RowRun {
  int bucket = -1;
  float sum = 0.0f;
  __device__ __forceinline__ void add(float* hist_row, int bkt, float x) {
    if (bkt != bucket) {
      if (bucket >= 0) hist_row[bucket * kBQ] += sum;
      bucket = bkt;
      sum = 0.0f;
    }
    sum += x;
  }
  __device__ __forceinline__ void flush(float* hist_row) {
    if (bucket >= 0) hist_row[bucket * kBQ] += sum;
  }
};

__device__ __forceinline__ int bucket_of(int rel, int half, const int* lut, int max_d) {
  return (rel > 0 ? half : 0) + lut[min(abs(rel), max_d)];
}

template <typename BiasT>
__global__ void __launch_bounds__(kThreads) train_bwd_dq_tables_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const BiasT* __restrict__ bias,
    const bf16* __restrict__ dout, const bf16* __restrict__ o,
    const float* __restrict__ lse,     // (B, H, P)
    const int* __restrict__ pos, const int* __restrict__ cx,
    const int* __restrict__ cy,        // (B, S)
    const int* __restrict__ lut1, const int* __restrict__ lut2,
    bf16* __restrict__ dq,             // (B, S, H*D)
    float* __restrict__ delta,         // (B, H, P), rows < S written here
    float* __restrict__ partial,       // (B, H, n_qb, nb1 + 2 * nb2)
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout, int nb1, int nb2, int max1, int max2) {
  __shared__ __align__(16) bf16 s_a[kBQ * kLD];   // q, then do
  __shared__ __align__(16) bf16 s_k[kBK * kLD];   // [key][d]
  __shared__ __align__(16) bf16 s_kt[kD * kLD];   // [d][key]
  __shared__ __align__(16) bf16 s_v[kBK * kLD];   // [key][d]
  __shared__ float s_delta[kBQ];
  __shared__ int s_kp[kBK], s_kx[kBK], s_ky[kBK];
  extern __shared__ float dyn[];
  const int n_bins = nb1 + 2 * nb2;
  float* s_ds = dyn;                         // [row][key], pitch kBK + 1
  float* s_hist = s_ds + kBQ * (kBK + 1);    // [bin][row]
  int* s_l1 = reinterpret_cast<int*>(s_hist + n_bins * kBQ);
  int* s_l2 = s_l1 + max1 + 1;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hd = H * kD;
  const size_t plane = static_cast<size_t>(b) * H + h;
  const size_t batch_off = static_cast<size_t>(b) * S * hd + h * kD;
  const int wr = warp * 16;
  const int* pos_b = pos + static_cast<size_t>(b) * S;
  const int* cx_b = cx + static_cast<size_t>(b) * S;
  const int* cy_b = cy + static_cast<size_t>(b) * S;

  for (int e = tid; e < n_bins * kBQ; e += kThreads) s_hist[e] = 0.0f;
  for (int e = tid; e <= max1; e += kThreads) s_l1[e] = lut1[e];
  for (int e = tid; e <= max2; e += kThreads) s_l2[e] = lut2[e];

  // delta[i] = sum_d do[i, d] * o[i, d] in f32, one thread per row
  if (tid < kBQ) {
    const int i = q0 + tid;
    float acc = 0.0f;
    if (i < S) {
      const bf16* dr = dout + batch_off + static_cast<size_t>(i) * hd;
      const bf16* orow = o + batch_off + static_cast<size_t>(i) * hd;
#pragma unroll
      for (int c = 0; c < kD; c += 8) {
        const uint4 dv = *reinterpret_cast<const uint4*>(dr + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += __bfloat162float(de[e]) * __bfloat162float(oe[e]);
      }
    }
    s_delta[tid] = acc;
    delta[plane * P + i] = acc;
  }
  uint32_t qa[4][4], da[4][4];
  load_rows(s_a, q + batch_off, q0, S, hd, tid);
  __syncthreads();
  load_a_frags(qa, s_a, wr, g, t);
  __syncthreads();
  load_rows(s_a, dout + batch_off, q0, S, hd, tid);
  __syncthreads();
  load_a_frags(da, s_a, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < S ? lse[plane * P + row[r]] : 0.0f;
    delta_r[r] = s_delta[wr + g + 8 * r];
  }
  const Dropout drop(seed, static_cast<int>(plane), keep, inv_keep);
  float dq_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.0f;
  }

  // the table walk: thread tid owns row tid % 64 of this block, for tables
  // T1 and Tx (tid < 64) or Ty (tid >= 64), and keeps one running sum per
  // table along that row across every key block
  const int walk_row = tid % kBQ;
  const bool walk_first = tid < kBQ;
  const int wi = q0 + walk_row;
  int w_pos = 0, w_x = 0, w_y = 0;
  if (wi < S) {
    w_pos = pos_b[wi];
    w_x = cx_b[wi];
    w_y = cy_b[wi];
  }
  float* hist_a = s_hist + (walk_first ? 0 : nb1 + nb2) * kBQ + walk_row;  // T1 or Ty
  float* hist_x = s_hist + nb1 * kBQ + walk_row;
  RowRun run_a, run_x;

  const int n_kb = (S + kBK - 1) / kBK;  // keys >= S carry no ds
  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // the previous block's tiles and ds are consumed
    load_rows_both(s_k, s_kt, k + batch_off, k0, S, hd, tid);
    load_rows(s_v, v + batch_off, k0, S, hd, tid);
    for (int c = tid; c < kBK; c += kThreads) {
      const int j = k0 + c;
      s_kp[c] = j < S ? pos_b[j] : 0;
      s_kx[c] = j < S ? cx_b[j] : 0;
      s_ky[c] = j < S ? cy_b[j] : 0;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows_by_tile(s, qa, s_k, g, t);   // q k^T
    mma_rows_by_tile(dp, da, s_v, g, t);  // do v^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cl = nt * 8 + 2 * t;
        const int col = k0 + cl;
        const size_t off = (plane * P + row[r]) * static_cast<size_t>(P) + col;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          float ds = 0.0f;
          if (row[r] < S && col + c < S) {
            const float p = expf(s[nt][e] * scale + mmee_to_float(bias[off + c]) - lse_r[r]);
            float dpv = dp[nt][e];
            if (dropout) dpv *= drop.scale(row[r], col + c);
            ds = p * (dpv - delta_r[r]);
          }
          s[nt][e] = ds;
          s_ds[(wr + g + 8 * r) * (kBK + 1) + cl + c] = ds;
        }
      }
    }
    mma_acc_by_tile_t(dq_acc, s, s_kt, g, t);  // dq += ds k (ds as bf16)
    __syncthreads();  // s_ds holds the block's f32 ds

    if (wi < S) {
      const float* ds_row = s_ds + walk_row * (kBK + 1);
      const int n = min(kBK, S - k0);
      const int half1 = nb1 / 2, half2 = nb2 / 2;
      for (int c = 0; c < n; ++c) {
        const float x = ds_row[c];
        if (walk_first) {
          run_a.add(hist_a, bucket_of(s_kp[c] - w_pos, half1, s_l1, max1), x);
          run_x.add(hist_x, bucket_of(s_kx[c] - w_x, half2, s_l2, max2), x);
        } else {
          run_a.add(hist_a, bucket_of(s_ky[c] - w_y, half2, s_l2, max2), x);
        }
      }
    }
  }
  store_rows(dq + batch_off, dq_acc, row, S, hd, scale, t);
  run_a.flush(hist_a);
  if (walk_first) run_x.flush(hist_x);
  __syncthreads();

  // this CTA's partial sums, each over its 64 rows in row order
  float* out = partial + (plane * gridDim.x + blockIdx.x) * n_bins;
  for (int bin = tid; bin < n_bins; bin += kThreads) {
    const float* hrow = s_hist + bin * kBQ;
    float acc = 0.0f;
    for (int r = 0; r < kBQ; ++r) acc += hrow[r];
    out[bin] = acc;
  }
}

// the (n_bins, H) table gradients: each entry sums its (b, q block)
// partials in a fixed order, so the result is the same on every run
__global__ void table_partials_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int B, int H,
                                          int n_qb, int n_bins) {
  const int h = blockIdx.x;
  for (int bin = threadIdx.x; bin < n_bins; bin += blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) {
      const float* p = partial + ((static_cast<size_t>(b) * H + h) * n_qb) * n_bins + bin;
      for (int qb = 0; qb < n_qb; ++qb) acc += p[static_cast<size_t>(qb) * n_bins];
    }
    out[static_cast<size_t>(bin) * H + h] = acc;
  }
}

template <typename BiasT>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const void* bias,
               const bf16* dout, const bf16* o, const float* lse,
               const void* gbias, bf16* dq, bf16* dk, bf16* dv, void* dbias,
               float* delta, int B, int S, int H, int P, float scale, int seed,
               float keep, float inv_keep, int dropout, cudaStream_t st) {
  const BiasT* bp = static_cast<const BiasT*>(bias);
  train_bwd_dq_kernel<BiasT><<<dim3(P / kBQ, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, o, lse, static_cast<const BiasT*>(gbias), dq,
      static_cast<BiasT*>(dbias), delta, S, H, P, scale, seed, keep, inv_keep,
      dropout);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  train_bwd_dkv_kernel<BiasT><<<dim3((S + kBK - 1) / kBK, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, lse, delta, dk, dv, S, H, P, scale, seed, keep,
      inv_keep, dropout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmee_flash_attention_packed_train_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, void* o, void* lse, int B, int S, int H, int P,
    float scale, int seed, float keep, float inv_keep, int dropout,
    void* stream) {
  const dim3 grid(P / kBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  if (bias_is_bf16) {
    train_fwd_kernel<bf16><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, static_cast<const bf16*>(bias), op, lp, S, H, P, scale,
        seed, keep, inv_keep, dropout);
  } else {
    train_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, static_cast<const float*>(bias), op, lp, S, H, P, scale,
        seed, keep, inv_keep, dropout);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mmee_flash_attention_packed_train_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, const void* dout, const void* o, const void* lse,
    const void* gbias, void* dq, void* dk, void* dv, void* dbias, void* delta,
    int B, int S, int H, int P, float scale, int seed, float keep,
    float inv_keep, int dropout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  const bf16* op = static_cast<const bf16*>(o);
  const float* lp = static_cast<const float*>(lse);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  float* dlt = static_cast<float*>(delta);
  if (bias_is_bf16) {
    return launch_bwd<bf16>(qp, kp, vp, bias, dp, op, lp, gbias, dqp, dkp, dvp,
                            dbias, dlt, B, S, H, P, scale, seed, keep, inv_keep,
                            dropout, st);
  }
  return launch_bwd<float>(qp, kp, vp, bias, dp, op, lp, gbias, dqp, dkp, dvp,
                           dbias, dlt, B, S, H, P, scale, seed, keep, inv_keep,
                           dropout, st);
}

namespace {

template <typename BiasT>
int launch_bwd_tables(const bf16* q, const bf16* k, const bf16* v, const void* bias,
                      const bf16* dout, const bf16* o, const float* lse,
                      const int* pos, const int* cx, const int* cy,
                      const int* lut1, const int* lut2, bf16* dq, bf16* dk,
                      bf16* dv, float* delta, float* partial, float* tables,
                      int B, int S, int H, int P, float scale, int seed,
                      float keep, float inv_keep, int dropout, int nb1,
                      int nb2, int max1, int max2, cudaStream_t st) {
  const BiasT* bp = static_cast<const BiasT*>(bias);
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int n_bins = nb1 + 2 * nb2;
  const size_t smem = sizeof(float) * (kBQ * (kBK + 1) + static_cast<size_t>(n_bins) * kBQ) +
                      sizeof(int) * (max1 + 1 + max2 + 1);
  auto kernel = train_bwd_dq_tables_kernel<BiasT>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  kernel<<<dim3(n_qb, H, B), kThreads, smem, st>>>(
      q, k, v, bp, dout, o, lse, pos, cx, cy, lut1, lut2, dq, delta, partial,
      S, H, P, scale, seed, keep, inv_keep, dropout, nb1, nb2, max1, max2);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  train_bwd_dkv_kernel<BiasT><<<dim3(n_qb, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, lse, delta, dk, dv, S, H, P, scale, seed, keep,
      inv_keep, dropout);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  table_partials_sum_kernel<<<H, 256, 0, st>>>(partial, tables, B, H, n_qb, n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq, dk, dv and the (nb1 + 2 * nb2, H) table gradients (dT1, then dTx,
// dTy) in three kernels: (A') dq, delta and per-CTA table partials, (B) dk
// and dv, and the fixed-order sum of the partials. `partial` is scratch of
// B * H * ceil(S / 64) * (nb1 + 2 * nb2) floats.
extern "C" int mmee_flash_attention_packed_train_bwd_tables(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, const void* dout, const void* o, const void* lse,
    const void* pos, const void* cx, const void* cy, const void* lut1,
    const void* lut2, void* dq, void* dk, void* dv, void* delta,
    void* partial, void* tables, int B, int S, int H, int P, float scale,
    int seed, float keep, float inv_keep, int dropout, int nb1, int nb2,
    int max1, int max2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  const bf16* op = static_cast<const bf16*>(o);
  const float* lp = static_cast<const float*>(lse);
  const int* ps = static_cast<const int*>(pos);
  const int* xs = static_cast<const int*>(cx);
  const int* ys = static_cast<const int*>(cy);
  const int* l1 = static_cast<const int*>(lut1);
  const int* l2 = static_cast<const int*>(lut2);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  float* dlt = static_cast<float*>(delta);
  float* part = static_cast<float*>(partial);
  float* tab = static_cast<float*>(tables);
  if (bias_is_bf16) {
    return launch_bwd_tables<bf16>(qp, kp, vp, bias, dp, op, lp, ps, xs, ys, l1, l2,
                                   dqp, dkp, dvp, dlt, part, tab, B, S, H, P, scale,
                                   seed, keep, inv_keep, dropout, nb1, nb2, max1,
                                   max2, st);
  }
  return launch_bwd_tables<float>(qp, kp, vp, bias, dp, op, lp, ps, xs, ys, l1, l2,
                                  dqp, dkp, dvp, dlt, part, tab, B, S, H, P, scale,
                                  seed, keep, inv_keep, dropout, nb1, nb2, max1,
                                  max2, st);
}
