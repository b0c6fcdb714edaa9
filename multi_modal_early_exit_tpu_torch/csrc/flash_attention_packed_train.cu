// flash_attention_packed_train: the forward and backward of
// softmax(q k^T * d^-1/2 + bias) v on the packed (B, S, H*D) layout, with
// position-hash dropout on the probabilities, and the same forward and
// backward on the head form, (B, H, S, D) tensors given by their strides.
// The forward without lse and dropout is also flash_attention_packed, the
// deterministic attention of the serving path.
//
// Replaces six TPU kernels of multi_modal_early_exit_tpu/ops/flash_attention.py:
// `_attn_fwd_packed_kernel` (:446, behind `flash_attention_packed` :490),
// `_attn_fwd_packed_train_kernel` (:607, behind `_flash_packed_train_fwd_impl`
// :753), `_attn_bwd_packed_kernel` (:652, behind `_flash_packed_bwd_impl`
// :812), the latter in its plain and its chained form (dbias = gbias + ds),
// `_attn_bwd_packed_tables_kernel` (:1038, behind
// `_flash_packed_bwd_tables_impl` :1186), the backward that reduces ds
// straight into the three relative-position tables, and the head-form pair
// `_attn_fwd_kernel` (:73, behind `_flash_attention_fwd_impl` :162) and
// `_attn_bwd_fused_kernel` (:231, behind `_flash_attention_bwd_impl` :296).
//
// Every kernel takes its operands (q, k, v, o, do and the gradients) in
// bf16 or in f32, a template parameter T; the bias is bf16 or f32 on its
// own. As in the TPU kernels, the products multiply in the operands' type
// with f32 accumulation: bf16 on the bf16 tensor cores, f32 by 3xTF32
// (common.cuh) on the TF32 ones, good to about f32's precision. The f32
// instantiations round nothing that the bf16 ones round to the operand
// type: p before p.v, p.c before dv, ds before dq and dk.
//
// One body serves both layouts. The forward, dq and dk/dv bodies take each
// operand's (batch, head, row) element strides; the packed kernels pass the
// strides of (B, S, H*D), (S*H*D, D, H*D), and the head-form kernels the
// caller's. The packed projections' transposed view is a head-form tensor,
// so the backward of the inference op (the JAX package's `_packed_bwd`)
// runs the head-form kernels on them with no copy. The head-form backward
// computes delta = rowsum(do * o) in its dq kernel, as the packed one does;
// the TPU kernel takes it from XLA. The same function.
//
// Bound on an H100, at B=16, S=P=768, H=12, D=64, bf16: both are bound by
// the (B, H, P, P) bias traffic. The forward must read the bias (226.5 MB)
// and q/k/v and write o (75.5 MB) and the f32 lse (0.6 MB): 90 us at
// 3.35 TB/s, against 29 us for its 2.9e10 FLOPs at the 989 TFLOP/s bf16
// peak. The chained backward must read bias and gbias and write dbias
// (679.5 MB), read q/k/v/o/do and write dq/dk/dv (151 MB): 248 us, against
// 73 us for its 7.25e10 FLOPs. In f32 the bytes double, and the FLOPs run
// at 165 TFLOP/s (the 495 TF32 TFLOP/s over 3 passes): the forward 181 us
// by bytes against 176 us by operations.
//
// Forward design (sm_90a). Its time is how well the bias and k/v streams are
// kept in flight, so one CTA per (128-row q tile, head, batch) runs three
// roles: a producer warp that issues TMA copies and two consumer
// warpgroups of 64 rows each.
// - A ring of kFwdStages shared-memory stages, each holding one 64-key
//   block's k tile, v tile and the two warpgroups' bias tiles, filled by TMA
//   (cp.async.bulk.tensor) and completed on mbarriers; the consumers release
//   a stage with one arrival per warp. So the next block's bias is always in
//   flight while this block computes, and no thread spends registers or
//   instructions on a copy. q/k/v use one 4-D map each, (D, rows, H, B) at
//   the operand's strides, which serves the packed and the head-form layout
//   alike; the bias a 2-D map over (B*H*P rows, P columns). Rows at or past
//   S come back as zeros; keys j >= S are still set to -inf.
// - Every tile is 128-byte swizzled. The bias is read in the accumulator's
//   (row g / g+8, columns 2t, 2t+1) pattern through the swizzle, so the 8
//   rows of a fragment fall on different banks (unswizzled, all 8 share one).
//   An f32 tile (bias or operand) takes two 32-column boxes per block.
// - bf16: the products run on wgmma: S = q k^T (m64n64k16, q and k from
//   shared memory), then O += P v with P from registers (the S accumulator,
//   rounded to bf16, is already wgmma's A layout) and v read in its stored
//   [key][d] layout as a transposed (MN-major) B: no transposed copy. ptxas
//   fits every role in 96 registers without spills at two CTAs per SM, so
//   no setmaxnreg rebalancing: an increase the CTA's register pool cannot
//   meet blocks its warpgroup for good.
// - f32: wgmma takes tf32 only K-major, and P v reads v MN-major, so the
//   consumers run mma.sync m16n8k8 by 3xTF32 on the same ring, each warp on
//   the same 16 rows as under wgmma, so the softmax code is shared. The P v
//   step sums its 8 keys in a permuted order (common.cuh, mma_acc_by_rows)
//   so that the S accumulators serve as A fragments with no shuffle. The
//   ring is 161 KB with an f32 bias: one CTA per SM.
// - When P / 64 is odd the last tile has 64 real rows: the producer loads
//   only the live warpgroups' q and bias, so nothing past P is read; a
//   warpgroup whose rows all lie at or past S only writes their lse.
// - Dropout and the lse are template parameters: the rate-0 instantiation
//   has no hash, flash_attention_packed's stores no lse. The mask bits of a
//   block are made before its stage is waited for, so the hash overlaps the
//   loads in flight.
// - At rate 0 the lse and no-lse instantiations run the same arithmetic, so
//   the training forward gives flash_attention_packed's bits, which the
//   training schedules that run one or the other rely on; in bf16 that is
//   also the arithmetic of fused_bias_attention.cu (expf, x = s * scale +
//   bias, p rounded to bf16 unnormalised, the row sums in the same order).
//
// Backward design. Each CTA holds 64 rows as 4 warps of 16 and runs its
// products on the tensor cores with mma.sync (bf16 m16n8k16, or f32 by
// 3xTF32 m16n8k8), f32 accumulation. Scores and probabilities never leave
// the chip; the bias is read straight into registers. The forward's online
// softmax gives lse = m + log(sum), which excludes the dropout factor
// c(i, j) (it multiplies the unnormalised exp before the p.v product, and
// the division by the undropped row sum makes that equal to dropout applied
// to the normalised p).
// - Backward, deterministic (no float atomics), in two kernels that each
//   recompute p = exp(s - lse):
//   (A) one CTA per (64-row q block over all P rows, head, batch) computes
//       delta = rowsum(do * o) for its rows, walks every key block and
//       writes dbias = ds (+ gbias) for the whole P x P plane (zero past S),
//       and dq = ds k * scale; it also writes delta (B, H, P) f32 for (B);
//   (B) one CTA per (64-key block, head, batch) walks every q block and
//       accumulates dv = (p c)^T do and dk = ds^T q * scale in registers.
//   In bf16, ds is rounded to bf16 before the dq/dk products and p c before
//   dv, as the TPU kernel does; dk/dv accumulate in f32 and are rounded
//   once. bf16 B operands read MN-major come from transposed shared copies
//   (ldmatrix-free 32-bit loads of bf16 pairs); f32 B fragments are single
//   elements, so the f32 instantiation reads every tile as stored.
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

#include "sm90.cuh"

namespace {

constexpr int kD = 64;       // head dim
constexpr int kBQ = 64;      // rows per CTA (4 warps x 16)
constexpr int kBK = 64;      // columns per block
constexpr int kLD = kD + 8;  // shared row pitch in bf16 (144 B)
constexpr int kThreads = 128;

typedef __nv_bfloat16 bf16;

// the f32 overloads of common.cuh beside this file's bf16 ones
using ::load_a_frags;
using ::mma_rows_by_tile;

// the pitch of a [row][d] shared tile of T
template <typename T>
constexpr int kPitch = kIsF32<T> ? kLD32 : kLD;

// this warp's A fragments of 16 rows over d: 4 k steps of bf16 pairs, or 8
// k steps of raw f32 values (split into tf32 at each product)
template <typename T>
struct AFrags {
  typedef uint32_t type[4][4];
};
template <>
struct AFrags<float> {
  typedef float type[8][4];
};

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
  __device__ __forceinline__ bool keeps(int i, int j) const {
    const uint32_t bits = lowbias32(state + static_cast<uint32_t>(i) * 0x85EBCA77u +
                                    static_cast<uint32_t>(j) * 0x27D4EB2Fu);
    return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) < keep;
  }
  __device__ __forceinline__ float scale(int i, int j) const {
    return keeps(i, j) ? inv_keep : 0.0f;
  }
};

// element strides of one (B, H, rows, D) operand; d has stride 1
struct Strides {
  long long b, h, s;
};

// the packed (B, S, H*D) layout seen as (B, H, S, D); computed by the
// launchers and passed as a kernel argument, as the head form's strides are
// (computed in the kernel, the forward measured 19 % slower on an H100)
Strides packed_strides(int S, int H) {
  return Strides{static_cast<long long>(S) * H * kD, kD, static_cast<long long>(H) * kD};
}

// the (b, h) plane of an operand
template <typename T>
__device__ __forceinline__ T* plane_of(T* x, const Strides& st, int b, int h) {
  return x + b * st.b + h * st.h;
}

// rows [r0, r0 + 64) of a plane with row stride `rs` into a [row][d]
// shared tile at T's pitch; rows >= limit read as zero
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int limit, long long rs,
                                          int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
  for (int idx = tid; idx < 64 * (kD / kVec); idx += kThreads) {
    const int r = idx / (kD / kVec), c = (idx % (kD / kVec)) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    }
    *reinterpret_cast<uint4*>(&dst[r * kPitch<T> + c]) = val;
  }
}

// the same rows into a bf16 [row][d] tile and its transpose [d][row]
__device__ __forceinline__ void load_rows_both(bf16* dst, bf16* dst_t,
                                               const bf16* src, int r0,
                                               int limit, long long rs, int tid) {
  for (int idx = tid; idx < 64 * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    }
    *reinterpret_cast<uint4*>(&dst[r * kLD + c]) = val;
    const bf16* ve = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst_t[(c + e) * kLD + r] = ve[e];
  }
}

// this warp's 16 rows of a bf16 [row][d] tile as mma A fragments (4 k-steps)
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

// acc[nt] (16 x 64) = A (16 x 64 over d) times tile^T, tile [col][d] bf16
// (the f32 overload is in common.cuh)
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
// rounded to bf16) times tile_t^T, tile_t [d][column] bf16
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

// 16 x 64 f32 accumulators, times `mul`, stored as T at rows `row` of a
// plane with row stride `rs`
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[8][4],
                                           const int (&row)[2], int limit, long long rs,
                                           float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= limit) continue;
    T* orow = dst + row[r] * rs;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      store_pair(orow + dt * 8 + 2 * t, acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward (sm_90a): a TMA-fed ring of k/v/bias stages; wgmma consumers in
// bf16, mma.sync (3xTF32) consumers in f32
// ---------------------------------------------------------------------------

constexpr int kFwdStages = 2;        // depth of the shared-memory ring
constexpr int kFwdRows = 128;        // query rows per CTA: 2 consumer warpgroups of 64
constexpr int kFwdConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kFwdThreads = kFwdConsumers + 32;  // and one producer warp

// a 64-row x 64-column tile of T as TMA writes it: one box of 128-byte rows
// in bf16, two (32 columns each, 8 KB apart) in f32
template <typename T>
struct Tile {
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));
  static constexpr int kBoxes = 64 / kBoxCols;
  static constexpr int kBytes = 64 * 64 * static_cast<int>(sizeof(T));
};

// q (both warpgroups' rows), then the ring; each stage k, v and the two
// warpgroups' bias tiles; 1 KB for alignment. bf16 throughout: 81 KB, two
// CTAs per SM; f32 throughout: 161 KB, one
template <typename T, typename BiasT>
struct FwdSmem {
  static constexpr int kQ = 2 * Tile<T>::kBytes;
  static constexpr int kStage = 2 * Tile<T>::kBytes + 2 * Tile<BiasT>::kBytes;
  static constexpr int kBytes = 1024 + kQ + kFwdStages * kStage;
};

// q, k, v as (D, rows, H, B) maps by the operand's strides, boxes of
// 64 rows; the bias as a (P, B*H*P) map, boxes of 64 rows
struct FwdMaps {
  CUtensorMap q, k, v, bias;
};

// bias (row lr, keys 8nt + 2t, +1) of a warpgroup's 128-byte-swizzled
// tile: the 16-byte chunk c of row lr sits at chunk c ^ (lr % 8), so the 8
// rows of an accumulator fragment fall on 8 different bank groups
__device__ __forceinline__ float2 bias_pair(const bf16* tile, int lr, int nt, int t) {
  const char* row = reinterpret_cast<const char*>(tile) + lr * 128;
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(row + ((nt ^ (lr & 7)) << 4) + 4 * t);
  return make_float2(__low2float(v), __high2float(v));
}
__device__ __forceinline__ float2 bias_pair(const float* tile, int lr, int nt, int t) {
  // columns 0-31 in the first 8 KB box, 32-63 in the second
  const char* row = reinterpret_cast<const char*>(tile) + (nt >> 2) * 8192 + lr * 128;
  const int chunk = (nt & 3) * 2 + (t >> 1);
  return *reinterpret_cast<const float2*>(row + ((chunk ^ (lr & 7)) << 4) + 8 * (t & 1));
}

// element (r, c) of a 64 x 64 f32 tile in two 32-column, 128-byte-swizzled
// boxes. The fragment reads below hit 32 distinct banks: q/k rows g with
// columns 8ks + t (chunk 2ks ^ g), v rows 8ks + 2t (+1) with columns
// 8dt + g (chunk (2dt + g / 4) ^ 2t (+1))
__device__ __forceinline__ float sw32(const float* tile, int r, int c) {
  const char* row = reinterpret_cast<const char*>(tile) + (c >> 5) * 8192 + r * 128;
  return *reinterpret_cast<const float*>(row + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                                         4 * (c & 3));
}

template <typename T>
struct FwdOccupancy {
  static constexpr int kCtas = kIsF32<T> ? 1 : 2;  // CTAs per SM the ring allows
};

// One CTA per (128-row q tile, head, batch): warps 0-7 are two consumer
// warpgroups of 64 rows, warp 8 the producer. The producer loads q once and
// then streams each 64-key block's k, v and bias tiles into a ring of
// kFwdStages stages by TMA; the consumers wait for a stage, run S = q k^T,
// the online softmax in registers, O += P v with v in its stored [key][d]
// layout, and release the stage. A warpgroup whose rows all lie at or past
// S only writes their lse (+inf), and nothing without kLse.
template <typename T, typename BiasT, bool kDropout, bool kLse>
__global__ void __launch_bounds__(kFwdThreads, FwdOccupancy<T>::kCtas) fwd_kernel(
    const __grid_constant__ FwdMaps maps,
    T* __restrict__ o,        // (B, H, S, D) by strides
    float* __restrict__ lse,  // (B, H, P), or null without kLse
    Strides so, int S, int H, int P, float scale, int seed, float keep, float inv_keep) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kTile = Tile<T>::kBytes;
  constexpr int kBias = Tile<BiasT>::kBytes;
  constexpr int kQBytes = FwdSmem<T, BiasT>::kQ;
  constexpr int kStage = FwdSmem<T, BiasT>::kStage;
  extern __shared__ uint8_t fwd_smem_raw[];
  __shared__ uint64_t full_bar[kFwdStages], empty_bar[kFwdStages], q_bar;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fwd_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int plane = b * H + h;
  float* lse_bh = kLse ? lse + static_cast<size_t>(plane) * P : nullptr;
  const int n_live = q0 + 64 < S ? 2 : (q0 < S ? 1 : 0);  // warpgroups with a row < S
  if (n_live == 0) {  // pad rows only
    if constexpr (kLse) {
      for (int r = threadIdx.x; r < kFwdRows && q0 + r < P; r += kFwdThreads) {
        lse_bh[q0 + r] = INFINITY;
      }
    }
    return;
  }
  const int n_kb = (S + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * n_live);  // one arrival per consumer warp
    }
    mbar_init(&q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumers) {
    // ---- producer warp: one thread issues every copy ----
    if (threadIdx.x == kFwdConsumers) {
      tma_prefetch_map(&maps.q);
      tma_prefetch_map(&maps.k);
      tma_prefetch_map(&maps.v);
      tma_prefetch_map(&maps.bias);
      mbar_expect_tx(&q_bar, n_live * kTile);
      for (int w = 0; w < n_live; ++w) {
#pragma unroll
        for (int c = 0; c < Tile<T>::kBoxes; ++c) {
          tma_load_4d(smem + w * kTile + c * 8192, &maps.q, &q_bar, c * Tile<T>::kBoxCols,
                      q0 + 64 * w, h, b);
        }
      }
      const uint32_t stage_tx = 2 * kTile + n_live * kBias;
      for (int kb = 0; kb < n_kb; ++kb) {
        const int stage = kb % kFwdStages;
        if (kb >= kFwdStages) mbar_wait(&empty_bar[stage], ((kb / kFwdStages) - 1) & 1);
        uint8_t* st = smem + kQBytes + stage * kStage;
        uint64_t* bar = &full_bar[stage];
        mbar_expect_tx(bar, stage_tx);
#pragma unroll
        for (int c = 0; c < Tile<T>::kBoxes; ++c) {
          tma_load_4d(st + c * 8192, &maps.k, bar, c * Tile<T>::kBoxCols, kb * kBK, h, b);
          tma_load_4d(st + kTile + c * 8192, &maps.v, bar, c * Tile<T>::kBoxCols, kb * kBK, h,
                      b);
        }
        for (int w = 0; w < n_live; ++w) {
#pragma unroll
          for (int c = 0; c < Tile<BiasT>::kBoxes; ++c) {
            tma_load_2d(st + 2 * kTile + w * kBias + c * 8192, &maps.bias, bar,
                        kb * kBK + c * Tile<BiasT>::kBoxCols, plane * P + q0 + 64 * w);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int ct = threadIdx.x % 128;
  if (wg >= n_live) {  // rows q0 + 64 .. q0 + 127, all at or past S
    if constexpr (kLse) {
      if (ct < 64 && q0 + 64 + ct < P) lse_bh[q0 + 64 + ct] = INFINITY;
    }
    return;
  }
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows within the warpgroup
  const int row[2] = {q0 + 64 * wg + lr[0], q0 + 64 * wg + lr[1]};
  const Dropout drop(seed, plane, keep, inv_keep);

  // accumulator fragment (nt, e) at 4 nt + e: row g + 8 (e >> 1), column
  // 8 nt + 2t + (e & 1), as mma.sync's n-tiles lay it out
  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  // bf16: K-major q and k tiles, 8-row atoms 1 KB apart, a 16-wide k step
  // 32 bytes on; MN-major v: the same atoms, a 16-key k step 2 KB on
  const uint64_t q_desc = wgmma_desc(smem + wg * kTile, 16, 1024);
  mbar_wait(&q_bar, 0);
  float qa[8][4];  // f32: this warp's q rows as raw A values, 8 k steps over d
  if constexpr (kF32) {
    const float* q_tile = reinterpret_cast<const float*>(smem + wg * kTile);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      qa[ks][0] = sw32(q_tile, lr[0], ks * 8 + t);
      qa[ks][1] = sw32(q_tile, lr[1], ks * 8 + t);
      qa[ks][2] = sw32(q_tile, lr[0], ks * 8 + t + 4);
      qa[ks][3] = sw32(q_tile, lr[1], ks * 8 + t + 4);
    }
  }

  // bf16: each block's O += P v runs while the next block's stage is waited
  // for and its S = q k^T is issued: the P v group is waited for (and its
  // stage released) only before the accumulators are rescaled. f32: the
  // products are synchronous, and a warp releases the stage after its P v.
  uint32_t pa[4][4];  // bf16: P of the block in flight, wgmma's A registers
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    const int stage = kb % kFwdStages;
    uint32_t kept = 0;  // the dropout mask of this block, made while its loads fly
    if constexpr (kDropout) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        kept |= static_cast<uint32_t>(drop.keeps(row[(i >> 1) & 1], col)) << i;
      }
    }
    mbar_wait(&full_bar[stage], (kb / kFwdStages) & 1);
    const uint8_t* st = smem + kQBytes + stage * kStage;
    const BiasT* bias_tile = reinterpret_cast<const BiasT*>(st + 2 * kTile + wg * kBias);

    // S = q k^T over d
    if constexpr (kF32) {
      const float* k_tile = reinterpret_cast<const float*>(st);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t hi[4], lo[4];
        split_frag(qa[ks], hi, lo);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int kr = nt * 8 + g;
          mma_3xtf32(&s[4 * nt], hi, lo, sw32(k_tile, kr, ks * 8 + t),
                     sw32(k_tile, kr, ks * 8 + t + 4));
        }
      }
    } else {
      const uint64_t k_desc = wgmma_desc(st, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_m64n64k16_ss(s, q_desc + 2 * ks, k_desc + 2 * ks, ks);
      }
      wgmma_commit();
      if (kb > 0) {  // the previous block's P v is done: release its stage
        wgmma_wait<1>();
        reg_fence(acc);
        reg_fence(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[(kb - 1) % kFwdStages]);
      }
      wgmma_wait<0>();
      reg_fence(s);
    }

    // scale + bias in f32; keys >= S (in the last block only) masked out.
    // Rows >= S take whatever bias lies there: they are neither stored nor
    // mixed with other rows.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv2 = bias_pair(bias_tile, lr[r], nt, t);
        s[4 * nt + 2 * r] = s[4 * nt + 2 * r] * scale + bv2.x;
        s[4 * nt + 2 * r + 1] = s[4 * nt + 2 * r + 1] * scale + bv2.y;
      }
    }
    if (k0 + kBK > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
      }
    }
    // running row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
        float p = expf(s[4 * nt + e] - m_use[e >> 1]);
        rs[e >> 1] += p;  // the row sum (and so the lse) excludes dropout
        if constexpr (kDropout) p *= (kept >> (4 * nt + e)) & 1u ? inv_keep : 0.0f;
        s[4 * nt + e] = p;
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
      acc[4 * dt + 0] *= alpha[0];
      acc[4 * dt + 1] *= alpha[0];
      acc[4 * dt + 2] *= alpha[1];
      acc[4 * dt + 3] *= alpha[1];
    }

    if constexpr (kF32) {
      // O += P v, P not rounded; k step ks takes keys 8ks + 2t and 2t + 1
      // as its k t and t + 4 (the S accumulators' own columns)
      const float* v_tile = reinterpret_cast<const float*>(st + kTile);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const float a[4] = {s[4 * ks], s[4 * ks + 2], s[4 * ks + 1], s[4 * ks + 3]};
        uint32_t hi[4], lo[4];
        split_frag(a, hi, lo);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          mma_3xtf32(&acc[4 * dt], hi, lo, sw32(v_tile, ks * 8 + 2 * t, dt * 8 + g),
                     sw32(v_tile, ks * 8 + 2 * t + 1, dt * 8 + g));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[stage]);
    } else {
      // O += P v: the score accumulators, rounded to bf16, are wgmma's A
      // registers; v is read [key][d] as a transposed (MN-major) B
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        pa[ks][0] = pack_bf16x2(s[8 * ks + 0], s[8 * ks + 1]);  // row g,   keys 16ks + 2t
        pa[ks][1] = pack_bf16x2(s[8 * ks + 2], s[8 * ks + 3]);  // row g+8
        pa[ks][2] = pack_bf16x2(s[8 * ks + 4], s[8 * ks + 5]);  // row g,   keys 16ks + 8 + 2t
        pa[ks][3] = pack_bf16x2(s[8 * ks + 6], s[8 * ks + 7]);  // row g+8
      }
      const uint64_t v_desc = wgmma_desc(st + kTile, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_m64n64k16_rs_tb(acc, pa[ks], v_desc + ks * (2048 >> 4));
      }
      wgmma_commit();
    }
  }
  if constexpr (!kF32) {
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
  }

  // o / l at the caller's strides; lse = m + log(l), +inf past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kLse) {
      if (t == 0) lse_bh[row[r]] = row[r] < S ? m_run[r] + logf(l_run[r]) : INFINITY;
    }
    if (row[r] >= S) continue;
    const float inv = 1.0f / l_run[r];
    T* orow = o + b * so.b + h * so.h + row[r] * so.s;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      store_pair(orow + dt * 8 + 2 * t, acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
    }
  }
}

template <typename T>
constexpr CUtensorMapDataType kMapType =
    kIsF32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// the tensor map of a (B, H, rows, D) operand at its element strides
template <typename T>
int encode_operand(CUtensorMap* map, const T* x, const Strides& st, int rows, int H, int B) {
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * sizeof(T),
                                 static_cast<cuuint64_t>(st.h) * sizeof(T),
                                 static_cast<cuuint64_t>(st.b) * sizeof(T)};
  const cuuint32_t box[4] = {Tile<T>::kBoxCols, 64, 1, 1};
  return encode_map(map, kMapType<T>, 4, x, dims, strides, box);
}

template <typename T, typename BiasT, bool kDropout, bool kLse>
int launch_fwd_kernel(const FwdMaps& maps, T* o, float* lse, const Strides& so, int B, int S,
                      int H, int P, float scale, int seed, float keep, float inv_keep,
                      cudaStream_t st) {
  constexpr int smem = FwdSmem<T, BiasT>::kBytes;
  auto kernel = fwd_kernel<T, BiasT, kDropout, kLse>;
  static std::atomic<uint64_t> ready{0};
  const int err = set_smem_limit_once(kernel, smem, ready);
  if (err != 0) return err;
  kernel<<<dim3((P + kFwdRows - 1) / kFwdRows, H, B), kFwdThreads, smem, st>>>(
      maps, o, lse, so, S, H, P, scale, seed, keep, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// with_lse = 0 is flash_attention_packed: no dropout, no lse (lse unused)
template <typename T, typename BiasT>
int launch_fwd(const T* q, const T* k, const T* v, const void* bias, T* o, float* lse,
               const Strides& sq, const Strides& sk, const Strides& sv, const Strides& so,
               int B, int S, int H, int P, float scale, int seed, float keep, float inv_keep,
               int dropout, int with_lse, cudaStream_t st) {
  if (!with_lse && dropout) return static_cast<int>(cudaErrorInvalidValue);
  FwdMaps maps;
  int err = encode_operand(&maps.q, q, sq, S, H, B);
  if (err == 0) err = encode_operand(&maps.k, k, sk, S, H, B);
  if (err == 0) err = encode_operand(&maps.v, v, sv, S, H, B);
  if (err == 0) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(P),
                                static_cast<cuuint64_t>(B) * H * static_cast<cuuint64_t>(P)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(P) * sizeof(BiasT)};
    const cuuint32_t box[2] = {Tile<BiasT>::kBoxCols, 64};
    err = encode_map(&maps.bias, kMapType<BiasT>, 2, bias, dims, strides, box);
  }
  if (err != 0) return err;
  if (!with_lse) {
    return launch_fwd_kernel<T, BiasT, false, false>(maps, o, nullptr, so, B, S, H, P, scale,
                                                     seed, keep, inv_keep, st);
  }
  return dropout ? launch_fwd_kernel<T, BiasT, true, true>(maps, o, lse, so, B, S, H, P, scale,
                                                           seed, keep, inv_keep, st)
                 : launch_fwd_kernel<T, BiasT, false, true>(maps, o, lse, so, B, S, H, P,
                                                            scale, seed, keep, inv_keep, st);
}

// calls fn(T{}, BiasT{}) with the operand and bias types the flags name
template <typename Fn>
int by_types(int qkv_is_bf16, int bias_is_bf16, Fn&& fn) {
  if (qkv_is_bf16) return bias_is_bf16 ? fn(bf16{}, bf16{}) : fn(bf16{}, 0.0f);
  return bias_is_bf16 ? fn(0.0f, bf16{}) : fn(0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// backward (A): delta, dbias (= ds, + gbias when chained) and dq
// ---------------------------------------------------------------------------

// delta[i] = sum_d do[i, d] * o[i, d] in f32 for row i of a (b, h) plane
template <typename T>
__device__ __forceinline__ float row_delta(const T* dr, const T* orow) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kD; c += kVec) {
    const uint4 dv = *reinterpret_cast<const uint4*>(dr + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
    const T* de = reinterpret_cast<const T*>(&dv);
    const T* oe = reinterpret_cast<const T*>(&ov);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc += mmee_to_float(de[e]) * mmee_to_float(oe[e]);
  }
  return acc;
}

// dq += ds k over one key block: bf16 rounds ds and reads the transposed
// k tile, f32 reads k as stored
__device__ __forceinline__ void dq_step(float (&dq)[8][4], const float (&ds)[8][4],
                                        const bf16* s_k, const bf16* s_kt, int g, int t) {
  mma_acc_by_tile_t(dq, ds, s_kt, g, t);
}
__device__ __forceinline__ void dq_step(float (&dq)[8][4], const float (&ds)[8][4],
                                        const float* s_k, const float*, int g, int t) {
  mma_acc_by_rows(dq, ds, s_k, g, t);
}

// shared tiles of the dq kernels: bf16 stages q and do in s_a and keeps k
// transposed in s_kt; f32 stages q and do in s_k and s_v and needs no
// transposed copy (s_a and s_kt are left one element)
template <typename T>
struct DqTiles {
  static constexpr int kA = kIsF32<T> ? 1 : kBQ * kLD;
  static constexpr int kKt = kIsF32<T> ? 1 : kD * kLD;
  static constexpr int kRows = 64 * kPitch<T>;
};

// this warp's q and do rows as A fragments, through the shared tiles
template <typename T>
__device__ __forceinline__ void load_q_do_frags(typename AFrags<T>::type& qa,
                                                typename AFrags<T>::type& da, T* s_a, T* s_k,
                                                T* s_v, const T* qp, const T* dop, int q0,
                                                int S, long long q_rs, long long do_rs,
                                                int tid, int wr, int g, int t) {
  if constexpr (kIsF32<T>) {
    load_rows(s_k, qp, q0, S, q_rs, tid);
    load_rows(s_v, dop, q0, S, do_rs, tid);
    __syncthreads();
    load_a_frags(qa, s_k, wr, g, t);
    load_a_frags(da, s_v, wr, g, t);
  } else {
    load_rows(s_a, qp, q0, S, q_rs, tid);
    __syncthreads();
    load_a_frags(qa, s_a, wr, g, t);
    __syncthreads();
    load_rows(s_a, dop, q0, S, do_rs, tid);
    __syncthreads();
    load_a_frags(da, s_a, wr, g, t);
  }
}

// one key block's k (and, in bf16, its transpose) and v
template <typename T>
__device__ __forceinline__ void load_k_v(T* s_k, T* s_kt, T* s_v, const T* kp, const T* vp,
                                         int k0, int S, long long k_rs, long long v_rs,
                                         int tid) {
  if constexpr (kIsF32<T>) {
    load_rows(s_k, kp, k0, S, k_rs, tid);
  } else {
    load_rows_both(s_k, s_kt, kp, k0, S, k_rs, tid);
  }
  load_rows(s_v, vp, k0, S, v_rs, tid);
}

template <typename T, typename BiasT>
__device__ __forceinline__ void bwd_dq_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const T* __restrict__ o,
    const float* __restrict__ lse,     // (B, H, P)
    const BiasT* __restrict__ gbias,   // (B, H, P, P) or null
    T* __restrict__ dq,                // (B, H, S, D) by strides
    BiasT* __restrict__ dbias,         // (B, H, P, P)
    float* __restrict__ delta,         // (B, H, P), written here
    const Strides& sq, const Strides& sk, const Strides& sv, const Strides& sdo,
    const Strides& so, const Strides& sdq,
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  __shared__ __align__(16) T s_a[DqTiles<T>::kA];      // bf16: q, then do
  __shared__ __align__(16) T s_k[DqTiles<T>::kRows];   // [key][d]
  __shared__ __align__(16) T s_kt[DqTiles<T>::kKt];    // bf16: [d][key]
  __shared__ __align__(16) T s_v[DqTiles<T>::kRows];   // [key][d]
  __shared__ float s_delta[kBQ];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t plane = static_cast<size_t>(b) * H + h;
  const T* qp = plane_of(q, sq, b, h);
  const T* kp = plane_of(k, sk, b, h);
  const T* vp = plane_of(v, sv, b, h);
  const T* dop = plane_of(dout, sdo, b, h);
  const int wr = warp * 16;

  // delta of this block's rows, one thread per row
  if (tid < kBQ) {
    const int i = q0 + tid;
    float acc = 0.0f;
    if (i < S) acc = row_delta(dop + i * sdo.s, plane_of(o, so, b, h) + i * so.s);
    s_delta[tid] = acc;
    delta[plane * P + i] = acc;
  }
  typename AFrags<T>::type qa, da;
  load_q_do_frags<T>(qa, da, s_a, s_k, s_v, qp, dop, q0, S, sq.s, sdo.s, tid, wr, g, t);

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
    load_k_v(s_k, s_kt, s_v, kp, vp, k0, S, sk.s, sv.s, tid);
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
    dq_step(dq_acc, s, s_k, s_kt, g, t);  // dq += ds k
  }
  store_rows(plane_of(dq, sdq, b, h), dq_acc, row, S, sdq.s, scale, t);
}

template <typename T, typename BiasT>
__global__ void __launch_bounds__(kThreads) train_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const T* __restrict__ o,
    const float* __restrict__ lse,     // (B, H, P)
    const BiasT* __restrict__ gbias,   // (B, H, P, P) or null
    T* __restrict__ dq,                // (B, S, H*D)
    BiasT* __restrict__ dbias,         // (B, H, P, P)
    float* __restrict__ delta,         // (B, H, P), written here
    Strides st, int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  bwd_dq_body<T, BiasT>(q, k, v, bias, dout, o, lse, gbias, dq, dbias, delta, st, st, st, st,
                        st, st, S, H, P, scale, seed, keep, inv_keep, dropout);
}

template <typename T, typename BiasT>
__global__ void __launch_bounds__(kThreads) headform_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const T* __restrict__ o,
    const float* __restrict__ lse, T* __restrict__ dq, BiasT* __restrict__ dbias,
    float* __restrict__ delta, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides so, Strides sdq, int S, int H, int P, float scale, int seed, float keep,
    float inv_keep, int dropout) {
  bwd_dq_body<T, BiasT>(q, k, v, bias, dout, o, lse, nullptr, dq, dbias, delta, sq, sk, sv,
                        sdo, so, sdq, S, H, P, scale, seed, keep, inv_keep, dropout);
}

// ---------------------------------------------------------------------------
// backward (B): dk and dv
// ---------------------------------------------------------------------------

// dv += (p c)^T do and dk += ds^T q over one query block: bf16 rounds both
// and reads the transposed tiles, f32 reads the tiles as stored
__device__ __forceinline__ void dkv_step(float (&dv)[8][4], float (&dk)[8][4],
                                         const float (&pd)[8][4], const float (&ds)[8][4],
                                         const bf16*, const bf16* s_qt, const bf16*,
                                         const bf16* s_dot, int g, int t) {
  mma_acc_by_tile_t(dv, pd, s_dot, g, t);
  mma_acc_by_tile_t(dk, ds, s_qt, g, t);
}
__device__ __forceinline__ void dkv_step(float (&dv)[8][4], float (&dk)[8][4],
                                         const float (&pd)[8][4], const float (&ds)[8][4],
                                         const float* s_q, const float*, const float* s_do,
                                         const float*, int g, int t) {
  mma_acc_by_rows(dv, pd, s_do, g, t);
  mma_acc_by_rows(dk, ds, s_q, g, t);
}

template <typename T, typename BiasT>
__device__ __forceinline__ void bwd_dkv_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv,  // (B, H, S, D) by strides
    const Strides& sq, const Strides& sk, const Strides& sv, const Strides& sdo,
    const Strides& sdk, const Strides& sdv,
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  constexpr int kT = kIsF32<T> ? 1 : kD * kLD;  // the transposed tiles: bf16 only
  __shared__ __align__(16) T s_q[kBQ * kPitch<T>];  // [query][d]
  __shared__ __align__(16) T s_qt[kT];              // [d][query]
  __shared__ __align__(16) T s_do[kBQ * kPitch<T>]; // [query][d]
  __shared__ __align__(16) T s_dot[kT];             // [d][query]
  __shared__ float s_lse[kBQ];
  __shared__ float s_delta[kBQ];

  const int j0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t plane = static_cast<size_t>(b) * H + h;
  const T* qp = plane_of(q, sq, b, h);
  const T* dop = plane_of(dout, sdo, b, h);
  const int wr = warp * 16;

  typename AFrags<T>::type ka, va;
  load_rows(s_q, plane_of(k, sk, b, h), j0, S, sk.s, tid);
  load_rows(s_do, plane_of(v, sv, b, h), j0, S, sv.s, tid);
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
    if constexpr (kIsF32<T>) {
      load_rows(s_q, qp, i0, S, sq.s, tid);
      load_rows(s_do, dop, i0, S, sdo.s, tid);
    } else {
      load_rows_both(s_q, s_qt, qp, i0, S, sq.s, tid);
      load_rows_both(s_do, s_dot, dop, i0, S, sdo.s, tid);
    }
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
    // dv += (p c)^T do, dk += ds^T q
    dkv_step(dv_acc, dk_acc, st, dpt, s_q, s_qt, s_do, s_dot, g, t);
  }
  store_rows(plane_of(dk, sdk, b, h), dk_acc, key, S, sdk.s, scale, t);
  store_rows(plane_of(dv, sdv, b, h), dv_acc, key, S, sdv.s, 1.0f, t);
}

template <typename T, typename BiasT>
__global__ void __launch_bounds__(kThreads) train_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv,  // (B, S, H*D)
    Strides st, int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  bwd_dkv_body<T, BiasT>(q, k, v, bias, dout, lse, delta, dk, dv, st, st, st, st, st, st, S,
                         H, P, scale, seed, keep, inv_keep, dropout);
}

template <typename T, typename BiasT>
__global__ void __launch_bounds__(kThreads) headform_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout) {
  bwd_dkv_body<T, BiasT>(q, k, v, bias, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk, sdv,
                         S, H, P, scale, seed, keep, inv_keep, dropout);
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

template <typename T, typename BiasT>
__global__ void __launch_bounds__(kThreads) train_bwd_dq_tables_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const BiasT* __restrict__ bias,
    const T* __restrict__ dout, const T* __restrict__ o,
    const float* __restrict__ lse,     // (B, H, P)
    const int* __restrict__ pos, const int* __restrict__ cx,
    const int* __restrict__ cy,        // (B, S)
    const int* __restrict__ lut1, const int* __restrict__ lut2,
    T* __restrict__ dq,                // (B, S, H*D)
    float* __restrict__ delta,         // (B, H, P), rows < S written here
    float* __restrict__ partial,       // (B, H, n_qb, nb1 + 2 * nb2)
    int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    int dropout, int nb1, int nb2, int max1, int max2) {
  __shared__ __align__(16) T s_a[DqTiles<T>::kA];      // bf16: q, then do
  __shared__ __align__(16) T s_k[DqTiles<T>::kRows];   // [key][d]
  __shared__ __align__(16) T s_kt[DqTiles<T>::kKt];    // bf16: [d][key]
  __shared__ __align__(16) T s_v[DqTiles<T>::kRows];   // [key][d]
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

  // delta of this block's rows, one thread per row
  if (tid < kBQ) {
    const int i = q0 + tid;
    float acc = 0.0f;
    if (i < S) {
      const size_t off = batch_off + static_cast<size_t>(i) * hd;
      acc = row_delta(dout + off, o + off);
    }
    s_delta[tid] = acc;
    delta[plane * P + i] = acc;
  }
  typename AFrags<T>::type qa, da;
  load_q_do_frags<T>(qa, da, s_a, s_k, s_v, q + batch_off, dout + batch_off, q0, S, hd, hd,
                     tid, wr, g, t);

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
    load_k_v(s_k, s_kt, s_v, k + batch_off, v + batch_off, k0, S, hd, hd, tid);
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
    dq_step(dq_acc, s, s_k, s_kt, g, t);  // dq += ds k
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

template <typename T, typename BiasT>
int launch_bwd(const T* q, const T* k, const T* v, const void* bias, const T* dout,
               const T* o, const float* lse, const void* gbias, T* dq, T* dk, T* dv,
               void* dbias, float* delta, int B, int S, int H, int P, float scale, int seed,
               float keep, float inv_keep, int dropout, cudaStream_t st) {
  const BiasT* bp = static_cast<const BiasT*>(bias);
  const Strides ps = packed_strides(S, H);
  train_bwd_dq_kernel<T, BiasT><<<dim3(P / kBQ, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, o, lse, static_cast<const BiasT*>(gbias), dq,
      static_cast<BiasT*>(dbias), delta, ps, S, H, P, scale, seed, keep, inv_keep,
      dropout);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  train_bwd_dkv_kernel<T, BiasT><<<dim3((S + kBK - 1) / kBK, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, lse, delta, dk, dv, ps, S, H, P, scale, seed, keep,
      inv_keep, dropout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename BiasT>
int launch_bwd_tables(const T* q, const T* k, const T* v, const void* bias, const T* dout,
                      const T* o, const float* lse, const int* pos, const int* cx,
                      const int* cy, const int* lut1, const int* lut2, T* dq, T* dk, T* dv,
                      float* delta, float* partial, float* tables, int B, int S, int H, int P,
                      float scale, int seed, float keep, float inv_keep, int dropout, int nb1,
                      int nb2, int max1, int max2, cudaStream_t st) {
  const BiasT* bp = static_cast<const BiasT*>(bias);
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int n_bins = nb1 + 2 * nb2;
  const size_t smem = sizeof(float) * (kBQ * (kBK + 1) + static_cast<size_t>(n_bins) * kBQ) +
                      sizeof(int) * (max1 + 1 + max2 + 1);
  auto kernel = train_bwd_dq_tables_kernel<T, BiasT>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  kernel<<<dim3(n_qb, H, B), kThreads, smem, st>>>(
      q, k, v, bp, dout, o, lse, pos, cx, cy, lut1, lut2, dq, delta, partial,
      S, H, P, scale, seed, keep, inv_keep, dropout, nb1, nb2, max1, max2);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  train_bwd_dkv_kernel<T, BiasT><<<dim3(n_qb, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, lse, delta, dk, dv, packed_strides(S, H), S, H, P, scale, seed,
      keep, inv_keep, dropout);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  table_partials_sum_kernel<<<H, 256, 0, st>>>(partial, tables, B, H, n_qb, n_bins);
  return static_cast<int>(cudaGetLastError());
}

// strides[3 * i + {0, 1, 2}]: the (batch, head, row) strides of operand i
Strides strides_at(const long long* strides, int i) {
  return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <typename T, typename BiasT>
int launch_headform_bwd(const T* q, const T* k, const T* v, const void* bias, const T* dout,
                        const T* o, const float* lse, T* dq, T* dk, T* dv, void* dbias,
                        float* delta, const long long* strides, int B, int S, int H, int P,
                        float scale, int seed, float keep, float inv_keep, int dropout,
                        cudaStream_t st) {
  const BiasT* bp = static_cast<const BiasT*>(bias);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3),
                sdo = strides_at(strides, 4), sdq = strides_at(strides, 5),
                sdk = strides_at(strides, 6), sdv = strides_at(strides, 7);
  headform_bwd_dq_kernel<T, BiasT><<<dim3(P / kBQ, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, o, lse, dq, static_cast<BiasT*>(dbias), delta, sq, sk, sv, sdo,
      so, sdq, S, H, P, scale, seed, keep, inv_keep, dropout);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  headform_bwd_dkv_kernel<T, BiasT><<<dim3((S + kBK - 1) / kBK, H, B), kThreads, 0, st>>>(
      q, k, v, bp, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk, sdv, S, H, P, scale,
      seed, keep, inv_keep, dropout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry takes its operands (q, k, v, o, do and the gradients) as
// bf16 (qkv_is_bf16 = 1) or f32 (0), and the bias (and gbias, dbias) as
// bf16 (bias_is_bf16 = 1) or f32 (0).

// flash_attention_packed: o (B, S, H*D), no lse, no dropout; P a multiple
// of 64
extern "C" int mmee_flash_attention_packed(const void* q, const void* k, const void* v,
                                           const void* bias, int bias_is_bf16,
                                           int qkv_is_bf16, void* o, int B, int S, int H,
                                           int P, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ps = packed_strides(S, H);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_fwd<T, decltype(bt)>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), bias, static_cast<T*>(o),
                                       nullptr, ps, ps, ps, ps, B, S, H, P, scale, 0, 1.0f,
                                       1.0f, 0, 0, st);
  });
}

extern "C" int mmee_flash_attention_packed_train_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, int qkv_is_bf16, void* o, void* lse, int B, int S, int H, int P,
    float scale, int seed, float keep, float inv_keep, int dropout,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ps = packed_strides(S, H);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_fwd<T, decltype(bt)>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), bias, static_cast<T*>(o),
                                       static_cast<float*>(lse), ps, ps, ps, ps, B, S, H, P,
                                       scale, seed, keep, inv_keep, dropout, 1, st);
  });
}

extern "C" int mmee_flash_attention_packed_train_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, int qkv_is_bf16, const void* dout, const void* o, const void* lse,
    const void* gbias, void* dq, void* dk, void* dv, void* dbias, void* delta,
    int B, int S, int H, int P, float scale, int seed, float keep,
    float inv_keep, int dropout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_bwd<T, decltype(bt)>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<const T*>(dout), static_cast<const T*>(o), static_cast<const float*>(lse),
        gbias, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dbias,
        static_cast<float*>(delta), B, S, H, P, scale, seed, keep, inv_keep, dropout, st);
  });
}

// dq, dk, dv and the (nb1 + 2 * nb2, H) table gradients (dT1, then dTx,
// dTy) in three kernels: (A') dq, delta and per-CTA table partials, (B) dk
// and dv, and the fixed-order sum of the partials. `partial` is scratch of
// B * H * ceil(S / 64) * (nb1 + 2 * nb2) floats.
extern "C" int mmee_flash_attention_packed_train_bwd_tables(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, int qkv_is_bf16, const void* dout, const void* o, const void* lse,
    const void* pos, const void* cx, const void* cy, const void* lut1,
    const void* lut2, void* dq, void* dk, void* dv, void* delta,
    void* partial, void* tables, int B, int S, int H, int P, float scale,
    int seed, float keep, float inv_keep, int dropout, int nb1, int nb2,
    int max1, int max2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_bwd_tables<T, decltype(bt)>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<const T*>(dout), static_cast<const T*>(o), static_cast<const float*>(lse),
        static_cast<const int*>(pos), static_cast<const int*>(cx), static_cast<const int*>(cy),
        static_cast<const int*>(lut1), static_cast<const int*>(lut2), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(delta),
        static_cast<float*>(partial), static_cast<float*>(tables), B, S, H, P, scale, seed,
        keep, inv_keep, dropout, nb1, nb2, max1, max2, st);
  });
}

// ---------------------------------------------------------------------------
// head form: the forward and the plain backward on (B, H, S, D) operands
// given by their strides
// ---------------------------------------------------------------------------

// o (in the layout `strides` gives it) and lse (B, H, P) f32, +inf past S.
// `strides` is a host array of 12: (batch, head, row) of q, k, v, o.
extern "C" int mmee_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, int bias_is_bf16,
    int qkv_is_bf16, void* o, void* lse, const long long* strides, int B, int S, int H, int P,
    float scale, int seed, float keep, float inv_keep, int dropout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_fwd<T, decltype(bt)>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), bias, static_cast<T*>(o),
                                       static_cast<float*>(lse), sq, sk, sv, so, B, S, H, P,
                                       scale, seed, keep, inv_keep, dropout, 1, st);
  });
}

// dq, dk, dv (in the layouts `strides` gives them) and dbias = ds (B, H, P,
// P), zero past S, in two kernels: (A) delta, dbias and dq, (B) dk and dv.
// `strides` is a host array of 24: (batch, head, row) of q, k, v, o, do, dq,
// dk, dv; `delta` is scratch of B * H * P floats.
extern "C" int mmee_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, int bias_is_bf16,
    int qkv_is_bf16, const void* dout, const void* o, const void* lse, void* dq, void* dk,
    void* dv, void* dbias, void* delta, const long long* strides, int B, int S, int H, int P,
    float scale, int seed, float keep, float inv_keep, int dropout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_headform_bwd<T, decltype(bt)>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<const T*>(dout), static_cast<const T*>(o), static_cast<const float*>(lse),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dbias,
        static_cast<float*>(delta), strides, B, S, H, P, scale, seed, keep, inv_keep, dropout,
        st);
  });
}
