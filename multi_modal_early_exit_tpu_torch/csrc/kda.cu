// kda: the core of Kimi Delta Attention (Kimi-Linear's linear-attention
// layers), chunked: per row b and head h, from a zero state S_0 = 0 at the
// row's first position,
//   S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
//   o_t = S_t^T q_t,
// S a 128 x 128 state (keys by values), g_t <= 0 the per-channel log forget
// gate. q, k, v are (B, S, H, 128) bf16 (q already normalised and scaled),
// g (B, S, H, 128) and beta (B, S, H) f32, all contiguous; o (B, S, H, 128)
// bf16 is written at every position, zeros at and past a row's length.
//
// Replaces no TPU kernel: the JAX package runs no linear attention. No
// library of the port's machine computes it, and composed of torch ops its
// pass over the chunks is a host loop of about 25,000 launches a stage at
// 16,384 positions (ops/kda.py's kda_chunked_plain, the plain version).
//
// The chunked form, chunks of C = 64 positions, within a chunk Gamma_r =
// sum_{i<=r} g_i per channel (so every exponent below is <= 0: no factor
// e^{-Gamma} is ever formed, which would overflow f32 once a chunk's decay
// passes 88):
//   A_ri  = sum_c k_rc k_ic e^{Gamma_rc - Gamma_ic}  (i < r)
//   Qt_ri = sum_c q_rc k_ic e^{Gamma_rc - Gamma_ic}  (i <= r)
//   T     = (I + diag(beta) A)^{-1} diag(beta)
//   Delta = T (V - (K . e^Gamma) S)
//   O     = (Q . e^Gamma) S + Qt Delta
//   S    <- Diag(e^{Gamma_C}) S + (K . e^{Gamma_C - Gamma})^T Delta.
// Column j of Delta, O and the new S depends on column j of S and V alone.
//
// Bound on an H100 at a served batch (4 rows of 4,096-16,384 real tokens, 32
// heads): q, k, v, o in bf16 and g in f32 once each, about 12 bytes a
// channel and token (1.7 GB at 35,000 tokens, 0.52 ms at 3.35 TB/s),
// against about 9 M operations a chunk and head (0.16 ms at 989 TFLOP/s):
// bound by bytes. Two launches read more: the intra kernel reads q, k, g
// and writes T and P (32 KB a chunk and head), which the state kernel reads
// back beside q, k, g (once for each of its two column CTAs) and v: about 4
// GB at 35,000 tokens, 1.2 ms. What binds each launch is its own serial
// work, not the bytes: the intra kernel's pairwise exponentials and FMAs,
// and the state kernel's chain over a row's chunks (its longest row sets
// the time).
//
// Design: two launches a call, whatever the length.
// - kda_intra_kernel, a CTA per (chunk, head, row), 256 threads: the part
//   no state enters, in sub-chunks of 16 rows (FLA's form). Gamma by a scan
//   per channel in registers (log2 units). The four diagonal 16 x 16 blocks
//   of A and Qt pairwise, one exp2 a pair and channel from differences of
//   running sums: 4 x 4 tiles of (r, i) pairs, a tile and a quarter of the
//   channels a thread (warps 0-4), the quarters summed by shuffles. The six
//   blocks below them (r in sub-chunk I, i in an earlier J) as products
//   through J's last row b on the tensor cores (warps 5-7): (K_I e^{Gamma_I
//   - Gamma_b}) (K_J e^{Gamma_b - Gamma_J})^T and the same with Q_I, both
//   exponents <= 0, each f32 operand split into a tf32 high and low part
//   and three mma.sync products summed (3xTF32: f32 accuracy, as the
//   configuration states for A and Qt). T by blocked forward substitution:
//   the four diagonal 16 x 16 blocks solved in f32 at once, a warp each (a
//   lane a column, the later rows' sums updated as each row lands), then
//   the blocks below by 3xTF32 products, one diagonal of blocks at a time:
//   T_IJ = -T_II sum_{J<=K<I} A_IK T_KJ. Last P = Qt T, by 3xTF32 products
//   (lower triangular), so the state pass's O needs X alone. T and P, 64 x
//   64 each, rounded to tf32 (the only form the state pass reads them in)
//   go to a scratch buffer of the row's real chunks (chunks at or past a
//   row's length start no work). 69 KB of shared memory: three CTAs an SM.
// - kda_state_kernel, a CTA per (64 value columns, head, row), 256 threads
//   as two warpgroups, rows taken longest first (the grid's last index is a
//   row's rank by length, so the longest rows' chains start in the first
//   wave): the pass over the row's chunks, in order. A chunk's operands come
//   in by cp.async, each into its own buffer as soon as the previous
//   chunk's use of it ends (k, q and g after the exponentials, v after X, T
//   and P after their products), so every load has most of a chunk step to
//   land; warpgroup 1 issues the k, q, g and T, P copies while warpgroup 0
//   stores X or Delta. The products run on wgmma (m64n64k8, tf32 operands,
//   f32 sums), B operands in 128-byte-swizzled K-major tiles:
//   [K e^Gamma; Q e^Gamma] S (a warpgroup each, A formed in registers from
//   raw k or q and e^Gamma), X = V - (K e^Gamma) S, Delta = T X beside O =
//   (Q e^Gamma) S + P X (stored in bf16), and the new S (a warpgroup each
//   64 state rows). The next chunk's Gamma scan, e^Gamma and first A
//   operand run beside the last product, K e^{Gamma_C - Gamma} beside the
//   first. The CTA's 128 x 64 block of S lives in the wgmma accumulators in
//   f32, and rounded to tf32 in its B tile for the products. After the row's
//   last real chunk it writes zeros to the rest of o's columns. 194 KB of
//   shared memory: one CTA an SM.
// Roundings to tf32 are two integer operations (cvt.rna.tf32.f32's result).
// What else was timed on an H100 (PERF.md section 6, row 14): every product
// of the state pass on the FMA pipes (1.5x slower), 32 value columns a CTA
// (1.4x), two CTAs an SM for the intra kernel (1.2x), and below the
// diagonal two exp2 a tile row and column in place of one a pair (1.18x:
// the exp unit does not bind it); since the redesign, at 35,481 tokens:
// the state products on mma.sync with S read by every warp (1.09x the
// state kernel), each chunk's rows landed by bulk copies on mbarriers (384
// a chunk: 2.7x, the copy engine's cost a copy), every thread issuing the
// cp.async copies (1.05x), tf32 rounding by cvt.rna.tf32.f32 (1.12x the
// intra kernel, 1.12x the state kernel), the intra kernel's tiles below the
// diagonal of a block through their tile's last row on warps of their own
// (1.08x, spills), T and P from registers in place of shared memory (1.03x
// the state kernel).
// Positions of a chunk at or past the row's length enter as zeros (k, q, v,
// g, beta), so they add nothing to any real position's result.

#include "sm90.cuh"

namespace {

constexpr int kC = 64;      // positions a chunk
constexpr int kD = 128;     // head dim of q, k and v
constexpr int kSub = 16;    // rows of a sub-chunk of the intra kernel
constexpr int kCols = 64;   // value columns a state CTA carries
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row strides (elements): 16-byte rows, padded off the 32 banks
constexpr int kBfRow = kD + 8;   // bf16 rows of k and q (68 words)
constexpr int kGRow = kD + 8;    // f32 rows of g, Gamma, then e^Gamma (136 words)
constexpr int kTRow = kC + 4;    // f32 rows of A, T and Qt (68 words)
constexpr int kXRow = kSub + 8;  // f32 rows of the blocked solve's products (24 words)
constexpr int kKdRow = kD + 8;   // f32 rows of K e^{Gamma_C - Gamma}, read transposed
constexpr int kVRow = kCols + 8; // bf16 rows of v's 64 columns (36 words)

// the intra kernel: k, q and Gamma; A (then P = Qt T), T, Qt and the
// blocked solve's products take their place once the pairwise sums are in
// registers; beta and the scan's 128 half sums after both
constexpr size_t kIntraLoads = 2 * kC * kBfRow * sizeof(__nv_bfloat16) + kC * kGRow * sizeof(float);
constexpr size_t kIntraSolve = (3 * kC * kTRow + 3 * kSub * kXRow) * sizeof(float);
constexpr size_t kIntraSmem =
    (kIntraLoads > kIntraSolve ? kIntraLoads : kIntraSolve) + (kC + kD) * sizeof(float);

// the state kernel's buffers, in bytes from the start: the products' swizzled
// tiles first (1 KB aligned), then the rest (each 16-byte aligned)
constexpr size_t kOffST = 0;                                           // S (tf32), 64 x 128
constexpr size_t kOffXT = kOffST + kCols * kD * sizeof(float);         // X, then Delta, 64 x 64
constexpr size_t kOffT = kOffXT + kCols * kC * sizeof(float);          // T (tf32), 64 x 64
constexpr size_t kOffP = kOffT + kC * kC * sizeof(float);              // P = Qt T (tf32)
constexpr size_t kOffK = kOffP + kC * kC * sizeof(float);              // raw k (bf16)
constexpr size_t kOffQ = kOffK + kC * kBfRow * sizeof(__nv_bfloat16);  // raw q (bf16)
constexpr size_t kOffG = kOffQ + kC * kBfRow * sizeof(__nv_bfloat16);  // g, then e^Gamma
constexpr size_t kOffKd = kOffG + kC * kGRow * sizeof(float);          // K e^{Gamma_C - Gamma}
constexpr size_t kOffV = kOffKd + kC * kKdRow * sizeof(float);         // v's columns (bf16)
constexpr size_t kOffE = kOffV + kC * kVRow * sizeof(__nv_bfloat16);   // Gamma_C, e^{Gamma_C}
constexpr size_t kOffRow = kOffE + 2 * kD * sizeof(float);             // the CTA's row
constexpr size_t kStateSmem = kOffRow + 16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int chunks_of(int length) { return (length + kC - 1) / kC; }

// x rounded to tf32 (10-bit mantissa, to nearest, ties away from zero:
// cvt.rna.tf32.f32's result), kept as an f32; two integer operations
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// d += a b for one m16n8k8 tile in tf32, f32 sums. g = lane / 4, t = lane % 4:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the 16 x 8 A;
// b0 (t, g), b1 (t + 4, g) of the 8 x 8 B; d0 (g, 2t), d1 (g, 2t + 1), d2
// (g + 8, 2t), d3 (g + 8, 2t + 1) of the 16 x 8 D.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// A's fragment at (m0, k0) of a row-major tile of row stride ld
__device__ __forceinline__ void frag_a(float (&a)[4], const float* m, int ld, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = m[(m0 + g) * ld + k0 + t];
  a[1] = m[(m0 + g + 8) * ld + k0 + t];
  a[2] = m[(m0 + g) * ld + k0 + t + 4];
  a[3] = m[(m0 + g + 8) * ld + k0 + t + 4];
}

// A's fragment at (m0, k0) of the transpose of a row-major tile
__device__ __forceinline__ void frag_at(float (&a)[4], const float* m, int ld, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = m[(k0 + t) * ld + m0 + g];
  a[1] = m[(k0 + t) * ld + m0 + g + 8];
  a[2] = m[(k0 + t + 4) * ld + m0 + g];
  a[3] = m[(k0 + t + 4) * ld + m0 + g + 8];
}

// x = hi + lo, each a tf32
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(x - hi);
}

// d += a b at f32 accuracy from split operands: three tf32 products, the
// small ones first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a_hi)[4],
                                           const float (&a_lo)[4], float2 b_hi, float2 b_lo) {
  mma_tf32(d, a_lo, b_hi.x, b_hi.y);
  mma_tf32(d, a_hi, b_lo.x, b_lo.y);
  mma_tf32(d, a_hi, b_hi.x, b_hi.y);
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// 16 bytes from device memory into shared memory, in flight until the
// group it is committed with is waited for; zeros when !real (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(real ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the scratch index of row b's first chunk: the real chunks of rows before it
__device__ __forceinline__ int first_chunk(const int* lengths, int b) {
  int n = 0;
  for (int i = 0; i < b; ++i) n += chunks_of(lengths[i]);
  return n;
}

// Gamma in log2 units for rows 32 half .. 32 half + 31 of channel c (thread
// (c, half) of 256): g times log2 e summed down the channel in registers,
// the second half's sums raised by the first's last once it lands (two
// syncs; `lead` a 128-float buffer). Each sum only falls (g <= 0), so every
// difference of a later and an earlier row is <= 0 after rounding too.
__device__ __forceinline__ void scan_gamma(float (&x)[32], const float* sG, float* lead) {
  const int c = threadIdx.x & (kD - 1), half = threadIdx.x >> 7;
  const float* col = sG + half * 32 * kGRow + c;
#pragma unroll
  for (int r = 0; r < 32; ++r) x[r] = col[r * kGRow];
  x[0] *= kLog2e;
#pragma unroll
  for (int r = 1; r < 32; ++r) x[r] = fmaf(x[r], kLog2e, x[r - 1]);
  if (half == 0) lead[c] = x[31];
  __syncthreads();
  if (half == 1) {
    const float l = lead[c];
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] += l;
  }
}

// acc (a 16 x 8 tile in the mma layout) += A B over k in [k0, k1): A rows
// m0 .. m0 + 15 of a row-major f32 tile, B the 8 columns at b of another,
// both split into tf32 high and low parts (3xTF32: f32 accuracy)
__device__ __forceinline__ void tile_3xtf32(float (&acc)[4], const float* a, int lda, int m0,
                                            const float* b, int ldb, int k0, int k1) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  for (int k = k0; k < k1; k += 8) {
    float x[4], a_hi[4], a_lo[4];
    frag_a(x, a, lda, m0, k);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], a_hi[e], a_lo[e]);
    float2 b_hi, b_lo;
    split_tf32(b[(k + tq) * ldb + gq], b_hi.x, b_lo.x);
    split_tf32(b[(k + tq + 4) * ldb + gq], b_hi.y, b_lo.y);
    mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
  }
}

// P's blocks (I, J), I >= J, in four lists of 5 k blocks each (block (I, J)
// sums over I - J + 1), a list to a pair of warps
__constant__ int kPList[4][4][2] = {{{3, 0}, {0, 0}, {-1, -1}, {-1, -1}},
                                    {{3, 1}, {3, 2}, {-1, -1}, {-1, -1}},
                                    {{2, 0}, {2, 1}, {-1, -1}, {-1, -1}},
                                    {{1, 0}, {1, 1}, {2, 2}, {3, 3}}};

// the six blocks below the diagonal of sub-chunks, (I, J) with J < I, two a
// warp of warps 5-7
__constant__ int kPairI[6] = {1, 2, 3, 2, 3, 3};
__constant__ int kPairJ[6] = {0, 0, 0, 1, 1, 2};

__global__ void __launch_bounds__(kThreads, 3) kda_intra_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const float* __restrict__ g, const float* __restrict__ beta, const int* __restrict__ lengths,
    float* __restrict__ scratch, int S, int H) {
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = lengths[b];
  const int t0 = chunk * kC;
  if (t0 >= length) return;
  const int n = min(kC, length - t0);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sQ = sK + kC * kBfRow;
  float* sG = reinterpret_cast<float*>(sQ + kC * kBfRow);
  // over k, q and Gamma, once the pairwise sums are in registers; P = Qt T
  // over A once T is solved
  float* sA = reinterpret_cast<float*>(smem);
  float* sT = sA + kC * kTRow;
  float* sQt = sT + kC * kTRow;
  float* sX = sQt + kC * kTRow;  // the solve's products, up to 3 blocks of 16 x 16 (kXRow)
  float* sB = reinterpret_cast<float*>(smem + kIntraSmem) - kC - kD;
  float* sLead = sB + kC;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t base = (static_cast<size_t>(b) * S + t0) * row_stride + static_cast<size_t>(h) * kD;

#pragma unroll
  for (int it = 0; it < kC * kD / 8 / kThreads; ++it) {
    const int idx = tid + it * kThreads, r = idx >> 4, c = (idx & 15) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), qv = make_uint4(0, 0, 0, 0);
    if (r < n) {
      kv = *reinterpret_cast<const uint4*>(k + base + r * row_stride + c);
      qv = *reinterpret_cast<const uint4*>(q + base + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(sK + r * kBfRow + c) = kv;
    *reinterpret_cast<uint4*>(sQ + r * kBfRow + c) = qv;
  }
#pragma unroll
  for (int it = 0; it < kC * kD / 4 / kThreads; ++it) {
    const int idx = tid + it * kThreads, r = idx >> 5, c = (idx & 31) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = *reinterpret_cast<const float4*>(g + base + r * row_stride + c);
    *reinterpret_cast<float4*>(sG + r * kGRow + c) = x;
  }
  if (tid < kC) {
    sB[tid] = tid < n ? beta[(static_cast<size_t>(b) * S + t0 + tid) * H + h] : 0.0f;
  }
  __syncthreads();
  {
    float x[32];
    scan_gamma(x, sG, sLead);
    float* col = sG + (tid >> 7) * 32 * kGRow + (tid & (kD - 1));
#pragma unroll
    for (int r = 0; r < 32; ++r) col[r * kGRow] = x[r];
  }
  __syncthreads();

  // warps 0-4: the diagonal blocks, tile (R, I), R >= I, of block blk's 4 x 4
  // grid of 4 x 4 tiles, channel pairs quarter, quarter + 4, ...
  const int tile = tid >> 2, quarter = tid & 3;
  const int blk = tile / 10, tri = tile % 10;
  int R = 0;
  while ((R + 1) * (R + 2) / 2 <= tri) ++R;
  const int rb = kSub * blk + 4 * R, ib = kSub * blk + 4 * (tri - R * (R + 1) / 2);
  // warps 5-7 hold in the same registers the blocks (I, J) of pairs 2 (w -
  // 5) + pr, pr = 0, 1: A's in acc_a[2 pr + nt], Qt's in acc_q[2 pr + nt],
  // n-tile nt of two 16 x 8 mma tiles
  float acc_a[4][4] = {}, acc_q[4][4] = {};
  if (w < 5) {
#pragma unroll 2
    for (int p = quarter; p < kD / 2; p += 4) {
      const int c = 2 * p;
      float2 kr[4], qr[4], gr[4], ki[4], gi[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kr[a] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sK + (rb + a) * kBfRow + c));
        qr[a] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sQ + (rb + a) * kBfRow + c));
        gr[a] = *reinterpret_cast<const float2*>(sG + (rb + a) * kGRow + c);
        ki[a] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sK + (ib + a) * kBfRow + c));
        gi[a] = *reinterpret_cast<const float2*>(sG + (ib + a) * kGRow + c);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // pairs with i > r (a diagonal tile's upper half) clamp to a
          // finite value and are dropped below
          const float e0 = ex2(fminf(gr[a].x - gi[j].x, 0.0f));
          const float e1 = ex2(fminf(gr[a].y - gi[j].y, 0.0f));
          const float k0 = ki[j].x * e0, k1 = ki[j].y * e1;
          acc_a[a][j] = fmaf(kr[a].x, k0, fmaf(kr[a].y, k1, acc_a[a][j]));
          acc_q[a][j] = fmaf(qr[a].x, k0, fmaf(qr[a].y, k1, acc_q[a][j]));
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int m = 1; m < 4; m <<= 1) {
          acc_a[a][j] += __shfl_xor_sync(0xffffffffu, acc_a[a][j], m);
          acc_q[a][j] += __shfl_xor_sync(0xffffffffu, acc_q[a][j], m);
        }
      }
    }
  } else {
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int pair = 2 * (w - 5) + pr, I = kPairI[pair], J = kPairJ[pair];
      const float* gb = sG + (kSub * J + kSub - 1) * kGRow;  // J's last row
      const int ra = kSub * I + gq, rj = kSub * J + gq;
#pragma unroll 2
      for (int k0 = 0; k0 < kD; k0 += 8) {
        const float gb0 = gb[k0 + tq], gb1 = gb[k0 + tq + 4];
        // A: rows ra, ra + 8 of sub-chunk I times e^{Gamma_r - Gamma_b}
        float ka_hi[4], ka_lo[4], qa_hi[4], qa_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ra + 8 * (e & 1), c = k0 + tq + 4 * (e >> 1);
          const float x = ex2(sG[r * kGRow + c] - ((e >> 1) ? gb1 : gb0));
          split_tf32(bf(sK + r * kBfRow + c) * x, ka_hi[e], ka_lo[e]);
          split_tf32(bf(sQ + r * kBfRow + c) * x, qa_hi[e], qa_lo[e]);
        }
        float2 b_hi[2], b_lo[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // B: rows j of sub-chunk J times e^{Gamma_b - Gamma_j}
          const int j = rj + 8 * nt, c = k0 + tq;
          split_tf32(bf(sK + j * kBfRow + c) * ex2(gb0 - sG[j * kGRow + c]), b_hi[nt].x,
                     b_lo[nt].x);
          split_tf32(bf(sK + j * kBfRow + c + 4) * ex2(gb1 - sG[j * kGRow + c + 4]), b_hi[nt].y,
                     b_lo[nt].y);
        }
        // 3xTF32, the four sums' products interleaved (each sum's three
        // depend on one another)
#pragma unroll
        for (int term = 0; term < 3; ++term) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float2 bb = term == 1 ? b_lo[nt] : b_hi[nt];
            mma_tf32(acc_a[2 * pr + nt], term == 0 ? ka_lo : ka_hi, bb.x, bb.y);
            mma_tf32(acc_q[2 * pr + nt], term == 0 ? qa_lo : qa_hi, bb.x, bb.y);
          }
        }
      }
    }
  }
  __syncthreads();  // k, q and Gamma are read: A, T and Qt take their place
  if (w < 5) {
    // every lane holds its tile's sums: lane `quarter` writes row quarter,
    // Qt's pairs above the diagonal as zeros (and a tile below the diagonal
    // the zeros of its mirror tile above it, which no thread computes)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a == quarter) {
        const int r = rb + a;
        *reinterpret_cast<float4*>(sA + r * kTRow + ib) =
            make_float4(acc_a[a][0], acc_a[a][1], acc_a[a][2], acc_a[a][3]);
        *reinterpret_cast<float4*>(sQt + r * kTRow + ib) =
            make_float4(ib <= r ? acc_q[a][0] : 0.0f, ib + 1 <= r ? acc_q[a][1] : 0.0f,
                        ib + 2 <= r ? acc_q[a][2] : 0.0f, ib + 3 <= r ? acc_q[a][3] : 0.0f);
        if (ib != rb) {
          *reinterpret_cast<float4*>(sQt + (ib + a) * kTRow + rb) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  } else {
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int pair = 2 * (w - 5) + pr, I = kPairI[pair], J = kPairJ[pair];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int at = (kSub * I + gq + 8 * hf) * kTRow + kSub * J + 8 * nt + 2 * tq;
          const float* da = acc_a[2 * pr + nt];
          const float* dq = acc_q[2 * pr + nt];
          *reinterpret_cast<float2*>(sA + at) = make_float2(da[2 * hf], da[2 * hf + 1]);
          *reinterpret_cast<float2*>(sQt + at) = make_float2(dq[2 * hf], dq[2 * hf + 1]);
        }
      }
    }
  }
  __syncthreads();

  // T's diagonal blocks, warp w's block w: T_rj = beta_r (delta_rj - sum_{i<r}
  // A_ri T_ij), lane j a column, each landed row added into the later rows'
  // sums at once (above the diagonal every T_rj comes out exactly 0)
  if (w < 4) {
    const int o0 = kSub * w, j = lane & (kSub - 1);
    float acc[kSub] = {};
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const float t = sB[o0 + r] * ((r == j ? 1.0f : 0.0f) - acc[r]);
      if (lane < kSub) sT[(o0 + r) * kTRow + o0 + j] = t;
#pragma unroll
      for (int r2 = r + 1; r2 < kSub; ++r2) {
        acc[r2] = fmaf(sA[(o0 + r2) * kTRow + o0 + r], t, acc[r2]);
      }
    }
  }
  __syncthreads();
  // the blocks below, one diagonal of blocks at a time (J = I - lv), a
  // warp an n-tile of a block: X = sum_{J<=K<I} A_IK T_KJ, then T_IJ =
  // -T_II X
  for (int lv = 1; lv < kC / kSub; ++lv) {
    const int blk = w >> 1, nt = w & 1, I = lv + blk, J = I - lv;
    const bool mine = blk < kC / kSub - lv;
    float acc[4] = {};
    if (mine) {
      tile_3xtf32(acc, sA, kTRow, kSub * I, sT + kSub * J + 8 * nt, kTRow, kSub * J, kSub * I);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<float2*>(sX + blk * kSub * kXRow + (gq + 8 * hf) * kXRow + 8 * nt +
                                   2 * tq) = make_float2(acc[2 * hf], acc[2 * hf + 1]);
        acc[2 * hf] = acc[2 * hf + 1] = 0.0f;
      }
    }
    __syncthreads();
    if (mine) {
      tile_3xtf32(acc, sT + kSub * I, kTRow, kSub * I, sX + blk * kSub * kXRow + 8 * nt, kXRow,
                  0, kSub);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<float2*>(sT + (kSub * I + gq + 8 * hf) * kTRow + kSub * J + 8 * nt +
                                   2 * tq) = make_float2(-acc[2 * hf], -acc[2 * hf + 1]);
      }
    }
    __syncthreads();
  }
  // P = Qt T over A's place, block (I, J) the sum over K = J..I (both lower
  // triangular): the state pass takes O = (Q e^Gamma) S + P X. A warp an
  // n-tile of the blocks of its list (each list 5 k blocks of 16).
#pragma unroll 1
  for (int e = 0; e < 4; ++e) {
    const int I = kPList[w >> 1][e][0], J = kPList[w >> 1][e][1], nt = w & 1;
    if (I < 0) break;
    float acc[4] = {};
    tile_3xtf32(acc, sQt, kTRow, kSub * I, sT + kSub * J + 8 * nt, kTRow, kSub * J,
                kSub * I + kSub);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      *reinterpret_cast<float2*>(sA + (kSub * I + gq + 8 * hf) * kTRow + kSub * J + 8 * nt +
                                 2 * tq) = make_float2(acc[2 * hf], acc[2 * hf + 1]);
    }
  }
  __syncthreads();

  // T and P out, zeros above the diagonal, rounded to tf32: the state pass
  // takes them as tf32 operands only (in its shared memory as they land)
  float* const out_t = scratch + (static_cast<size_t>(first_chunk(lengths, b) + chunk) * H + h) *
                                     2 * kC * kC;
  float* const out_p = out_t + kC * kC;
#pragma unroll
  for (int it = 0; it < kC * kC / 4 / kThreads; ++it) {
    const int idx = tid + it * kThreads, r = idx >> 4, c = (idx & 15) * 4;
    float4 t4 = *reinterpret_cast<const float4*>(sT + r * kTRow + c);
    float4 p4 = *reinterpret_cast<const float4*>(sA + r * kTRow + c);
    float* tv = reinterpret_cast<float*>(&t4);
    float* pv = reinterpret_cast<float*>(&p4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tv[e] = c + e > r ? 0.0f : tf32(tv[e]);
      pv[e] = c + e > r ? 0.0f : tf32(pv[e]);
    }
    *reinterpret_cast<float4*>(out_t + r * kC + c) = t4;
    *reinterpret_cast<float4*>(out_p + r * kC + c) = p4;
  }
}

// The state kernel's products run on wgmma (m64n64k8, tf32 operands, f32
// sums): a warpgroup a 64-row tile, A from registers (the mma.sync m16n8k8
// fragment layout, warp i of the group rows 16 i ..) or, as B always, from
// shared memory as a K-major tile of 64 rows in 128-byte-swizzled 8-row
// atoms, one 8 KB block a 32 k, 1 KB aligned.

// d (64 x 64 f32) (+)= A (64 x 8 tf32 in registers) times B (8 x 64 tf32,
// K-major in shared memory: stored [n][k])
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const float (&a)[4], uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MMEE_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MMEE_WGMMA_D32(d)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(accumulate));
}

// the same with A (64 x 8 tf32) K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MMEE_WGMMA_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : MMEE_WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// an A or B operand's descriptor at k step s (8 k) of a swizzled tile
__device__ __forceinline__ uint64_t tile_desc(const float* tile, int s) {
  return wgmma_desc(reinterpret_cast<const unsigned char*>(tile) + (s >> 2) * 8192 + (s & 3) * 32,
                    16, 1024);
}

// the byte offset of element (n, k) of a swizzled tile, n < 8: element
// (8 j + n, k) lies 1024 j bytes further on
__device__ __forceinline__ int swz(int n, int k) {
  return (k >> 5) * 8192 + n * 128 + ((((k & 31) >> 2) ^ n) << 4) + ((k & 3) << 2);
}
__device__ __forceinline__ float& tile_at(float* tile, int bytes) {
  return *reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tile) + bytes);
}

// The first product reads its k steps in pairs of neighbouring channels:
// the A fragments' k index t stands for channel 8 s + 2 t and t + 4 for 8 s
// + 2 t + 1, and S's tile is stored in the same order (any order of k gives
// the same sums), so a fragment's two elements of a row come in one load.
__device__ __forceinline__ int s_slot(int ch) {
  return (ch & ~7) + ((ch & 1) << 2) + ((ch & 7) >> 1);
}

// the A operand of the first product, in registers: warp w's 16 rows
// 16 (w mod 4) .. of K e^Gamma (w < 4) or Q e^Gamma (w >= 4) over all 128
// channels, a fragment a k step, from raw k or q and e^Gamma
__device__ __forceinline__ void form_rows(float (&a1)[kD / 8][4], const __nv_bfloat16* sK,
                                          const __nv_bfloat16* sQ, const float* sE) {
  const int w = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const __nv_bfloat16* src = w < 4 ? sK : sQ;
  const int r0 = 16 * (w & 3) + gq;
#pragma unroll
  for (int s = 0; s < kD / 8; ++s) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf, c = 8 * s + 2 * tq;
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + r * kBfRow + c));
      const float2 e = *reinterpret_cast<const float2*>(sE + r * kGRow + c);
      a1[s][hf] = tf32(x.x * e.x);
      a1[s][hf + 2] = tf32(x.y * e.y);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) kda_state_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ g,
    const int* __restrict__ lengths, const float* __restrict__ scratch,
    __nv_bfloat16* __restrict__ o, int S, int H, int batch) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* tS = reinterpret_cast<float*>(smem + kOffST);   // S's B tile (tf32, [col][channel])
  float* tX = reinterpret_cast<float*>(smem + kOffXT);   // X's, then Delta's ([col][position])
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + kOffK);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + kOffQ);
  float* sG = reinterpret_cast<float*>(smem + kOffG);    // g, then e^Gamma
  float* sKd = reinterpret_cast<float*>(smem + kOffKd);  // k e^{Gamma_C - Gamma} (tf32)
  float* tT = reinterpret_cast<float*>(smem + kOffT);    // T's A tile ([position][position])
  float* tP = reinterpret_cast<float*>(smem + kOffP);    // P's
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + kOffV);
  float* sGC = reinterpret_cast<float*>(smem + kOffE);   // Gamma_C (log2 units)
  float* sEC = sGC + kD;                                 // e^{Gamma_C}
  int* sRow = reinterpret_cast<int*>(smem + kOffRow);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' row and column
  const int wg = w >> 2, mt = w & 3;        // warpgroup, and warp w's 16 rows in its tile
  const int col0 = blockIdx.x * kCols, h = blockIdx.y;
  // this thread's accumulator elements (rows + 8 hf, columns 8 j + 2 t + e)
  // in the B tiles, less 1024 j bytes: X and Delta [column][position], S
  // [column][channel's slot]
  int x_at[2][2], s_at[2][2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x_at[hf][e] = swz(2 * tq + e, 16 * mt + gq + 8 * hf);
      s_at[hf][e] = swz(2 * tq + e, s_slot(64 * wg + 16 * mt + gq + 8 * hf));
    }
  }

  // the row of rank blockIdx.z by length, longest first (ties by index)
  for (int r = tid; r < batch; r += kThreads) {
    const int lr = lengths[r];
    int ahead = 0;
    for (int i = 0; i < batch; ++i) {
      const int li = lengths[i];
      ahead += li > lr || (li == lr && i < r);
    }
    if (ahead == static_cast<int>(blockIdx.z)) *sRow = r;
  }
  __syncthreads();
  const int b = *sRow;
  const int length = lengths[b], n_chunks = chunks_of(length);
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const float* chunk_scratch =
      scratch + static_cast<size_t>(first_chunk(lengths, b)) * H * 2 * kC * kC;
  auto base_of = [&](int chunk) {
    return (static_cast<size_t>(b) * S + static_cast<size_t>(chunk) * kC) * row_stride +
           static_cast<size_t>(h) * kD;
  };
  // each stage_* call commits one group of cp.async copies (empty past the
  // row's last chunk, and for the threads that issue none), in the order k
  // q g, v, T P of the next chunk, so a buffer's wait is cp_async_wait<1>,
  // or <2> for k q g (see the loop). Warpgroup 1 issues k q g and T P alone,
  // while warpgroup 0 stores X or Delta.
  constexpr int kHalf = kThreads / 2;
  const int t1 = tid - kHalf;  // a thread's index in warpgroup 1
  auto stage_kqg = [&](int chunk) {
    if (chunk < n_chunks && wg == 1) {
      const int n = min(kC, length - chunk * kC);
      const size_t base = base_of(chunk);
#pragma unroll
      for (int it = 0; it < kC * kD / 8 / kHalf; ++it) {
        const int idx = t1 + it * kHalf, r = idx >> 4, c = (idx & 15) * 8;
        const size_t at = r < n ? base + r * row_stride + c : 0;
        cp_async16(sK + r * kBfRow + c, k + at, r < n);
        cp_async16(sQ + r * kBfRow + c, q + at, r < n);
      }
#pragma unroll
      for (int it = 0; it < kC * kD / 4 / kHalf; ++it) {
        const int idx = t1 + it * kHalf, r = idx >> 5, c = (idx & 31) * 4;
        cp_async16(sG + r * kGRow + c, g + (r < n ? base + r * row_stride + c : 0), r < n);
      }
    }
    cp_async_commit();
  };
  auto stage_v = [&](int chunk) {
    if (chunk < n_chunks) {
      const int n = min(kC, length - chunk * kC);
      const size_t base = base_of(chunk) + col0;
#pragma unroll
      for (int it = 0; it < kC * kCols / 8 / kThreads; ++it) {
        const int idx = tid + it * kThreads, r = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8;
        cp_async16(sV + r * kVRow + c, v + (r < n ? base + r * row_stride + c : 0), r < n);
      }
    }
    cp_async_commit();
  };
  auto stage_tp = [&](int chunk) {
    if (chunk < n_chunks && wg == 1) {
      const float* src = chunk_scratch + (static_cast<size_t>(chunk) * H + h) * 2 * kC * kC;
#pragma unroll
      for (int it = 0; it < kC * kC / 4 / kHalf; ++it) {
        const int idx = t1 + it * kHalf, r = idx >> 4, c = (idx & 15) * 4;
        const int to = (r >> 3) * 1024 + swz(r & 7, c);  // 16 bytes, swizzled as a unit
        cp_async16(reinterpret_cast<unsigned char*>(tT) + to, src + r * kC + c, true);
        cp_async16(reinterpret_cast<unsigned char*>(tP) + to, src + kC * kC + r * kC + c, true);
      }
    }
    cp_async_commit();
  };
  // the landed k, q and g: Gamma (in registers, x), Gamma_C, e^{Gamma_C}
  // and e^Gamma (over g), then the first product's A operand; K e^{Gamma_C
  // - Gamma} waits for the first product (kd_pass)
  const int c_own = tid & (kD - 1), half = tid >> 7;  // this thread's channel and rows
  float a1[kD / 8][4], x[32];
  auto prepare = [&]() {
    scan_gamma(x, sG, sGC);  // sGC holds the first half's last sums meanwhile
    if (half == 1) {
      sGC[c_own] = x[31];
      sEC[c_own] = ex2(x[31]);
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) sG[(half * 32 + r) * kGRow + c_own] = ex2(x[r]);
    __syncthreads();
    form_rows(a1, sK, sQ, sG);
  };
  auto kd_pass = [&]() {
    const float gc = sGC[c_own];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int row = half * 32 + r;
      sKd[row * kKdRow + c_own] = tf32(bf(sK + row * kBfRow + c_own) * ex2(gc - x[r]));
    }
  };
  // the state block S (rows = channels) into its B tile, rounded to tf32
  float s_acc[32];  // rows 64 wg + 16 mt .., the wgmma accumulators' layout, f32
  auto store_state = [&]() {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tile_at(tS, s_at[e >> 1][e & 1] + 1024 * j) = tf32(s_acc[4 * j + e]);
      }
    }
    fence_async_smem();
  };

#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.0f;
  if (n_chunks > 0) {
    stage_kqg(0);
    stage_v(0);
    stage_tp(0);
    store_state();
    cp_async_wait<2>();
    __syncthreads();
    prepare();
    __syncthreads();
  }

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * kC, n = min(kC, length - t0);
    const size_t base = base_of(chunk);
    // [K e^Gamma; Q e^Gamma] S: warpgroup 0 X's product, 1 O's
    float acc1[32] = {};
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kD / 8; ++s) wgmma_tf32(acc1, a1[s], tile_desc(tS, s), s);
    wgmma_commit();
    kd_pass();  // beside the products
    wgmma_wait<0>();
    reg_fence(acc1);
    cp_async_wait<1>();  // v
    __syncthreads();     // and K e^{Gamma_C - Gamma} is written; raw k, q, g are read
    stage_kqg(chunk + 1);
    // X = V - (K e^Gamma) S into its B tile
    if (wg == 0) {
      float2 vv[kCols / 8][2];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          vv[j][hf] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              sV + (16 * mt + gq + 8 * hf) * kVRow + 8 * j + 2 * tq));
        }
      }
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          tile_at(tX, x_at[hf][0] + 1024 * j) = tf32(vv[j][hf].x - acc1[4 * j + 2 * hf]);
          tile_at(tX, x_at[hf][1] + 1024 * j) = tf32(vv[j][hf].y - acc1[4 * j + 2 * hf + 1]);
        }
      }
      fence_async_smem();
    }
    cp_async_wait<1>();  // T and P
    __syncthreads();
    stage_v(chunk + 1);
    // warpgroup 0: Delta = T X (over X's product); 1: O = (Q e^Gamma) S +
    // P X, stored in bf16 (zeros past the row)
    {
      const float* m = wg == 0 ? tT : tP;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kC / 8; ++s) {
        wgmma_tf32_ss(acc1, tile_desc(m, s), tile_desc(tX, s), s > 0 || wg == 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc1);
    }
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int c = col0 + 8 * j + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + gq + 8 * hf;
          if (t0 + r < S) {
            const bool real = r < n;
            *reinterpret_cast<__nv_bfloat162*>(o + base + r * row_stride + c) =
                __floats2bfloat162_rn(real ? acc1[4 * j + 2 * hf] : 0.0f,
                                      real ? acc1[4 * j + 2 * hf + 1] : 0.0f);
          }
        }
      }
    }
    __syncthreads();  // X, T and P are read: Delta takes X's place
    stage_tp(chunk + 1);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tile_at(tX, x_at[e >> 1][e & 1] + 1024 * j) = tf32(acc1[4 * j + e]);
        }
      }
      fence_async_smem();
    }
    __syncthreads();
    // S <- Diag(e^{Gamma_C}) S + (K e^{Gamma_C - Gamma})^T Delta, warpgroup
    // wg the channels 64 wg ..
    {
      float a4[kC / 8][4];
#pragma unroll
      for (int s = 0; s < kC / 8; ++s) frag_at(a4[s], sKd, kKdRow, 64 * wg + 16 * mt, 8 * s);
      const float e_lo = sEC[64 * wg + 16 * mt + gq], e_hi = sEC[64 * wg + 16 * mt + gq + 8];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        s_acc[4 * j] *= e_lo;
        s_acc[4 * j + 1] *= e_lo;
        s_acc[4 * j + 2] *= e_hi;
        s_acc[4 * j + 3] *= e_hi;
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kC / 8; ++s) wgmma_tf32(s_acc, a4[s], tile_desc(tX, s), 1);
      wgmma_commit();
      // the next chunk's preparation beside the products: every warp has
      // read K e^{Gamma_C - Gamma} and e^{Gamma_C} into its registers
      if (chunk + 1 < n_chunks) {
        cp_async_wait<2>();  // the next chunk's k, q and g
        __syncthreads();     // and every warp has read its operands of the products
        prepare();
      }
      wgmma_wait<0>();
      reg_fence(s_acc);
      reg_fence(a4);
    }
    store_state();
    __syncthreads();
  }
  // the row's padding: zeros in this CTA's columns
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int t = n_chunks * kC + w; t < S; t += kThreads / 32) {
    for (int c = lane; c < kCols; c += 32) {
      o[(static_cast<size_t>(b) * S + t) * row_stride + static_cast<size_t>(h) * kD + col0 + c] =
          zero;
    }
  }
}

// ---------------------------------------------------------------------------
// the KDA sub-layer's elementwise work around the core, one pass each: bf16
// rows of 16-byte vectors (8 channels a thread), f32 arithmetic, one
// rounding. A head's 128 channels are 16 neighbouring lanes, so a head's
// sums are four shuffles.
// ---------------------------------------------------------------------------

constexpr int kE = 8;  // channels a thread

struct alignas(16) Vec {
  __nv_bfloat16 v[kE];
};

// the sum over a head's 16 lanes (a half warp: the other half may have left)
__device__ __forceinline__ float head_sum(float x) {
  const unsigned half = 0xffffu << (threadIdx.x & 16);
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(half, x, m);
  return x;
}

constexpr int kWidth = 4;  // the short convolutions' width, Kimi-Linear's
constexpr int kSteps = 4;  // positions a thread of short_conv_kernel

// out[b, t, c] = SiLU(sum_j w[c, j] x[b, t - 3 + j, c]) (zeros before the
// row), and with norm each head's 128 channels times scale over their L2
// norm, sqrt(sum y^2 + 1e-6). A thread takes 8 channels at kSteps
// neighbouring positions of a row: their weights (8 float4, w's rows of 4
// taps) and the kSteps + 3 input vectors are loaded once for all of them.
template <bool kNorm>
__global__ void __launch_bounds__(kThreads) short_conv_kernel(
    const Vec* __restrict__ x, const float4* __restrict__ w, Vec* __restrict__ out,
    unsigned groups, int seq, int vecs, float scale) {
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= groups * vecs) return;  // whole warps: vecs is a multiple of 32
  const unsigned grp = idx / vecs;
  const int v = idx - grp * vecs;
  const int per_row = (seq + kSteps - 1) / kSteps;
  const unsigned b = grp / per_row;
  const int t0 = (grp - b * per_row) * kSteps;
  const size_t row0 = static_cast<size_t>(b) * seq;
  float4 wt[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) wt[e] = w[v * kE + e];
  float xin[kSteps + kWidth - 1][kE];
#pragma unroll
  for (int i = 0; i < kSteps + kWidth - 1; ++i) {
    const int t = t0 - (kWidth - 1) + i;
    Vec xv;
    if (t >= 0 && t < seq) {
      xv = x[(row0 + t) * vecs + v];
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) xv.v[e] = __float2bfloat16_rn(0.0f);
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) xin[i][e] = __bfloat162float(xv.v[e]);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    float y[kE], ss = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float acc = wt[e].x * xin[s][e];
      acc = fmaf(wt[e].y, xin[s + 1][e], acc);
      acc = fmaf(wt[e].z, xin[s + 2][e], acc);
      acc = fmaf(wt[e].w, xin[s + 3][e], acc);
      y[e] = acc / (1.0f + __expf(-acc));
      ss = fmaf(y[e], y[e], ss);
    }
    float mul = 1.0f;
    if (kNorm) mul = scale * rsqrtf(head_sum(ss) + 1e-6f);  // every lane of a head takes part
    const int t = t0 + s;
    if (t < seq) {
      Vec o;
#pragma unroll
      for (int e = 0; e < kE; ++e) o.v[e] = __float2bfloat16_rn(y[e] * mul);
      out[(row0 + t) * vecs + v] = o;
    }
  }
}

// g = -exp(a_log[head]) softplus(raw + dt_bias) per channel, in f32
__global__ void __launch_bounds__(kThreads) kda_gate_kernel(
    const Vec* __restrict__ raw, const float* __restrict__ a_log,
    const float* __restrict__ dt_bias, float4* __restrict__ g, unsigned positions, int vecs,
    int head_dim) {
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= positions * vecs) return;
  const int v = idx % vecs, c0 = v * kE;
  const float a = -__expf(a_log[c0 / head_dim]);
  const Vec r = raw[idx];
  float y[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float z = __bfloat162float(r.v[e]) + dt_bias[c0 + e];
    // PyTorch's softplus: z past 20 is its own value
    y[e] = a * (z > 20.0f ? z : log1pf(__expf(z)));
  }
  g[2 * static_cast<size_t>(idx)] = make_float4(y[0], y[1], y[2], y[3]);
  g[2 * static_cast<size_t>(idx) + 1] = make_float4(y[4], y[5], y[6], y[7]);
}

// out = o / sqrt(mean over the head's 128 of o^2 + eps) weight sigmoid(gate)
__global__ void __launch_bounds__(kThreads) gated_rms_norm_kernel(
    const Vec* __restrict__ o, const Vec* __restrict__ gate, const float* __restrict__ weight,
    Vec* __restrict__ out, unsigned n_vecs, int head_dim, float eps) {
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_vecs) return;  // whole heads
  const Vec ov = o[idx], gv = gate[idx];
  const int c0 = (idx * kE) % head_dim;
  float x[kE], ss = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    x[e] = __bfloat162float(ov.v[e]);
    ss = fmaf(x[e], x[e], ss);
  }
  const float r = rsqrtf(head_sum(ss) / head_dim + eps);
  Vec y;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float s = 1.0f / (1.0f + __expf(-__bfloat162float(gv.v[e])));
    y.v[e] = __float2bfloat16_rn(x[e] * r * weight[c0 + e] * s);
  }
  out[idx] = y;
}

inline unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// x and out (batch, seq, channels) bf16, contiguous, 16-byte aligned,
// channels a multiple of 256; w (channels, 4) f32, 16-byte aligned; with
// norm (1) each head of 128 channels scaled to L2 norm scale
extern "C" int mmee_short_conv(const void* x, const void* w, void* out, int batch, int seq,
                               int channels, int width, int norm, float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (channels <= 0 || channels % (2 * kD) != 0 || width != kWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned groups = static_cast<unsigned>(batch) * ((seq + kSteps - 1) / kSteps);
  const int vecs = channels / kE;
  const unsigned blocks = blocks_for(static_cast<size_t>(groups) * vecs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vec* xv = static_cast<const Vec*>(x);
  const float4* wf = static_cast<const float4*>(w);
  Vec* ov = static_cast<Vec*>(out);
  if (norm) {
    short_conv_kernel<true><<<blocks, kThreads, 0, s>>>(xv, wf, ov, groups, seq, vecs, scale);
  } else {
    short_conv_kernel<false><<<blocks, kThreads, 0, s>>>(xv, wf, ov, groups, seq, vecs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// raw (positions, heads head_dim) bf16 and g (the same) f32, contiguous,
// 16-byte aligned; a_log (heads,) and dt_bias (heads head_dim,) f32;
// head_dim a multiple of 8
extern "C" int mmee_kda_gate(const void* raw, const void* a_log, const void* dt_bias, void* g,
                             int positions, int heads, int head_dim, void* stream) {
  if (positions <= 0) return 0;
  if (heads <= 0 || head_dim <= 0 || head_dim % kE != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs = heads * head_dim / kE;
  kda_gate_kernel<<<blocks_for(static_cast<size_t>(positions) * vecs), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(raw), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<float4*>(g),
      static_cast<unsigned>(positions), vecs, head_dim);
  return static_cast<int>(cudaGetLastError());
}

// o, gate and out (rows, 128) bf16, contiguous, 16-byte aligned (a row a
// head); weight (128,) f32
extern "C" int mmee_gated_rms_norm(const void* o, const void* gate, const void* weight, void* out,
                                   long long rows, float eps, void* stream) {
  if (rows <= 0) return 0;
  const unsigned n_vecs = static_cast<unsigned>(rows * (kD / kE));
  gated_rms_norm_kernel<<<blocks_for(n_vecs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(o), static_cast<const Vec*>(gate), static_cast<const float*>(weight),
      static_cast<Vec*>(out), n_vecs, kD, eps);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, o (batch, seq, heads, 128) bf16 and g (batch, seq, heads, 128)
// f32, contiguous, 16-byte aligned; beta (batch, seq, heads) f32 and
// lengths (batch,) int32, contiguous, each length in [0, seq]; scratch f32
// of (sum over rows of ceil(length / 64)) x heads x 2 x 64 x 64;
// max_chunks the most chunks of one row. batch, heads <= 65535.
extern "C" int mmee_kda(const void* q, const void* k, const void* v, const void* g,
                        const void* beta, const void* lengths, void* o, void* scratch, int batch,
                        int seq, int heads, int max_chunks, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (heads <= 0 || batch > 65535 || heads > 65535 || max_chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(kda_intra_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kIntraSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kda_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* lens = static_cast<const int*>(lengths);
  auto* work = static_cast<float*>(scratch);
  if (max_chunks > 0) {
    kda_intra_kernel<<<dim3(max_chunks, heads, batch), kThreads, kIntraSmem, s>>>(
        qb, kb, static_cast<const float*>(g), static_cast<const float*>(beta), lens, work, seq,
        heads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kda_state_kernel<<<dim3(kD / kCols, heads, batch), kThreads, kStateSmem, s>>>(
      qb, kb, static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(g), lens, work,
      static_cast<__nv_bfloat16*>(o), seq, heads, batch);
  return static_cast<int>(cudaGetLastError());
}
