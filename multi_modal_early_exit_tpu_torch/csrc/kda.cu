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
//   T     = (I + diag(beta) A)^{-1} diag(beta)        (forward substitution)
//   Delta = T (V - (K . e^Gamma) S)
//   O     = (Q . e^Gamma) S + Qt Delta
//   S    <- Diag(e^{Gamma_C}) S + (K . e^{Gamma_C - Gamma})^T Delta.
// Column j of Delta, O and the new S depends on column j of S and V alone.
//
// Bound on an H100 at a served batch (4 rows of 4,096-16,384 real tokens, 32
// heads): q, k, v, o in bf16 and g in f32 once each, about 12 bytes a
// channel and token (1.7 GB at 35,000 tokens, 0.52 ms at 3.35 TB/s),
// against about 9 M operations a chunk and head (0.16 ms at 989 TFLOP/s):
// bound by bytes.
//
// Design: two launches a call, whatever the length.
// - kda_intra_kernel, a CTA per (chunk, head, row), 256 threads: the
//   pairwise part, which no state enters. Gamma by a scan per channel (in
//   log2 units), then A and Qt in 4 x 4 tiles of (r, i) pairs, one exp2 a
//   pair and channel shared by both, each tile a thread (136 tiles of the
//   lower triangle; the 120 tiles above it write Qt's zeros), rows padded
//   to an odd word count so a warp's tiles read distinct banks. Then T by
//   forward substitution, four threads a column of T (a column depends on
//   its own earlier rows only), in the shared memory k, q and Gamma held.
//   T and Qt, 64 x 64 f32 each, go to a scratch buffer of the row's real
//   chunks (chunks at or past a row's length start no work). 65 KB of
//   shared memory and at most 85 registers a thread: three CTAs an SM, so
//   one's serial solve runs beside another's exponentials.
// - kda_state_kernel, a CTA per (64 value columns, head, row), 256 threads:
//   the pass over the row's chunks, in order. It loads a chunk's g, k, q,
//   its 64 columns of v, and T and Qt; scans Gamma again; forms K e^Gamma,
//   Q e^Gamma and K e^{Gamma_C - Gamma} in shared memory, rounded to tf32;
//   then X = V - (K e^Gamma) S, Delta = T X, O = (Q e^Gamma) S + Qt Delta
//   (stored in bf16) and the new S on the tensor cores (mma.sync m16n8k8
//   in tf32 with f32 sums: each warp a 16 x 32 block of X, Delta and O,
//   and 16 state rows by the CTA's 64 columns). The CTA's 128 x 64 block
//   of S lives in the mma accumulators in f32, and rounded to tf32 in
//   shared memory for the products. After the row's last real chunk it
//   writes zeros to the rest of o's columns. The two column blocks of a
//   (row, head) redo the chunk's elementwise preparation (16,384 exp2 a
//   chunk each) so no state crosses CTAs. 207 KB of shared memory: one CTA
//   an SM.
// What else was timed on an H100 (PERF.md section 6, row 14): every product
// of the state pass on the FMA pipes (1.5x slower), 32 value columns a CTA
// (1.4x), two CTAs an SM for the intra kernel (1.2x), and below the
// diagonal two exp2 a tile row and column in place of one a pair (1.18x:
// the exp unit does not bind it).
// Positions of a chunk at or past the row's length enter as zeros (k, q, v,
// g, beta), so they add nothing to any real position's result.

#include "common.cuh"

namespace {

constexpr int kC = 64;      // positions a chunk
constexpr int kD = 128;     // head dim of q, k and v
constexpr int kCols = 64;   // value columns a state CTA carries
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row strides (elements), padded off the 32 banks
constexpr int kBfRow = kD + 2;   // bf16 rows of k and q in the intra kernel (65 words)
constexpr int kGRow = kD + 1;    // f32 rows of Gamma in the intra kernel
constexpr int kTRow = kC + 8;    // f32 rows of A and T in the intra kernel
constexpr int kFRow = kD + 4;    // f32 rows of the state kernel's A operands (4 mod 32 words)
constexpr int kKdRow = kD + 8;   // f32 rows of K e^{Gamma_C - Gamma}, read transposed
constexpr int kPRow = kC + 4;    // f32 rows of T and Qt in the state kernel
constexpr int kVRow = kCols + 8; // f32 rows of the 32-column blocks (B operands: 8 mod 32)

// the intra kernel's k, q and Gamma; A and T take their place once the
// pairwise sums are in registers; beta after both
constexpr size_t kIntraLoads = 2 * kC * kBfRow * sizeof(__nv_bfloat16) + kC * kGRow * sizeof(float);
constexpr size_t kIntraSolve = 2 * kC * kTRow * sizeof(float);
constexpr size_t kIntraSmem =
    (kIntraLoads > kIntraSolve ? kIntraLoads : kIntraSolve) + kC * sizeof(float);
constexpr size_t kStateSmem = (2 * kC * kFRow + kC * kKdRow + 2 * kC * kPRow + 2 * kC * kVRow +
                               kD * kVRow + 2 * kD) * sizeof(float);

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int chunks_of(int length) { return (length + kC - 1) / kC; }

// x rounded to tf32 (10-bit mantissa, to nearest), kept as an f32
__device__ __forceinline__ float tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
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

// B's fragment at (k0, n0) of a row-major tile: (b0, b1)
__device__ __forceinline__ float2 frag_b(const float* m, int ld, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  return make_float2(m[(k0 + t) * ld + n0 + g], m[(k0 + t + 4) * ld + n0 + g]);
}

// the scratch index of row b's first chunk: the real chunks of rows before it
__device__ __forceinline__ int first_chunk(const int* lengths, int b) {
  int n = 0;
  for (int i = 0; i < b; ++i) n += chunks_of(lengths[i]);
  return n;
}

// Gamma in log2 units: g (already times log2 e) summed down each channel of
// the [kC][ld] tile, two threads a channel (rows 0-31, then 32-63)
__device__ __forceinline__ void scan_channels(float* sG, int ld) {
  const int c = threadIdx.x & (kD - 1), half = threadIdx.x >> 7;
  float run = 0.0f;
  for (int r = half * 32; r < half * 32 + 32; ++r) {
    run += sG[r * ld + c];
    sG[r * ld + c] = run;
  }
  __syncthreads();
  if (half == 1) {
    const float lead = sG[31 * ld + c];
    for (int r = 32; r < kC; ++r) sG[r * ld + c] += lead;
  }
  __syncthreads();
}

// rows r < n of a (kC, kD) bf16 tile at base + r * row_stride, as f32 into
// dst[r * ld + c] (zeros for r >= n)
__device__ __forceinline__ void load_f32(float* dst, int ld, const __nv_bfloat16* base,
                                         size_t row_stride, int n) {
  for (int idx = threadIdx.x; idx < kC * kD / 8; idx += kThreads) {
    const int r = idx >> 4, c = (idx & 15) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < n) raw = *reinterpret_cast<const uint4*>(base + r * row_stride + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + c + j] = __bfloat162float(e[j]);
  }
}

// rows r < n of g (f32) times log2 e into sG[r * ld + c] (zeros for r >= n)
__device__ __forceinline__ void load_gate(float* sG, int ld, const float* base,
                                          size_t row_stride, int n) {
  for (int idx = threadIdx.x; idx < kC * kD / 4; idx += kThreads) {
    const int r = idx >> 5, c = (idx & 31) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = *reinterpret_cast<const float4*>(base + r * row_stride + c);
    float* d = sG + r * ld + c;
    d[0] = x.x * kLog2e;
    d[1] = x.y * kLog2e;
    d[2] = x.z * kLog2e;
    d[3] = x.w * kLog2e;
  }
}

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
  float* sA = reinterpret_cast<float*>(smem);  // over k, q and Gamma, after the sums
  float* sT = sA + kC * kTRow;
  float* sB = reinterpret_cast<float*>(smem + kIntraSmem) - kC;
  const int tid = threadIdx.x;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t base = (static_cast<size_t>(b) * S + t0) * row_stride + static_cast<size_t>(h) * kD;

  for (int idx = tid; idx < kC * kD / 8; idx += kThreads) {
    const int r = idx >> 4, c = (idx & 15) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), qv = make_uint4(0, 0, 0, 0);
    if (r < n) {
      kv = *reinterpret_cast<const uint4*>(k + base + r * row_stride + c);
      qv = *reinterpret_cast<const uint4*>(q + base + r * row_stride + c);
    }
    // 65-word rows: four 4-byte stores a 16-byte vector
    uint32_t* dk = reinterpret_cast<uint32_t*>(sK + r * kBfRow + c);
    uint32_t* dq = reinterpret_cast<uint32_t*>(sQ + r * kBfRow + c);
    dk[0] = kv.x, dk[1] = kv.y, dk[2] = kv.z, dk[3] = kv.w;
    dq[0] = qv.x, dq[1] = qv.y, dq[2] = qv.z, dq[3] = qv.w;
  }
  load_gate(sG, kGRow, g + base, row_stride, n);
  if (tid < kC) {
    sB[tid] = tid < n ? beta[(static_cast<size_t>(b) * S + t0 + tid) * H + h] : 0.0f;
  }
  __syncthreads();
  scan_channels(sG, kGRow);

  float* const out_t = scratch + (static_cast<size_t>(first_chunk(lengths, b) + chunk) * H + h) *
                                     2 * kC * kC;
  float* const out_qt = out_t + kC * kC;
  // tile (R, I), R >= I, of the 16 x 16 grid of 4 x 4 tiles: threads 0-135
  int R = 0;
  while ((R + 1) * (R + 2) / 2 <= tid) ++R;
  const int I = tid - R * (R + 1) / 2;
  float acc_a[4][4] = {}, acc_q[4][4] = {};
  if (tid < 136) {
    for (int c = 0; c < kD; c += 2) {
      float2 kr[4], qr[4], gr[4], ki[4], gi[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kr[a] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sK + (4 * R + a) * kBfRow + c));
        qr[a] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sQ + (4 * R + a) * kBfRow + c));
        gr[a] = make_float2(sG[(4 * R + a) * kGRow + c], sG[(4 * R + a) * kGRow + c + 1]);
        ki[a] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sK + (4 * I + a) * kBfRow + c));
        gi[a] = make_float2(sG[(4 * I + a) * kGRow + c], sG[(4 * I + a) * kGRow + c + 1]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // pairs with i > r (the diagonal tile's upper half) clamp to a
          // finite value and are dropped below
          const float e0 = ex2(fminf(gr[a].x - gi[j].x, 0.0f));
          const float e1 = ex2(fminf(gr[a].y - gi[j].y, 0.0f));
          const float k0 = ki[j].x * e0, k1 = ki[j].y * e1;
          acc_a[a][j] = fmaf(kr[a].x, k0, fmaf(kr[a].y, k1, acc_a[a][j]));
          acc_q[a][j] = fmaf(qr[a].x, k0, fmaf(qr[a].y, k1, acc_q[a][j]));
        }
      }
    }
  }
  __syncthreads();  // k, q and Gamma are read: A and T take their place
  if (tid < 136) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * R + a;
      float4 qt;
      float* qv = reinterpret_cast<float*>(&qt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * I + j;
        sA[r * kTRow + i] = i < r ? acc_a[a][j] : 0.0f;
        qv[j] = i <= r ? acc_q[a][j] : 0.0f;
      }
      *reinterpret_cast<float4*>(out_qt + r * kC + 4 * I) = qt;
    }
  } else {
    // tile (R, I), R < I: Qt's zeros above the diagonal
    const int u = tid - 136;
    int Ru = 0, before = 0;
    while (before + (15 - Ru) <= u) before += 15 - Ru++;
    const int Iu = Ru + 1 + (u - before);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      *reinterpret_cast<float4*>(out_qt + (4 * Ru + a) * kC + 4 * Iu) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  // T: row r = beta_r (e_r - sum_{i<r} A_ri T_i); column j by four lanes
  {
    const int j = tid >> 2, part = tid & 3;
    for (int r = 0; r < kC; ++r) {
      float s = 0.0f, s2 = 0.0f;  // two chains: the sums wait on shared memory
      int i = part;
      for (; i + 4 < r; i += 8) {
        s = fmaf(sA[r * kTRow + i], sT[i * kTRow + j], s);
        s2 = fmaf(sA[r * kTRow + i + 4], sT[(i + 4) * kTRow + j], s2);
      }
      if (i < r) s = fmaf(sA[r * kTRow + i], sT[i * kTRow + j], s);
      s += s2;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) sT[r * kTRow + j] = j <= r ? sB[r] * ((j == r ? 1.0f : 0.0f) - s) : 0.0f;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kC * kC / 4; idx += kThreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    *reinterpret_cast<float4*>(out_t + r * kC + c) =
        *reinterpret_cast<const float4*>(sT + r * kTRow + c);
  }
}

__global__ void __launch_bounds__(kThreads, 1) kda_state_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ g,
    const int* __restrict__ lengths, const float* __restrict__ scratch,
    __nv_bfloat16* __restrict__ o, int S, int H) {
  const int col0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int length = lengths[b];
  extern __shared__ __align__(16) unsigned char smem[];
  // the products' operands, rounded to tf32 as they are stored
  float* sKg = reinterpret_cast<float*>(smem);  // k e^Gamma
  float* sQg = sKg + kC * kFRow;                // q e^Gamma
  float* sKd = sQg + kC * kFRow;                // Gamma, then k e^{Gamma_C - Gamma}
  float* sT = sKd + kC * kKdRow;
  float* sQt = sT + kC * kPRow;
  float* sX = sQt + kC * kPRow;                 // v's kCols columns (f32), then X
  float* sDl = sX + kC * kVRow;                 // Delta
  float* sS = sDl + kC * kVRow;                 // the state block, 128 x kCols
  float* sGC = sS + kD * kVRow;                 // Gamma_C (log2 units)
  float* sEC = sGC + kD;                        // e^{Gamma_C}
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // the mma fragments' row and column
  // (d)-(f): warp w's rows 16 mt .. 16 mt + 15 and its half of the columns,
  // n-tiles np .. np + kNT - 1
  constexpr int kNT = kCols / 16;
  const int mt = w >> 1, np = (w & 1) * kNT;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const int n_chunks = chunks_of(length);
  const float* chunk_scratch =
      scratch + static_cast<size_t>(first_chunk(lengths, b)) * H * 2 * kC * kC;

  // (g): warp w's state rows (channels) 16 w .. 16 w + 15, all the CTA's
  // columns, in the mma accumulators' layout, f32
  float s_acc[kCols / 8][4] = {};
  for (int idx = tid; idx < kD * kVRow; idx += kThreads) sS[idx] = 0.0f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * kC, n = min(kC, length - t0);
    const size_t base =
        (static_cast<size_t>(b) * S + t0) * row_stride + static_cast<size_t>(h) * kD;
    load_gate(sKd, kKdRow, g + base, row_stride, n);
    load_f32(sKg, kFRow, k + base, row_stride, n);
    load_f32(sQg, kFRow, q + base, row_stride, n);
    for (int idx = tid; idx < kC * kCols / 8; idx += kThreads) {
      const int r = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < n) raw = *reinterpret_cast<const uint4*>(v + base + r * row_stride + col0 + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) sX[r * kVRow + c + j] = __bfloat162float(e[j]);
    }
    const float* tq_ = chunk_scratch + (static_cast<size_t>(chunk) * H + h) * 2 * kC * kC;
    for (int idx = tid; idx < kC * kC / 4; idx += kThreads) {
      const int r = idx >> 4, c = (idx & 15) * 4;
      const float4 t4 = *reinterpret_cast<const float4*>(tq_ + r * kC + c);
      const float4 q4 = *reinterpret_cast<const float4*>(tq_ + kC * kC + r * kC + c);
      *reinterpret_cast<float4*>(sT + r * kPRow + c) =
          make_float4(tf32(t4.x), tf32(t4.y), tf32(t4.z), tf32(t4.w));
      *reinterpret_cast<float4*>(sQt + r * kPRow + c) =
          make_float4(tf32(q4.x), tf32(q4.y), tf32(q4.z), tf32(q4.w));
    }
    __syncthreads();
    scan_channels(sKd, kKdRow);
    if (tid < kD) {
      sGC[tid] = sKd[(kC - 1) * kKdRow + tid];
      sEC[tid] = ex2(sGC[tid]);
    }
    __syncthreads();
    for (int idx = tid; idx < kC * kD; idx += kThreads) {
      const int r = idx >> 7, c = idx & (kD - 1), at = r * kFRow + c, atd = r * kKdRow + c;
      const float gam = sKd[atd];
      const float e1 = ex2(gam), e2 = ex2(sGC[c] - gam);
      const float kraw = sKg[at];
      sKd[atd] = tf32(kraw * e2);
      sKg[at] = tf32(kraw * e1);
      sQg[at] = tf32(sQg[at] * e1);
    }
    __syncthreads();

    // X = V - (K e^Gamma) S
    {
      float acc[kNT][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < kD; k0 += 8) {
        float a[4];
        frag_a(a, sKg, kFRow, 16 * mt, k0);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 bb = frag_b(sS, kVRow, k0, 8 * (np + j));
          mma_tf32(acc[j], a, bb.x, bb.y);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = 8 * (np + j) + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + gq + 8 * hf;
          sX[r * kVRow + c] = tf32(sX[r * kVRow + c] - acc[j][2 * hf]);
          sX[r * kVRow + c + 1] = tf32(sX[r * kVRow + c + 1] - acc[j][2 * hf + 1]);
        }
      }
    }
    __syncthreads();
    // Delta = T X (T lower triangular: the k blocks up to the tile's rows)
    {
      float acc[kNT][4] = {};
      for (int k0 = 0; k0 < 16 * mt + 16; k0 += 8) {
        float a[4];
        frag_a(a, sT, kPRow, 16 * mt, k0);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 bb = frag_b(sX, kVRow, k0, 8 * (np + j));
          mma_tf32(acc[j], a, bb.x, bb.y);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = 8 * (np + j) + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + gq + 8 * hf;
          sDl[r * kVRow + c] = tf32(acc[j][2 * hf]);
          sDl[r * kVRow + c + 1] = tf32(acc[j][2 * hf + 1]);
        }
      }
    }
    __syncthreads();
    // O = (Q e^Gamma) S + Qt Delta, stored in bf16 (zeros past the row)
    {
      float acc[kNT][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < kD; k0 += 8) {
        float a[4];
        frag_a(a, sQg, kFRow, 16 * mt, k0);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 bb = frag_b(sS, kVRow, k0, 8 * (np + j));
          mma_tf32(acc[j], a, bb.x, bb.y);
        }
      }
      for (int k0 = 0; k0 < 16 * mt + 16; k0 += 8) {
        float a[4];
        frag_a(a, sQt, kPRow, 16 * mt, k0);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 bb = frag_b(sDl, kVRow, k0, 8 * (np + j));
          mma_tf32(acc[j], a, bb.x, bb.y);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + 8 * (np + j) + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + gq + 8 * hf;
          if (t0 + r < S) {
            const bool real = r < n;
            *reinterpret_cast<__nv_bfloat162*>(o + base + r * row_stride + c) =
                __floats2bfloat162_rn(real ? acc[j][2 * hf] : 0.0f,
                                      real ? acc[j][2 * hf + 1] : 0.0f);
          }
        }
      }
    }
    __syncthreads();
    // S <- Diag(e^{Gamma_C}) S + (K e^{Gamma_C - Gamma})^T Delta
    {
      const float e_lo = sEC[16 * w + gq], e_hi = sEC[16 * w + gq + 8];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        s_acc[j][0] *= e_lo;
        s_acc[j][1] *= e_lo;
        s_acc[j][2] *= e_hi;
        s_acc[j][3] *= e_hi;
      }
#pragma unroll 2
      for (int k0 = 0; k0 < kC; k0 += 8) {
        float a[4];
        frag_at(a, sKd, kKdRow, 16 * w, k0);
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const float2 bb = frag_b(sDl, kVRow, k0, 8 * j);
          mma_tf32(s_acc[j], a, bb.x, bb.y);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int c = 8 * j + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * w + gq + 8 * hf;
          sS[r * kVRow + c] = tf32(s_acc[j][2 * hf]);
          sS[r * kVRow + c + 1] = tf32(s_acc[j][2 * hf + 1]);
        }
      }
    }
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
      static_cast<__nv_bfloat16*>(o), seq, heads);
  return static_cast<int>(cudaGetLastError());
}
