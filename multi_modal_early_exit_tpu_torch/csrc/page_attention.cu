// page_attention: bidirectional attention within each page of a packed batch,
// softmax(q k^T * 72^-1/2) v over the page's own rows, for MoonViT at head
// dim 72. q, k and v are (T, H, 72) bf16 at their strides (q and k views of
// the rotary embedding's output, v a view of the qkv product: no copy); page
// i owns rows cu_seqlens[i] .. cu_seqlens[i + 1]; o is (T, H, 72) bf16,
// contiguous. No lse is written.
//
// Replaces no TPU kernel: the JAX package runs no MoonViT. It replaces
// PyTorch's varlen_attn (FlashAttention 2's mma.sync varlen forward, which
// pads 72 to 96-wide tiles) on models/kimi_vl/modeling.py's path.
//
// Bound on an H100 at a served 16-page layer (about 35,000 patches, 16
// heads): 4 x 72 operations a query-key pair and head, q/k/v read and o
// written once (about 0.32 GB, 0.1 ms at 3.35 TB/s) against about 0.43 ms
// of operations at 989 TFLOP/s: bound by operations. A pair also costs one
// exp2, and the exp unit (16 a clock an SM) needs about 80 % of the tensor
// cores' time at their full rate, so the softmax has to overlap the
// products of another warpgroup.
//
// Design (sm_90a), one launch a layer over every page and head:
// - One CTA per (128-row query tile of one page, head): two warpgroups of
//   64 rows. Warp 0 finds the CTA's tile from cu_seqlens (32 pages at a
//   time, a lane each): pages are ranked longest first and each
//   page's tiles run head by head, query tiles fastest, so the longest
//   pages do not form the launch's tail and the CTAs of one (page, head)
//   share its keys in L2.
// - A ring of kStages stages of k and v, each 128 keys (two 64-key
//   blocks), loaded by TMA and completed on mbarriers. Thread 0 loads q and
//   the first stages; then the warp that releases a stage last (a shared
//   counter of releases) loads the stage's next keys. No producer warp: two
//   CTAs of 8 warps leave ptxas 128 registers a thread (it takes about
//   117, no spill), where a ninth warp left it 92 and spills. A tile is two
//   boxes: columns 0-63 (128-byte rows, 128-byte swizzle) and columns 64-79
//   (32-byte rows, 32-byte swizzle), the head dim padded 72 -> 80 on chip
//   only: the maps declare 72 columns, so TMA fills 72-79 with zeros. Rows
//   past T come back as zeros. Two CTAs fit an SM (101 KB of shared memory
//   each), so four warpgroups share its tensor cores and exp unit, one's
//   softmax running beside another's products.
// - S = q k^T runs on wgmma (m64n64k16, both operands K-major as stored, 4
//   k steps in the 128-byte box and 1 in the 32-byte box: depth 80). The
//   online softmax runs in f32 on raw scores: p = exp2(s c - m c) in one FMA
//   and one ex2, c = scale log2(e); the row max is a tree, each thread keeps
//   four partial sums of each row and the quad adds them once at the end.
//   P is rounded to bf16 in registers, which are wgmma's A layout, for O +=
//   P v, v read [key][d] as a transposed (MN-major) B: m64n64 over columns
//   0-63, m64n16 over 64-79 (72-79 zero). Each block's P v runs while the
//   next block's S is issued; both are waited for together.
// - Keys at or past the page's end get -inf (the last block only, a
//   separate instantiation of the block's code). Query rows past the
//   page's end belong to the next page (or lie past T): they are computed
//   and never stored; the epilogue writes each row behind its guard, 72
//   columns. A warpgroup whose rows all lie past the page's end loads and
//   computes nothing.
// What else was timed on an H100 (PERF.md §6, row 13): a producer warp, a
// thread-0 loader polling release barriers, a release per warpgroup,
// 3 or 4 warpgroups a CTA, 64-key stages, q in registers, exp2 partly on
// the FMA pipe, the row sums on the tensor cores, S of the next block
// issued before the softmax, the warpgroups issuing in turns, O rescaled
// only when a row's max grows by 2^8, and the exps two at a time in bf16
// (ex2.approx.ftz.bf16x2, one MUFU.EX2.BF16 each): none was faster.

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 72;           // the head dim
constexpr int kGroups = 2;       // warpgroups per CTA, 64 query rows each
constexpr int kCtas = 2;         // CTAs per SM
constexpr int kRows = 64 * kGroups;
constexpr int kThreads = 128 * kGroups;
constexpr int kKeys = 64;        // keys per block
constexpr int kStages = 2;       // depth of the k/v ring

// a 64-row tile: columns 0-63 in 128-byte rows, then columns 64-79 in
// 32-byte rows; every region 1 KB aligned
constexpr int kBox0 = 64 * 128;
constexpr int kBox1 = 64 * 32;
constexpr int kTile = kBox0 + kBox1;  // 10 KB
// q of every warpgroup, then the ring, 1 KB for alignment; a stage holds k's
// two boxes of 128 rows, then v's
constexpr int kQ = kGroups * kTile;
constexpr int kSub = 2;  // 64-key blocks a stage
constexpr int kKBox0 = kSub * kBox0, kKBox1 = kSub * kBox1;
constexpr int kStage = 2 * (kKBox0 + kKBox1);
constexpr int kSmem = 1024 + kQ + kStages * kStage;

// q, k and v as (72, T, H) maps at their strides: box 0 (64 columns,
// 128-byte swizzle) and box 1 (columns 64-79, 32-byte swizzle), of 64 rows
// for q and 128 for k and v
struct Maps {
  CUtensorMap q0, q1, k0, k1, v0, v1;
};

// the descriptor of a tile of 32-byte rows in 32-byte swizzle atoms (8 rows,
// 256 bytes): K-major, one k step of 16 bf16 a row and 8-row groups `sbo`
// bytes apart; MN-major, 16 columns of n a row and 8-row k groups `sbo`
// bytes apart. The leading offset is unused at these widths
__device__ __forceinline__ uint64_t desc_sw32(const void* tile, uint32_t sbo) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// d (64 x 16 f32) += A (64 x 16 bf16 in registers, the mma.sync A fragment
// layout per warp) times B (16 x 16, MN-major in shared memory: stored [k][n])
__device__ __forceinline__ void wgmma_m64n16k16_rs_tb(float (&d)[8], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// where a CTA works: its page's first row and length, its head and its
// query tile
struct Work {
  int start, len, head, tile;
};

// the CTA's work for warp 0 to find, 32 pages at a time, a lane each:
// pages ranked longest first (ties by index), each page's tiles head by
// head, query tiles fastest. `out` is left as it is if no page owns the CTA
__device__ __forceinline__ void find_work(Work* out, const int* __restrict__ cu_seqlens,
                                          int n_pages, int H, int lane) {
  for (int p0 = 0; p0 < n_pages; p0 += 32) {
    const int p = p0 + lane;
    int start = 0, len = 0;
    if (p < n_pages) {
      start = cu_seqlens[p];
      len = cu_seqlens[p + 1] - start;
    }
    int before = 0;  // the CTAs of the pages ranked before page p
    for (int j0 = 0; j0 < n_pages; j0 += 32) {
      int mine = 0;  // page j0 + lane's length
      if (j0 + lane < n_pages) mine = cu_seqlens[j0 + lane + 1] - cu_seqlens[j0 + lane];
      for (int i = 0; i < 32 && j0 + i < n_pages; ++i) {
        const int lj = __shfl_sync(0xffffffffu, mine, i);
        before += lj > len || (lj == len && j0 + i < p) ? (lj + kRows - 1) / kRows * H : 0;
      }
    }
    const int tiles = (len + kRows - 1) / kRows;
    const int w = static_cast<int>(blockIdx.x) - before;
    if (p < n_pages && w >= 0 && w < tiles * H) *out = Work{start, len, w / tiles, w % tiles};
  }
}

// the loads of a stage (one thread): 128 key rows from `row` on, k then v,
// both boxes of each, completing on `bar`
__device__ __forceinline__ void load_stage(uint8_t* stage, uint64_t* bar, const Maps& maps,
                                           int row, int h) {
  mbar_expect_tx(bar, kStage);
  tma_load_3d(stage, &maps.k0, bar, 0, row, h);
  tma_load_3d(stage + kKBox0, &maps.k1, bar, 64, row, h);
  tma_load_3d(stage + kKBox0 + kKBox1, &maps.v0, bar, 0, row, h);
  tma_load_3d(stage + 2 * kKBox0 + kKBox1, &maps.v1, bar, 64, row, h);
}

// the consumers' accumulators and running softmax state: each thread's
// two rows (g and g + 8 of its warp's 16)
struct State {
  // accumulator fragment (nt, e) at 4 nt + e: row g + 8 (e >> 1), column
  // 8 nt + 2t + (e & 1); o0 holds d columns 0-63, o1 64-79
  float o0[32], o1[8], s[32];
  uint32_t pa[kKeys / 16][4];  // P of the block in flight, wgmma's A registers
  float m_run[2], l_run[2];    // l_run: this thread's part of the row sums
};

// the ring: a stage's loads complete on full; released counts the warps
// that have released it, ever
struct Ring {
  uint64_t full[kStages];
  int released[kStages];
};

// O += P v, issued and committed: P from wgmma's A registers, v (a stage's
// v tile) read [key][d] as a transposed (MN-major) B, m64n64 over columns
// 0-63 and m64n16 over 64-79
__device__ __forceinline__ void issue_pv(State& x, const uint8_t* vt0, const uint8_t* vt1) {
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks) {
    wgmma_m64n64k16_rs_tb(x.o0, x.pa[ks], wgmma_desc(vt0 + ks * 2048, 16, 1024));
  }
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks) {
    wgmma_m64n16k16_rs_tb(x.o1, x.pa[ks], desc_sw32(vt1 + ks * 512, 256));
  }
  wgmma_commit();
}

// key block kb of the CTA's page for one consumer warpgroup: S = q k^T
// (waited for, with the previous block's P v queued before it), the online
// softmax, then O += P v issued and left running. kLast: the page's last
// block, whose keys past the page's end are masked; a separate
// instantiation, since a branch that writes the score registers inside the
// loop makes ptxas serialize every wgmma
template <bool kLast>
__device__ __forceinline__ void attend_block(State& x, int kb, uint8_t* smem, Ring& ring,
                                             const Maps& maps, const Work& work, int n_live,
                                             int lane, int t, uint64_t q_desc0,
                                             uint64_t q_desc1, float scale_log2) {
  float(&s)[32] = x.s;
  float(&o0)[32] = x.o0;
  float(&o1)[8] = x.o1;
  uint32_t(&pa)[kKeys / 16][4] = x.pa;
  const int len = work.len;
  const int n_kb = (len + kKeys - 1) / kKeys;
  const int sb = kb / kSub, j = kb % kSub;  // the stage's block, and this block in it
  const int stage = sb % kStages;
  const uint8_t* st = smem + kQ + stage * kStage;
  const uint8_t* kt0 = st + j * kBox0;
  const uint8_t* kt1 = st + kKBox0 + j * kBox1;
  const uint8_t* vt0 = st + kKBox0 + kKBox1 + j * kBox0;
  const uint8_t* vt1 = st + 2 * kKBox0 + kKBox1 + j * kBox1;
  if (j == 0) mbar_wait(&ring.full[stage], (sb / kStages) & 1);

  // S = q k^T over the 80 columns. Each product's operand registers are
  // fenced before wgmma.fence, so no instruction that defines them is
  // moved between it and the products (ptxas would serialize the wgmmas)
  reg_fence(s);
  wgmma_fence();
  const uint64_t k_desc0 = wgmma_desc(kt0, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16_ss(s, q_desc0 + 2 * ks, k_desc0 + 2 * ks, ks);
  wgmma_m64n64k16_ss(s, q_desc1, desc_sw32(kt1, 256), 1);
  wgmma_commit();
  // S and the previous block's P v are done; at a stage's first block the
  // previous stage is free
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(o0);
  reg_fence(o1);
  reg_fence(pa);
  const int n_sb = (n_kb + kSub - 1) / kSub;
  if (j == 0 && sb > 0 && sb - 1 + kStages < n_sb) {  // it holds more keys next
    __syncwarp();
    if (lane == 0) {
      const int free = (sb - 1) % kStages, b = sb - 1 + kStages;
      if ((atomicAdd(&ring.released[free], 1) + 1) % (4 * n_live) == 0) {  // the last release
        load_stage(smem + kQ + free * kStage, &ring.full[free], maps,
                   work.start + b * kSub * kKeys, work.head);
      }
    }
  }

  if constexpr (kLast) {  // keys at or past the page's end
    const int k0 = kb * kKeys;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= len) s[i] = -INFINITY;
    }
  }
  // the running row max, as a tree; every block has a key in the page, so
  // it is finite
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m4[4];  // over n-tiles 2c and 2c + 1: s[4 nt + 2r], s[4 nt + 2r + 1]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m4[c] = fmaxf(fmaxf(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]),
                    fmaxf(s[8 * c + 4 + 2 * r], s[8 * c + 5 + 2 * r]));
    }
    mx[r] = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(fmaxf(m4[2], m4[3]), x.m_run[r]));
  }
  float alpha[2], mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((x.m_run[r] - mx[r]) * scale_log2);  // 0 on the first block
    x.m_run[r] = mx[r];
    mc[r] = mx[r] * scale_log2;
  }
  // p = exp2(s c - m c); this thread's part of each row sum, in four
  // partial sums a row
  float rs[2][4] = {};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -mc[(i >> 1) & 1]));
    rs[(i >> 1) & 1][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x.l_run[r] = x.l_run[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    o0[4 * dt + 0] *= alpha[0];
    o0[4 * dt + 1] *= alpha[0];
    o0[4 * dt + 2] *= alpha[1];
    o0[4 * dt + 3] *= alpha[1];
  }
#pragma unroll
  for (int dt = 0; dt < 2; ++dt) {
    o1[4 * dt + 0] *= alpha[0];
    o1[4 * dt + 1] *= alpha[0];
    o1[4 * dt + 2] *= alpha[1];
    o1[4 * dt + 3] *= alpha[1];
  }
  // O += P v: P rounded to bf16 in wgmma's A registers (k step ks, register
  // j: row g + 8 (j & 1), keys 16 ks + 8 (j >> 1) + 2t, +1)
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[ks][j] = pack_bf16x2(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
  }
  reg_fence(o0);
  reg_fence(o1);
  reg_fence(pa);
  wgmma_fence();
  issue_pv(x, vt0, vt1);
}

__global__ void __launch_bounds__(kThreads, kCtas)
    page_attention_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ o,
                          const int* __restrict__ cu_seqlens, int n_pages, int H,
                          float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t q_bar;
  __shared__ Work work;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) work = Work{0, 0, 0, 0};
    __syncwarp();
    find_work(&work, cu_seqlens, n_pages, H, threadIdx.x);
    __syncwarp();
  }
  if (threadIdx.x == 0 && work.len > 0) {  // reads what its warp wrote
    const int h = work.head, q0 = work.start + work.tile * kRows;  // the tile's first row
    const int n_live = min(kGroups, (work.len - work.tile * kRows + 63) / 64);
    const int n_kb = (work.len + kKeys - 1) / kKeys;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      ring.released[s] = 0;
    }
    mbar_init(&q_bar, 1);
    mbar_init_fence();
    // q and the ring's first stages; each later stage is loaded by the warp
    // that releases it last
    tma_prefetch_map(&maps.q0);
    tma_prefetch_map(&maps.q1);
    tma_prefetch_map(&maps.k0);
    tma_prefetch_map(&maps.k1);
    tma_prefetch_map(&maps.v0);
    tma_prefetch_map(&maps.v1);
    mbar_expect_tx(&q_bar, n_live * kTile);
    for (int w = 0; w < n_live; ++w) {
      tma_load_3d(smem + w * kTile, &maps.q0, &q_bar, 0, q0 + 64 * w, h);
      tma_load_3d(smem + w * kTile + kBox0, &maps.q1, &q_bar, 64, q0 + 64 * w, h);
    }
    for (int sb = 0; sb < kStages && sb * kSub < n_kb; ++sb) {
      load_stage(smem + kQ + sb * kStage, &ring.full[sb], maps, work.start + sb * kSub * kKeys,
                 h);
    }
  }
  __syncthreads();
  // no page owns the CTA: cu_seqlens holds fewer rows than the host's offsets
  if (work.len == 0) return;
  const int len = work.len, h = work.head;
  // warpgroups with a row in the page
  const int n_live = min(kGroups, (len - work.tile * kRows + 63) / 64);
  const int n_kb = (len + kKeys - 1) / kKeys;

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  if (wg >= n_live) return;  // every row past the page's end
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's two rows within the page's tile
  const int row[2] = {work.tile * kRows + 64 * wg + warp * 16 + g,
                      work.tile * kRows + 64 * wg + warp * 16 + g + 8};

  State x;
#pragma unroll
  for (int i = 0; i < 32; ++i) x.o0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) x.o1[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x.m_run[r] = -INFINITY;
    x.l_run[r] = 0.0f;
  }
  // K-major q and k: 8-row atoms 1 KB (box 0) or 256 bytes (box 1) apart,
  // a k step 32 bytes on in box 0; MN-major v: a 16-key k step 2 KB on in
  // box 0, 512 bytes in box 1
  const uint8_t* qt = smem + wg * kTile;
  const uint64_t q_desc0 = wgmma_desc(qt, 16, 1024);
  const uint64_t q_desc1 = desc_sw32(qt + kBox0, 256);
  mbar_wait(&q_bar, 0);

  for (int kb = 0; kb + 1 < n_kb; ++kb) {
    attend_block<false>(x, kb, smem, ring, maps, work, n_live, lane, t, q_desc0, q_desc1,
                        scale_log2);
  }
  attend_block<true>(x, n_kb - 1, smem, ring, maps, work, n_live, lane, t, q_desc0, q_desc1,
                     scale_log2);
  wgmma_wait<0>();
  reg_fence(x.o0);
  reg_fence(x.o1);

  // o / l, each row behind its guard: 72 columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = x.l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[r] >= len) continue;
    const float inv = 1.0f / l;
    bf16* orow = o + (static_cast<size_t>(work.start) + row[r]) * H * kD + h * kD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      store_pair(orow + dt * 8 + 2 * t, x.o0[4 * dt + 2 * r] * inv, x.o0[4 * dt + 2 * r + 1] * inv);
    }
    store_pair(orow + 64 + 2 * t, x.o1[2 * r] * inv, x.o1[2 * r + 1] * inv);
  }
}

// the (72, T, H) map of an operand at its element strides (row, head),
// boxes of 64 rows: columns 0-63 in 128-byte swizzle (sm90.cuh's
// encode_map), or columns 64-79 in 32-byte swizzle, cached alike
int encode_operand(CUtensorMap* map, const void* x, int T, int H, long long row_stride,
                   long long head_stride, bool tail, int box_rows = 64) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(head_stride) * 2};
  if (!tail) {
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box);
  }
  const cuuint32_t box[3] = {16, static_cast<cuuint32_t>(box_rows), 1};
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = x;
  key.rank = 3;
  for (int i = 0; i < 3; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i < 2) key.strides[i] = strides[i];
  }
  constexpr int kSlots = 256;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static bool filled[kSlots];
  static std::mutex lock;
  uint64_t hash = 1469598103934665603ull;  // FNV-1a over the key's bytes
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(key); ++i) hash = (hash ^ bytes[i]) * 1099511628211ull;
  const int slot = static_cast<int>(hash % kSlots);
  std::lock_guard<std::mutex> guard(lock);
  if (filled[slot] && memcmp(&keys[slot], &key, sizeof(key)) == 0) {
    *map = maps[slot];
    return 0;
  }
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) {
    return kTensorMapError + static_cast<int>(CUDA_ERROR_INVALID_CONTEXT);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(r);
  keys[slot] = key;
  maps[slot] = *map;
  filled[slot] = true;
  return 0;
}

}  // namespace

// q, k, v: (T, H, 72) bf16 at element strides (row, head), the last dim
// contiguous; o: (T, H, 72) bf16, contiguous; cu_seqlens: n_pages + 1 int32
// offsets on the device and `starts` the same on the host,
// from which the grid is counted. Returns cudaGetLastError() (or a failed
// encode's code)
extern "C" int mmee_page_attention(const void* q, const void* k, const void* v, void* o,
                                   const int* cu_seqlens, const int* starts, int n_pages, int T,
                                   int H, long long q_row, long long q_head, long long k_row,
                                   long long k_head, long long v_row, long long v_head,
                                   float scale, void* stream) {
  if (n_pages < 1) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;  // every page's query tiles, every head
  for (int i = 0; i < n_pages; ++i) ctas += (starts[i + 1] - starts[i] + kRows - 1) / kRows * H;
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  int err = 0;
  const void* ops[3] = {q, k, v};
  const long long rows[3] = {q_row, k_row, v_row}, heads[3] = {q_head, k_head, v_head};
  CUtensorMap* box0[3] = {&maps.q0, &maps.k0, &maps.v0};
  CUtensorMap* box1[3] = {&maps.q1, &maps.k1, &maps.v1};
  for (int i = 0; i < 3 && err == 0; ++i) {
    const int box_rows = i == 0 ? 64 : kSub * kKeys;
    err = encode_operand(box0[i], ops[i], T, H, rows[i], heads[i], false, box_rows);
    if (err == 0) err = encode_operand(box1[i], ops[i], T, H, rows[i], heads[i], true, box_rows);
  }
  if (err != 0) return err;
  static std::atomic<uint64_t> ready{0};
  err = set_smem_limit_once(page_attention_kernel, kSmem, ready);
  if (err != 0) return err;
  page_attention_kernel<<<ctas, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<bf16*>(o), cu_seqlens, n_pages, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
