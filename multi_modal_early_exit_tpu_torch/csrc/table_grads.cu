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
// P=768, bf16: 226.5 MB, 68 us at 3.35 TB/s; f32: 135 us); its outputs are
// (32 + 2*64) x 12 floats.
//
// Design: the TPU kernel's own formulation, one-hot products on the tensor
// cores. For one query row i, dT[r, h] += sum over keys j of onehot[r, j] *
// g[h, i, j], a (bins x keys) times (keys x heads) product whose one-hot
// factor does not depend on the head: so the buckets are computed once per
// (i, j) for all heads, where a CUDA-core kernel computes them per head or
// spends a scattered load and a shared-memory atomic per element.
// - One CTA per (kCtaRows query rows, batch), four warps; thread 0 also
//   issues the copies. A ring of kStages stages, each one row by four 64-key
//   tiles of g for 16 consecutive (b, h) planes ([tile][plane][key], 2 KB per
//   tile and 128-byte box), filled by TMA from a 3-D map (keys, B*H planes,
//   rows): the planes of heads past H belong to the next batch (or lie past
//   the tensor and read as zeros) and only feed output columns that are
//   dropped.
// - Warp w takes tile w of each stage. It computes the tile's 3 x 64
//   buckets into its own shared memory (keys >= S get bucket -1, which
//   matches no bin), and per table and 16-key step the 16-bin tiles those
//   buckets touch; then per 16-key step it loads g's B fragments (16 keys x
//   8 planes) by ldmatrix, builds the one-hot A fragment of each touched
//   16-bin tile (one bf16x2 compare per register: set.eq gives 1.0 or 0.0)
//   and runs m16n8k16 products, 2 plane tiles per bin tile, for 32 + 64 + 64
//   bins; a bin tile the step does not touch is all zero and is skipped.
//   The accumulators (bins x 16 planes, f32) stay in registers across the
//   CTA's rows and keys. A warp releases its stage with one arrival on the
//   stage's barrier: no barrier across warps per stage.
// - f32 g: each value is split in registers into three bf16 parts (hi =
//   bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry its
//   24 bits exactly), and each product is three bf16 products, lo first; a
//   one-hot factor is exact in bf16.
// - At the end the four warps' sums are added in a fixed order through
//   shared memory, and each CTA writes its (bins x H) sums into its own slot
//   of an f32 partials buffer; a second launch (table_grads_sum_kernel) sums
//   each (bin, head) over the CTAs in a fixed order. No float atomics: the
//   result is the same bits on every run, as every other training kernel's.
// - What binds it on an H100 (PERF.md): the products. The copies alone run
//   at 0.088 ms in bf16 (g and the 4 planes of the next batch), with the
//   buckets 0.108; the one-hot products, at mma.sync's rate, make the rest.
//   A warpgroup wgmma of 64 bins x 16 planes x 16 keys (m64n16k16) costs
//   about 40 SM clocks whatever its accumulator chain, for 8 clocks of
//   tensor-core work (0.279 ms in bf16, 1.31 ms in f32 as two tf32 parts):
//   N is the 16 planes that share one-hot factors, and cannot grow.
// g must be finite at rows and keys in [S, P) that lie inside the tensor: a
// zero one-hot factor times an infinity is not zero.

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;       // four warps, one 64-key tile of a stage each
// a stage: one row by kTiles 64-key tiles, one per warp (4 rows by one tile
// timed the same on an H100)
constexpr int kTiles = 4;
constexpr int kKeys = 64;           // keys per tile
constexpr int kKSteps = kKeys / 16;
constexpr int kPlanes = 16;         // (b, h) planes per box: two 8-plane tiles
constexpr int kBox = kPlanes * 128;  // one row's box: 16 planes of 128 bytes
constexpr int kBinTiles = 4;        // 16-bin tiles per table: up to 64 bins

typedef __nv_bfloat16 bf16;

// bf16 g: one 64-key box per row; f32 g: two 32-key boxes per row
template <typename GT>
struct TgCfg {
  static constexpr bool kF32 = kIsF32<GT>;
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(GT));
  static constexpr int kBoxes = kKeys / kBoxCols;
  static constexpr int kStages = kF32 ? 3 : 4;
  static constexpr int kCtaRows = kF32 ? 16 : 32;
  static constexpr int kStage = kTiles * kBoxes * kBox;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBktOff = kRing;
  static constexpr int kBkt = kTiles * 3 * kKeys * 2;  // each warp's tile's bf16 buckets
  static constexpr int kBarOff = kBktOff + kBkt;  // full, then empty barriers
  static constexpr int kFixed = kBarOff + 2 * kStages * 8;  // then the vectors and LUTs
  // the warps' sums meet in the ring: two slots of 3 x 64 bins x 16 planes
  static_assert(kRing >= 2 * 3 * 64 * kPlanes * 4, "the ring holds the reduction");
};

// where key k of a row's bucket tile sits: thread t's A registers of
// one 16-key step read keys 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3)
// as one 8-byte word
__device__ __forceinline__ int bkt_slot(int k) {
  const int kk = k & 15;
  return (k & ~15) + 4 * ((kk & 7) >> 1) + 2 * (kk >> 3) + (kk & 1);
}

__device__ __forceinline__ uint32_t eq_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __heq2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// x = hi + mid + lo for two f32 values, each part a bf16 pair: part[0] lo,
// part[1] mid, part[2] hi
__device__ __forceinline__ void split3(float2 x, uint32_t (&part)[3]) {
  part[2] = pack_bf16x2(x.x, x.y);
  const float r0 = x.x - __uint_as_float(part[2] << 16);
  const float r1 = x.y - __uint_as_float(part[2] & 0xFFFF0000u);
  part[1] = pack_bf16x2(r0, r1);
  part[0] = pack_bf16x2(r0 - __uint_as_float(part[1] << 16),
                        r1 - __uint_as_float(part[1] & 0xFFFF0000u));
}

template <typename GT>
__global__ void __launch_bounds__(kThreads) table_grads_kernel(
    const __grid_constant__ CUtensorMap map,                // g as (P keys, B*H, P rows)
    const int* __restrict__ pos, const int* __restrict__ cx,
    const int* __restrict__ cy,                              // (B, S)
    const int* __restrict__ lut1, const int* __restrict__ lut2,
    float* __restrict__ partial,  // per CTA: dT1 (nb1, H), then dTx, dTy (nb2, H)
    int S, int H, int box_planes, int nb1, int nb2, int max1, int max2) {
  using Cfg = TgCfg<GT>;
  constexpr bool kF32 = Cfg::kF32;
  constexpr int kStages = Cfg::kStages;
  constexpr int kParts = kF32 ? 3 : 1;
  extern __shared__ __align__(1024) uint8_t tg_smem[];
  uint8_t* smem = tg_smem;
  if (smem_addr(smem) & 1023) __trap();  // the 128-byte swizzle needs 1 KB aligned tiles
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOff);
  uint64_t* empty_bar = full_bar + kStages;
  int* s_vec = reinterpret_cast<int*>(smem + Cfg::kFixed);  // pos, x0, y1 of the batch
  int* s_l1 = s_vec + 3 * S;
  int* s_l2 = s_l1 + max1 + 1;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * Cfg::kCtaRows;
  const int n_rows = min(Cfg::kCtaRows, S - i0);
  const int n_kt = (S + kKeys - 1) / kKeys;
  const int n_kg = (n_kt + kTiles - 1) / kTiles;  // stages per row
  const int n_st = n_rows * n_kg;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // stage st: row i0 + st / n_kg, tiles kTiles (st % n_kg) .. (thread 0)
  auto load_stage = [&](int st) {
    const int kg = st % n_kg;
    uint8_t* dst = smem + (st % kStages) * Cfg::kStage;
    uint64_t* bar = &full_bar[st % kStages];
    const int boxes = min(kTiles, n_kt - kg * kTiles) * Cfg::kBoxes;
    mbar_expect_tx(bar, boxes * box_planes * 128);
    for (int c = 0; c < boxes; ++c) {
      tma_load_3d(dst + c * kBox, &map, bar, kg * kTiles * kKeys + c * Cfg::kBoxCols, b * H,
                  i0 + st / n_kg);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4);  // one arrival per warp
    }
    mbar_init_fence();
    tma_prefetch_map(&map);
    for (int st = 0; st < kStages && st < n_st; ++st) load_stage(st);
  }
  for (int e = tid; e < S; e += kThreads) {
    s_vec[e] = pos[b * S + e];
    s_vec[S + e] = cx[b * S + e];
    s_vec[2 * S + e] = cy[b * S + e];
  }
  for (int e = tid; e <= max1; e += kThreads) s_l1[e] = lut1[e];
  for (int e = tid; e <= max2; e += kThreads) s_l2[e] = lut2[e];
  __syncthreads();  // the vectors, LUTs and barriers

  // bins g and g + 8 of each 16-bin tile m, as bf16 pairs
  uint32_t bins[kBinTiles][2];
#pragma unroll
  for (int m = 0; m < kBinTiles; ++m) {
    const float lo = static_cast<float>(16 * m + g), hi = lo + 8.0f;
    bins[m][0] = pack_bf16x2(lo, lo);
    bins[m][1] = pack_bf16x2(hi, hi);
  }
  const int n_tiles[3] = {(nb1 + 15) / 16, (nb2 + 15) / 16, (nb2 + 15) / 16};
  // accumulator (T, m, nt): bins 16m + g (+8 for e >= 2) of table T, planes
  // 8nt + 2t (+1 for odd e), as mma.sync's m16n8 tile lays it out
  float acc[3][kBinTiles][2][4];
#pragma unroll
  for (int T = 0; T < 3; ++T) {
#pragma unroll
    for (int m = 0; m < kBinTiles; ++m) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[T][m][nt][e] = 0.0f;
      }
    }
  }

  // this warp's buckets [table][key]
  bf16* bkt_tile = reinterpret_cast<bf16*>(smem + Cfg::kBktOff) + warp * 3 * kKeys;
  for (int st = 0; st < n_st; ++st) {
    const int i = i0 + st / n_kg;                // the stage's row
    const int kt = (st % n_kg) * kTiles + warp;  // and this warp's 64 keys
    const bool live = kt < n_kt;
    // the tile's buckets, made by the warp while the copy flies: no barrier
    // across warps; a warp releases its stage with one arrival. Beside them,
    // per table, the 16-bin tiles that each 16-key step touches (bit 4 ks +
    // m): a one-hot factor's other tiles are zero, and their products are
    // skipped
    uint32_t touched[3] = {0, 0, 0};
    if (live) {
#pragma unroll
      for (int mi = 0; mi < 3 * kKeys / 32; ++mi) {
        const int T = mi / (kKeys / 32), k = (mi % (kKeys / 32)) * 32 + lane;
        const int j = kt * kKeys + k;
        int bkt = -1;
        if (j < S) {
          const int* vec = s_vec + T * S;
          const int rel = vec[j] - vec[i];
          const int* lut = T == 0 ? s_l1 : s_l2;
          const int half = (T == 0 ? nb1 : nb2) / 2;
          bkt = (rel > 0 ? half : 0) + lut[min(abs(rel), T == 0 ? max1 : max2)];
        }
        bkt_tile[T * kKeys + bkt_slot(k)] = __float2bfloat16_rn(static_cast<float>(bkt));
        // lanes 0-15 hold step k / 16 = 2 (mi % 2), lanes 16-31 the next
        const uint32_t bit = bkt >= 0 ? 1u << ((k >> 4) * 4 + (bkt >> 4)) : 0u;
        touched[T] |= __reduce_or_sync(0xFFFFFFFFu, bit);
      }
    }
    __syncwarp();
    const int slot = st % kStages;
    const uint8_t* row_tile = smem + slot * Cfg::kStage + warp * Cfg::kBoxes * kBox;
    mbar_wait(&full_bar[slot], (st / kStages) & 1);

    if (live) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        // g's B fragments of the 16 keys, per part: plane tile nt, keys
        // 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of plane 8nt + g
        uint32_t bfr[kParts][2][2];
        if constexpr (kF32) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int plane = 8 * nt + g;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int k = 16 * ks + 8 * hf + 2 * t;  // two f32 of one 16-byte chunk
              const int chunk = (k & 31) >> 2;
              const float2 x = *reinterpret_cast<const float2*>(
                  row_tile + (k >> 5) * kBox + plane * 128 + ((chunk ^ (plane & 7)) << 4) +
                  4 * (k & 3));
              uint32_t part[3];
              split3(x, part);
#pragma unroll
              for (int p = 0; p < 3; ++p) bfr[p][nt][hf] = part[p];
            }
          }
        } else {
          // ldmatrix: matrix mt (lanes 8mt ..) is planes 8 (mt >> 1) .. + 7,
          // the 16-byte chunk 2 ks + (mt & 1) of their 128-byte rows, swizzled
          const int mt = lane >> 3, q = lane & 7;
          const int plane = 8 * (mt >> 1) + q;
          uint32_t d[4];
          ldsm_x4(d, smem_addr(row_tile) + plane * 128 +
                         (((2 * ks + (mt & 1)) ^ (plane & 7)) << 4));
          bfr[0][0][0] = d[0];
          bfr[0][0][1] = d[1];
          bfr[0][1][0] = d[2];
          bfr[0][1][1] = d[3];
        }
#pragma unroll
        for (int T = 0; T < 3; ++T) {
          const uint2 w = *reinterpret_cast<const uint2*>(bkt_tile + T * kKeys + 16 * ks + 4 * t);
#pragma unroll
          for (int m = 0; m < kBinTiles; ++m) {
            if (m >= n_tiles[T] || !((touched[T] >> (4 * ks + m)) & 1u)) continue;
            const uint32_t a[4] = {eq_bf16x2(w.x, bins[m][0]), eq_bf16x2(w.x, bins[m][1]),
                                   eq_bf16x2(w.y, bins[m][0]), eq_bf16x2(w.y, bins[m][1])};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int p = 0; p < kParts; ++p) {
                mma_bf16_16816(acc[T][m][nt], a, bfr[p][nt][0], bfr[p][nt][1]);
              }
            }
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage and of its buckets are done
    if (lane == 0) mbar_arrive(&empty_bar[slot]);
    if (tid == 0 && st + kStages < n_st) {
      mbar_wait(&empty_bar[slot], (st / kStages) & 1);
      load_stage(st + kStages);
    }
  }
  __syncthreads();  // every copy has landed and been read: the ring is idle

  // the four warps' sums in a fixed order through the idle ring: warps 2
  // and 3 into slots 0 and 1, added by warps 0 and 1; then warp 1 into slot
  // 0, added by warp 0, which writes the CTA's sums to its partials slot
  float* red = reinterpret_cast<float*>(smem);
  auto at = [&](int sl, int T, int m, int nt, int e) {
    const int bin = 16 * m + g + 8 * (e >> 1), plane = 8 * nt + 2 * t + (e & 1);
    return red + ((sl * 3 + T) * 64 + bin) * kPlanes + plane;
  };
  auto fold = [&](int writer0, int writers) {
    if (warp >= writer0 && warp < writer0 + writers) {
#pragma unroll
      for (int T = 0; T < 3; ++T)
#pragma unroll
        for (int m = 0; m < kBinTiles; ++m)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) *at(warp - writer0, T, m, nt, e) = acc[T][m][nt][e];
    }
    __syncthreads();
    if (warp < writers) {
#pragma unroll
      for (int T = 0; T < 3; ++T)
#pragma unroll
        for (int m = 0; m < kBinTiles; ++m)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[T][m][nt][e] += *at(warp, T, m, nt, e);
    }
    __syncthreads();
  };
  fold(2, 2);
  fold(1, 1);
  if (warp == 0) {
    const int nbs[3] = {nb1, nb2, nb2};
    const int base[3] = {0, nb1, nb1 + nb2};
    float* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                               (nb1 + 2 * nb2) * H;
#pragma unroll
    for (int T = 0; T < 3; ++T)
#pragma unroll
      for (int m = 0; m < kBinTiles; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int bin = 16 * m + g + 8 * (e >> 1), h = 8 * nt + 2 * t + (e & 1);
            const float v = acc[T][m][nt][e];
            if (bin < nbs[T] && h < H) out[(base[T] + bin) * H + h] = v;
          }
  }
}

// out[e] = the sum of partial[c * n_out + e] over the n_ctas CTAs, in a
// fixed order: thread (slice, e) of a block of 32 entries x 8 slices sums
// CTAs slice, slice + 8, ... in turn, then slice 0 adds the 8 slices' sums
// in order. Bound by reading the partials (2.9 MB at B = 16, S = 768 in
// bf16: 0.9 us at 3.35 TB/s; a few us of latency in all)
__global__ void __launch_bounds__(256) table_grads_sum_kernel(const float* __restrict__ partial,
                                                              float* __restrict__ out,
                                                              int n_ctas, int n_out) {
  __shared__ float red[8][32];
  const int e = blockIdx.x * 32 + threadIdx.x % 32;
  const int slice = threadIdx.x / 32;
  float acc = 0.0f;
  if (e < n_out) {
    for (int c = slice; c < n_ctas; c += 8) acc += partial[static_cast<size_t>(c) * n_out + e];
  }
  red[slice][threadIdx.x % 32] = acc;
  __syncthreads();
  if (slice == 0 && e < n_out) {
    float sum = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 8; ++i) sum += red[i][threadIdx.x];
    out[e] = sum;
  }
}

template <typename GT>
int launch_table_grads(const int* pos, const int* cx, const int* cy, const int* lut1,
                       const int* lut2, const GT* g, float* partial, long long n_partial,
                       float* out, int B, int S, int P, int H, int nb1, int nb2, int max1,
                       int max2, cudaStream_t st) {
  using Cfg = TgCfg<GT>;
  const int n_out = (nb1 + 2 * nb2) * H;
  const dim3 grid((S + Cfg::kCtaRows - 1) / Cfg::kCtaRows, B);
  if (H > kPlanes || nb1 > 16 * kBinTiles || nb2 > 16 * kBinTiles || S > P ||
      n_partial < static_cast<long long>(grid.x) * grid.y * n_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int box_planes = min(kPlanes, B * H);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P), static_cast<cuuint64_t>(B) * H,
                              static_cast<cuuint64_t>(P)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P) * P * sizeof(GT),
                                 static_cast<cuuint64_t>(P) * sizeof(GT)};
  const cuuint32_t box[3] = {Cfg::kBoxCols, static_cast<cuuint32_t>(box_planes), 1};
  CUtensorMap map;
  int err = encode_map(&map, kIsF32<GT> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       3, g, dims, strides, box);
  if (err != 0) return err;
  const size_t smem =
      Cfg::kFixed + sizeof(int) * (3 * static_cast<size_t>(S) + max1 + 1 + max2 + 1);
  auto kernel = table_grads_kernel<GT>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, st>>>(map, pos, cx, cy, lut1, lut2, partial, S, H, box_planes,
                                       nb1, nb2, max1, max2);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  table_grads_sum_kernel<<<(n_out + 31) / 32, 256, 0, st>>>(partial, out,
                                                           static_cast<int>(grid.x * grid.y),
                                                           n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (B, H, P, P) bf16 or f32, contiguous and 16-byte aligned, P a multiple
// of 16, H <= 16, nb1 and nb2 <= 64; out (nb1 + 2 nb2) x H f32, written in
// two launches (the per-CTA sums, then their fixed-order sum); `partial`
// scratch of n_partial floats, at least ceil(S / rows) * B * (nb1 + 2 nb2)
// * H with rows = 32 for a bf16 g and 16 for an f32 one
extern "C" int mmee_table_grads(const void* pos, const void* cx,
                                const void* cy, const void* lut1,
                                const void* lut2, const void* g, int g_is_bf16,
                                void* partial, long long n_partial, void* out, int B,
                                int S, int P, int H, int nb1, int nb2, int max1, int max2,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* x = static_cast<const int*>(cx);
  const int* y = static_cast<const int*>(cy);
  const int* l1 = static_cast<const int*>(lut1);
  const int* l2 = static_cast<const int*>(lut2);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (g_is_bf16) {
    return launch_table_grads(p, x, y, l1, l2, static_cast<const bf16*>(g), part, n_partial, o,
                              B, S, P, H, nb1, nb2, max1, max2, st);
  }
  return launch_table_grads(p, x, y, l1, l2, static_cast<const float*>(g), part, n_partial, o, B,
                            S, P, H, nb1, nb2, max1, max2, st);
}
