// flash_attention_packed_train: the forward and backward of
// softmax(q k^T * d^-1/2 + bias) v on the packed (B, S, H*D) layout, with
// position-hash dropout on the probabilities, and the same forward and
// backward on the head form, (B, H, S, D) tensors given by their strides.
// The forward without lse and dropout is also flash_attention_packed, the
// deterministic attention of the serving path, and, with the bias built on
// chip from the relative-position tables instead of read from a (B, H, P,
// P) tensor, fused_bias_attention.
//
// Replaces seven TPU kernels: `_kernel` behind `fused_bias_attention`
// (multi_modal_early_exit_tpu/ops/fused_bias_attention.py:70 and :165), and
// six of multi_modal_early_exit_tpu/ops/flash_attention.py:
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
// with f32 accumulation: bf16 on the bf16 tensor cores; f32 good to about
// f32's precision, in every kernel by six bf16 products of operands split
// into three bf16 parts (split_bf16x3 below) on the bf16 ones. The f32
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
// 73 us for its 7.25e10 FLOPs; the two-kernel design below reads the bias
// twice and q/k/v/do twice: about 1.13 GB, 340 us (0.91 GB and 270 us
// without gbias). In f32 the bytes double, and the FLOPs run
// at 165 TFLOP/s (the 989 bf16 TFLOP/s over the 6 products of split
// operands): the forward 181 us by bytes against 176 us by operations; the
// split-operand design reads the parts of k/v in their place (642 MB, 192
// us) after a pre-pass that reads k/v and writes the parts (189 MB, 56
// us). The two-kernel backward reads the bias twice and the split
// parts of q/k/v/do twice, 2.27 GB chained (680 us) and 1.81 GB plain
// (540 us), against 440 us by operations.
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
//   An f32 bias tile takes two 32-column boxes per block.
// - The products run on wgmma: S = q k^T (m64n64k16, k from shared
//   memory), then O += P v with P from registers (the S accumulator is
//   already wgmma's A layout) and v read in its stored [key][d] layout as a
//   transposed (MN-major) B: no transposed copy. In bf16 P is rounded to
//   bf16 and q read from shared memory. ptxas fits every bf16 role in 96
//   registers at two CTAs per SM, so no setmaxnreg rebalancing: an increase
//   the CTA's register pool cannot meet blocks its warpgroup for good.
// - f32 operands run the same body on the bf16 tensor cores, as the
//   backward does: the caller's pre-pass (split_bf16x3_kernel) writes the
//   three bf16 parts of k and v once per call, and the maps load every part
//   of a tile (part p of batch b at batch coordinate p B + b). q is read
//   once per CTA: it is loaded as f32 and each consumer thread splits its
//   fragment into three sets of wgmma A registers, so S is six RS products
//   that read only k's parts from shared memory (at n = 64 an SS product
//   reads its two operands at the shared memory's rate), and P v six RS
//   products with P, unrounded (times c under dropout), split the same way.
//   The ring is 193 KB with an f32 bias (161 KB with a bf16 one): one CTA
//   per SM, whose two warpgroups' products and softmax overlap each other;
//   ptxas gives a thread 168 registers (28 bytes of spills with dropout).
//   Variants timed on an H100 (PERF.md): q's parts from shared memory (SS)
//   or loaded into registers from a pre-pass, and the warpgroups issuing
//   their products in turns (named barriers), were all slower.
// - When P / 64 is odd the last tile has 64 real rows: the producer loads
//   only the live warpgroups' q and bias, so nothing past P is read; a
//   warpgroup whose rows all lie at or past S only writes their lse.
// - Dropout and the lse are template parameters: the rate-0 instantiation
//   has no hash, flash_attention_packed's stores no lse. The mask bits of a
//   block are made before its stage is waited for, so the hash overlaps the
//   loads in flight.
// - At rate 0 the lse and no-lse instantiations run the same arithmetic, so
//   the training forward gives flash_attention_packed's bits, which the
//   training schedules that run one or the other rely on.
// - A built bias (kBuilt, fused_bias_attention: no dropout, no lse) is the
//   same body with another source for each score's bias:
//     bias[b, h, i, j] = (T1[bkt1(pos_j - pos_i), h] + Tx[bkt2(x0_j - x0_i), h])
//                        + Ty[bkt2(y1_j - y1_i), h]  (+ -1e30 where j is masked)
//   rounded once to q's type, the value materialize_bias.cu writes, so the
//   output is materialize_bias + flash_attention_packed's, bit for bit, in
//   bf16 and in f32, and no (B, H, P, P) tensor exists. Bound at B=16,
//   S=768, H=12, D=64, bf16: q/k/v read and o written (75.5 MB, 22.6 us at
//   3.35 TB/s) against 29 us for its 2.9e10 FLOPs, so by operations (f32:
//   176 us at the split-operand rate); the bias stream of the pair (226.5
//   MB written, then read) is gone. The bucket of a distance depends only on
//   its sign and on min(|rel|, max), so each CTA first expands this head's
//   three table columns over the clamped distances (e1[n] = T1[bkt1(n -
//   max1), h] for n in [0, 2 max1], ex and ey over [0, 2 max2]: 5 KB at the
//   default 128 / 256, from the LUTs of bucket_lut); a score's bias is then
//   three gathers at clamp(v_j - v_i + max) (one DPX add-min-relu each), two
//   adds in materialize_bias's order, the mask's add and the rounding, all
//   in the consumers' registers where the bias tile was read. The producer
//   warp's lanes stage each key block's pos/x0/y1/mask term (64 x 16 bytes,
//   plain loads: a (B, S) row need not be 16-byte aligned) beside its k/v
//   tiles, so a stage holds no bias tile. What binds it on an H100 (PERF.md):
//   the bias arithmetic's issue slots, about 0.12 ms of 0.26 in bf16 (with
//   no bias at all the same kernel reads 0.145); conflict-free gathers, the
//   bias made while the score products run, and a third stage gained
//   nothing, and builder warps that write the bias tile for the unchanged
//   consumers (13 warps, one CTA per SM) lost (0.415 ms).
//
// Backward design. The forward's online softmax gives lse = m + log(sum),
// which excludes the dropout factor c(i, j) (it multiplies the unnormalised
// exp before the p.v product, and the division by the undropped row sum
// makes that equal to dropout applied to the normalised p). Deterministic
// (no float atomics), in two kernels that each recompute p = exp(s - lse):
//   (A) one CTA per (64-row q block over all P rows, head, batch) computes
//       delta = rowsum(do * o) for its rows, walks every key block and
//       writes dbias = ds (+ gbias) for the whole P x P plane (zero past S),
//       and dq = ds k * scale; it also writes delta (B, H, P) f32 for (B);
//   (B) one CTA per (64-key block, head, batch) walks every q block and
//       accumulates dv = (p c)^T do and dk = ds^T q * scale in registers.
// In bf16, ds is rounded to bf16 before the dq/dk products and p c before
// dv, as the TPU kernel does; dq/dk/dv accumulate in f32 and are rounded
// once.
// - sm_90a, bwd_dq_kernel and bwd_dkv_kernel, both operand types: the
//   forward's TMA ring, with one warpgroup per CTA whose thread 0 also
//   issues the copies
//   ((A): each key block's k, v, bias and gbias tiles; (B): each q block's
//   q, do and bias tiles, with its lse and delta by bulk copies), refilling
//   a stage once all four warps have released it. No producer warp: 3 CTAs
//   of 4 warps put 3 warps on each SM sub-partition and leave ptxas 168
//   registers, where 2 CTAs of 5 warps did the same. All five products run
//   on wgmma: the two score products with every operand K-major as stored,
//   the three gradient products with ds or p c rounded into wgmma's A
//   registers (the accumulator layout is the A layout) and k, q, do read
//   [row][d] as MN-major B operands, so no transposed copy exists. The
//   chained backward spends 680 of its 830 MB on the three bias planes, so
//   (A) reads bias and gbias as swizzled tiles by TMA and writes dbias over
//   the tile it read (gbias when chained, else bias), each warp its own 16
//   rows out by a TMA store, never element by element; (B) reads its bias
//   tile [query][key] transposed. bf16 bias tiles are read and written in
//   the accumulator pattern by ldmatrix(.trans) / stmatrix, 4 instructions
//   per tile and thread, with no bank conflict through the swizzle; f32
//   ones by conflict-free 8-byte (A) or 4-byte (B) accesses. Each block's
//   score products queue behind the previous block's gradient products,
//   and its dropout mask bits (a template parameter: rate 0 has no hash)
//   are made while both run. (A) reads its bias pairs 4 at a time, which
//   keeps its dropout instantiations free of spills. Rows and keys at or
//   past S are masked by index (the head-form lse is padded with 0 there),
//   and a block with every row and key < S skips the tests; a block of (A)
//   with no row or key < S loads only gbias and runs no product. In bf16
//   (A) takes 64 KB of shared memory (80 KB chained: two CTAs per SM) and
//   (B) 65 KB.
// - f32 operands run the same two kernels on the bf16 tensor cores.
//   wgmma takes tf32 only K-major, and three of the five products read B
//   MN-major, so each f32 operand x is split into three bf16 parts, hi =
//   bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry x's 24
//   bits exactly (both differences are exact in f32, and bf16 has f32's
//   exponent range), and a b becomes six bf16 products summed in f32, the
//   small ones first: a_lo b_hi, a_hi b_lo, a_mid b_mid, a_mid b_hi,
//   a_hi b_mid, a_hi b_hi (the three terms of order 2^-24 and below are
//   left out). That is 3xTF32's work, 6 bf16 passes against 3 TF32 ones.
//   A pre-pass kernel (split_bf16x3_kernel) writes the parts of q, k, v
//   and do once per call as contiguous bf16 tensors, so the kernels' TMA
//   maps load every part into a swizzled bf16 tile as in bf16 (one map per
//   operand, part p of batch b at batch coordinate p B + b); ds and p c are
//   split in registers into three sets of wgmma A fragments. A stage then
//   holds three tiles per operand, so with an f32 bias the streamed blocks
//   are 32 wide (BwdTiling): (A) takes 112 KB and (B) 113 KB, two CTAs per
//   SM (the chained (A) 64 wide, 208 KB, one). delta is still rowsum(do o)
//   of the f32 do and o.
// - Backward with table gradients, three kernels, deterministic as well:
//   (A') is (A)'s tables mode (bwd_dq_kernel<..., kTables>, on (A)'s body in
//   both operand types): it walks only the keys < S, loads no gbias, writes
//   no dbias and keeps each block's f32 ds in registers; while the next
//   block's score products run, each warp sums that ds into a [bin][row]
//   f32 histogram of its own 16 rows, each thread walking its own keys of
//   its two rows, the quad's 6 (row, table) pairs in 6 phases, so no entry
//   has two writers and each sums in a fixed order; the CTA then sums each
//   bin over its 64 rows in a fixed order into a per-CTA partial. (B) is
//   bwd_dkv_kernel; (C) sums the partials of each (bin, head) over (b, q
//   block) in a fixed order. It sums f32 ds: the Pallas kernel's bf16 ds
//   stash only saves VMEM. The histogram (40 KB) keeps (A') in bf16 at two
//   CTAs per SM (113 KB), against (A)'s three. Bound at B=16, S=P=768,
//   H=12, D=64, bf16: it must read the bias (226.5 MB), q/k/v/o/do (94.4 MB)
//   and the lse, and write dq/dk/dv (56.6 MB): 113 us at 3.35 TB/s, against
//   73 us for its 7.25e10 FLOPs; the design reads the bias twice, as (A)
//   and (B) do, and q/k/v/do twice: 0.68 GB, 203 us. No (B, H, P, P)
//   cotangent exists.
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
constexpr int kMaxDistance = 1024;  // the largest max_distance of a built bias

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// c(i, j) of one (b, h) plane: 1/keep where the element is kept, else 0.
// The element is kept where u = (bits >> 8) / 2^24 < keep (0 < keep <= 1):
// u and keep * 2^24 are exact in f32, so that is bits >> 8 <
// ceil(keep * 2^24), which is bits <= ceil(keep * 2^24) * 256 - 1, one
// integer compare with the same outcome
struct Dropout {
  uint32_t state;
  uint32_t keep_max;  // the largest kept hash
  float inv_keep;
  __device__ Dropout(int seed, int bh, float keep, float inv_keep_)
      : state(lowbias32(static_cast<uint32_t>(seed) ^
                        (static_cast<uint32_t>(bh) * 0x9E3779B1u))),
        inv_keep(inv_keep_) {
    const float k24 = ceilf(keep * 16777216.0f);
    keep_max = k24 >= 16777216.0f ? 0xFFFFFFFFu : static_cast<uint32_t>(k24) * 256u - 1u;
  }
  __device__ __forceinline__ bool keeps(int i, int j) const {
    const uint32_t bits = lowbias32(state + static_cast<uint32_t>(i) * 0x85EBCA77u +
                                    static_cast<uint32_t>(j) * 0x27D4EB2Fu);
    return bits <= keep_max;
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

// ---------------------------------------------------------------------------
// operands split into bf16 parts: how f32 operands reach the bf16 tensor
// cores in the forward and in the backward (wgmma takes tf32 only K-major,
// and the p v, dq, dk and dv products read B MN-major)
// ---------------------------------------------------------------------------

// the bf16 parts of an operand tile: the tile itself in bf16; hi, mid and
// lo in f32, each a bf16 tile of 128-byte rows
template <typename T>
constexpr int kParts = kIsF32<T> ? 3 : 1;

// the bf16 products that make up one product of split operands, smallest
// first, as (part of A, part of B) with 0 hi, 1 mid, 2 lo: lo hi, hi lo,
// mid mid, mid hi, hi mid, hi hi; the three of order 2^-24 and below (mid
// lo, lo mid, lo lo) are left out. bf16 operands: hi hi alone
template <typename T>
constexpr int kTerms = kIsF32<T> ? 6 : 1;
__host__ __device__ constexpr int term_a(int terms, int i) {
  return terms == 1 ? 0 : i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int terms, int i) {
  return terms == 1 ? 0 : i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0;
}

// the low (c = 0) or high (c = 1) bf16 of a pair, as f32
__device__ __forceinline__ float pair_half(uint32_t w, int c) {
  return __uint_as_float(c ? (w & 0xFFFF0000u) : (w << 16));
}

// x = hi + mid + lo for two values, each part a bf16 pair as wgmma's A
// registers take it: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid). Both differences are exact in f32, and the parts hold x's 24 bits
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  const float r0 = x0 - pair_half(hi, 0), r1 = x1 - pair_half(hi, 1);
  mid = pack_bf16x2(r0, r1);
  lo = pack_bf16x2(r0 - pair_half(mid, 0), r1 - pair_half(mid, 1));
}

// the score accumulators (index 4nt + e: row g + 8 (e >> 1), column
// 8nt + 2t + (e & 1)) as wgmma's A registers, kK k steps of 16 columns, one
// set per part: rounded to bf16 (one part), or split into hi, mid and lo
// (three)
template <int kN, int kK>
__device__ __forceinline__ void to_a(uint32_t (&a)[kN][kK][4], const float (&x)[8 * kK]) {
#pragma unroll
  for (int ks = 0; ks < kK; ++ks) {
    // j: row g, columns 16ks + 2t; row g+8; row g, columns 16ks + 8 + 2t; row g+8
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = x[8 * ks + 2 * j], x1 = x[8 * ks + 2 * j + 1];
      if constexpr (kN == 1) {
        a[0][ks][j] = pack_bf16x2(x0, x1);
      } else {
        split_pair(x0, x1, a[0][ks][j], a[1][ks][j], a[2][ks][j]);
      }
    }
  }
}

// d = A B^T over d (64 wide), A and B [row][d] operand tiles read K-major
// as stored (part tiles kPartA and kPartB bytes apart): every product of
// parts, each over 4 k steps of 16; B has as many rows as d has columns
template <typename T, int kPartA, int kPartB, int kN>
__device__ __forceinline__ void wgmma_by_rows(float (&d)[kN], uint64_t a, uint64_t b) {
#pragma unroll
  for (int i = 0; i < kTerms<T>; ++i) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_ss(d, a + term_a(kTerms<T>, i) * (kPartA >> 4) + 2 * ks,
               b + term_b(kTerms<T>, i) * (kPartB >> 4) + 2 * ks, i + ks);
    }
  }
}

// the same with A (64 x 64 over d) in registers, one set of fragments per
// part (4 k steps of 16), and d 64 x 64
template <typename T, int kPartB>
__device__ __forceinline__ void wgmma_by_rows_rs(float (&d)[32],
                                                 const uint32_t (&a)[kParts<T>][4][4], uint64_t b) {
#pragma unroll
  for (int i = 0; i < kTerms<T>; ++i) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_m64n64k16_rs(d, a[term_a(kTerms<T>, i)][ks],
                         b + term_b(kTerms<T>, i) * (kPartB >> 4) + 2 * ks, i + ks);
    }
  }
}

// d (64 x 64) += A B, A (64 x 16 kK) in registers as one set of fragments
// per part, B a [k][n] operand tile read as a transposed (MN-major) B (part
// tiles kPartB bytes apart), a 16-row k step 2 KB on
template <typename T, int kPartB, int kK>
__device__ __forceinline__ void wgmma_by_cols(float (&d)[32],
                                              const uint32_t (&a)[kParts<T>][kK][4], uint64_t b) {
#pragma unroll
  for (int i = 0; i < kTerms<T>; ++i) {
#pragma unroll
    for (int ks = 0; ks < kK; ++ks) {
      wgmma_m64n64k16_rs_tb(d, a[term_a(kTerms<T>, i)][ks],
                            b + term_b(kTerms<T>, i) * (kPartB >> 4) + ks * (2048 >> 4));
    }
  }
}

// rows [r0, r0 + rows) of an operand into dst, part by part (part p of
// batch b is batch p B + b of the operand's map; part tiles `part` bytes
// apart), in boxes of kBoxRows rows (one thread)
template <int kParts_, int kBoxRows>
__device__ __forceinline__ void load_operand(uint8_t* dst, const CUtensorMap* map,
                                             uint64_t* bar, int r0, int rows, int part, int h,
                                             int b) {
#pragma unroll
  for (int p = 0; p < kParts_; ++p) {
    for (int rb = 0; rb < rows; rb += kBoxRows) {
      tma_load_4d(dst + p * part + rb * 128, map, bar, 0, r0 + rb, h,
                  p * static_cast<int>(gridDim.z) + b);
    }
  }
}

// ---------------------------------------------------------------------------
// forward (sm_90a): a TMA-fed ring of k/v/bias stages and two wgmma
// consumer warpgroups; bf16 operands as stored, f32 operands as their three
// bf16 parts
// ---------------------------------------------------------------------------

constexpr int kFwdStages = 2;        // depth of the shared-memory ring
constexpr int kFwdRows = 128;        // query rows per CTA: 2 consumer warpgroups of 64
constexpr int kFwdConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kFwdThreads = kFwdConsumers + 32;  // and one producer warp
constexpr int kPartTile = 64 * 128;  // 64 rows of one bf16 part: 128-byte rows

// a 64-row x 64-column tile of T as TMA writes it: one box of 128-byte rows
// in bf16, two (32 columns each, 8 KB apart) in f32
template <typename T>
struct Tile {
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));
  static constexpr int kBoxes = 64 / kBoxCols;
  static constexpr int kBytes = 64 * 64 * static_cast<int>(sizeof(T));
};

// q (both warpgroups' rows, as loaded: T), then the ring; each stage k, v
// (every part: kOpTile) and the two warpgroups' bias tiles, or with a built
// bias the key block's vectors (64 int4); 1 KB for alignment. bf16
// throughout: 81 KB, two CTAs per SM; f32 operands: 193 KB with an f32
// bias, 161 KB with a bf16 one, one. A built bias: bf16 51 KB, f32 131 KB,
// then the expanded tables (built_tables_bytes, 5 KB at the default
// distances)
template <typename T, typename BiasT, bool kBuilt = false>
struct FwdSmem {
  static constexpr int kQTile = Tile<T>::kBytes;
  static constexpr int kOpTile = kParts<T> * kPartTile;
  static constexpr int kQ = 2 * kQTile;
  static constexpr int kBias = kBuilt ? kBK * 16 : 2 * Tile<BiasT>::kBytes;
  static constexpr int kStage = 2 * kOpTile + kBias;
  static constexpr int kBytes = 1024 + kQ + kFwdStages * kStage;
};

// a bias built on chip (fused_bias_attention): the (B, S) int32 vectors,
// the three (bins, H) f32 tables (scale folded in) and the LUTs of
// bucket_lut (the one-sided bucket of |rel| = 0 .. max)
struct BuiltBias {
  const int* pos;
  const int* cx;
  const int* cy;
  const int* mask;
  const float* t1;
  const float* tx;
  const float* ty;
  const int* lut1;
  const int* lut2;
  int nb1, nb2, max1, max2;
};

// the expanded tables of a built bias: e1 over 2 max1 + 1 clamped
// distances, ex and ey over 2 max2 + 1 each, f32
__host__ __device__ constexpr int built_tables_bytes(int max1, int max2) {
  return 4 * ((2 * max1 + 1) + 2 * (2 * max2 + 1));
}

// e1[n] = T1[bkt1(n - max1), h] for n in [0, 2 max1], then ex and ey over
// [0, 2 max2]: the table entry of every distance clamped to [-max, max],
// which is the entry any distance reads, since its bucket depends on its
// sign and on min(|rel|, max) alone (the buckets of materialize_bias.cu,
// from the same LUTs)
__device__ void build_tables(float* e, const BuiltBias& bb, int h, int H, int tid,
                             int threads) {
  const int n1 = 2 * bb.max1 + 1, n2 = 2 * bb.max2 + 1;
  for (int n = tid; n < n1; n += threads) {
    const int rel = n - bb.max1;
    e[n] = bb.t1[((rel > 0 ? bb.nb1 / 2 : 0) + bb.lut1[abs(rel)]) * H + h];
  }
  for (int n = tid; n < n2; n += threads) {
    const int rel = n - bb.max2;
    const int bkt = (rel > 0 ? bb.nb2 / 2 : 0) + bb.lut2[abs(rel)];
    e[n1 + n] = bb.tx[bkt * H + h];
    e[n1 + n2 + n] = bb.ty[bkt * H + h];
  }
}

// keys k0 + c (c = lane, lane + 32) of batch b as the consumers read them:
// pos, x0, y1 and the mask's term (the bits of 0.0f, or of -1e30f where the
// key is masked); keys >= S as zeros, masked. One lane per key, plain loads
// (a (B, S) row need not be 16-byte aligned for a bulk copy)
__device__ __forceinline__ void stage_key_vectors(int4* dst, const BuiltBias& bb, int b, int S,
                                                  int k0, int lane) {
#pragma unroll
  for (int c = lane; c < kBK; c += 32) {
    const int j = k0 + c;
    int4 e = make_int4(0, 0, 0, __float_as_int(-1e30f));
    if (j < S) {
      const size_t at = static_cast<size_t>(b) * S + j;
      e = make_int4(bb.pos[at], bb.cx[at], bb.cy[at],
                    __float_as_int(bb.mask[at] != 0 ? 0.0f : -1e30f));
    }
    dst[c] = e;
  }
  __threadfence_block();
}

// named barrier 1 over the two consumer warpgroups (the producer warp runs on)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kFwdConsumers) : "memory");
}

// q, k, v as (D, rows, H, B) maps, boxes of 64 rows: q at its strides (f32:
// two 32-column boxes), k and v too in bf16, and in f32 as their parts (3 B
// batches); the bias as a (P, B*H*P) map, boxes of 64 rows
struct FwdMaps {
  CUtensorMap q, k, v, bias;
};

// bias (row lr, keys 8nt + 2t, +1) of a warpgroup's 128-byte-swizzled
// tile: the 16-byte chunk c of row lr sits at chunk c ^ (lr % 8), so the 8
// rows of an accumulator fragment fall on 8 different bank groups. The f32
// forward reads its f32 q tile's pairs the same way
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
// boxes (of `box` bytes: 8192 for 64 rows); the backward's (B) reads its
// f32 bias tile transposed through it
__device__ __forceinline__ float sw32(const float* tile, int r, int c, int box = 8192) {
  const char* row = reinterpret_cast<const char*>(tile) + (c >> 5) * box + r * 128;
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
// kFwdStages stages by TMA (in f32 every part of the k and v tiles; with a
// built bias its lanes write the block's key vectors instead); the
// consumers wait for a stage, run S = q k^T (wgmma, K-major as stored: bf16
// q from shared memory; f32 q, split once into three parts, from
// registers), the online softmax in registers, O += P v with P in wgmma's A
// registers (rounded to bf16, or split into three parts) and v read
// [key][d] as an MN-major B, and release the stage. A warpgroup whose rows
// all lie at or past S only writes their lse (+inf), and nothing without
// kLse. With kBuilt (no dropout, no lse) the bias comes from `bb`, not the
// bias map.
template <typename T, typename BiasT, bool kDropout, bool kLse, bool kBuilt>
__global__ void __launch_bounds__(kFwdThreads, FwdOccupancy<T>::kCtas) fwd_kernel(
    const __grid_constant__ FwdMaps maps,
    T* __restrict__ o,        // (B, H, S, D) by strides
    float* __restrict__ lse,  // (B, H, P), or null without kLse
    Strides so, int S, int H, int P, float scale, int seed, float keep, float inv_keep,
    const __grid_constant__ BuiltBias bb) {
  using Smem = FwdSmem<T, BiasT, kBuilt>;
  static_assert(!kBuilt || (!kDropout && !kLse), "a built bias serves inference only");
  constexpr int kQTile = Smem::kQTile;
  constexpr int kOpTile = Smem::kOpTile;
  constexpr int kBias = Tile<BiasT>::kBytes;
  constexpr int kQBytes = Smem::kQ;
  constexpr int kStage = Smem::kStage;
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
    // ---- producer warp: one thread issues every copy; with a built bias
    // the warp's lanes also stage each block's key vectors ----
    const int lane = threadIdx.x - kFwdConsumers;
    if (!kBuilt && lane != 0) return;
    if (lane == 0) {
      tma_prefetch_map(&maps.q);
      tma_prefetch_map(&maps.k);
      tma_prefetch_map(&maps.v);
      if constexpr (!kBuilt) tma_prefetch_map(&maps.bias);
      mbar_expect_tx(&q_bar, n_live * kQTile);
      for (int w = 0; w < n_live; ++w) {
#pragma unroll
        for (int c = 0; c < Tile<T>::kBoxes; ++c) {
          tma_load_4d(smem + w * kQTile + c * 8192, &maps.q, &q_bar, c * Tile<T>::kBoxCols,
                      q0 + 64 * w, h, b);
        }
      }
    }
    const uint32_t stage_tx = 2 * kOpTile + (kBuilt ? 0 : n_live * kBias);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int stage = kb % kFwdStages;
      if (kb >= kFwdStages) mbar_wait(&empty_bar[stage], ((kb / kFwdStages) - 1) & 1);
      uint8_t* st = smem + kQBytes + stage * kStage;
      uint64_t* bar = &full_bar[stage];
      if constexpr (kBuilt) {  // visible to the consumers through lane 0's arrival
        stage_key_vectors(reinterpret_cast<int4*>(st + 2 * kOpTile), bb, b, S, kb * kBK, lane);
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect_tx(bar, stage_tx);
        load_operand<kParts<T>, 64>(st, &maps.k, bar, kb * kBK, 64, kPartTile, h, b);
        load_operand<kParts<T>, 64>(st + kOpTile, &maps.v, bar, kb * kBK, 64, kPartTile, h, b);
        if constexpr (!kBuilt) {
          for (int w = 0; w < n_live; ++w) {
#pragma unroll
            for (int c = 0; c < Tile<BiasT>::kBoxes; ++c) {
              tma_load_2d(st + 2 * kOpTile + w * kBias + c * 8192, &maps.bias, bar,
                          kb * kBK + c * Tile<BiasT>::kBoxCols, plane * P + q0 + 64 * w);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int ct = threadIdx.x % 128;
  // a built bias: this head's expanded tables, built by both warpgroups
  // while the first stages load
  const float* e1 = reinterpret_cast<const float*>(smem + kQBytes + kFwdStages * kStage);
  const int n1 = 2 * bb.max1 + 1, n2 = 2 * bb.max2 + 1;
  if constexpr (kBuilt) {
    build_tables(const_cast<float*>(e1), bb, h, H, threadIdx.x, kFwdConsumers);
    consumers_sync();
  }
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
  // a built bias: max - this thread's rows' pos, x0, y1 (0 past S, as
  // materialize_bias pads them), so that clamp(v_j - v_i, -max, max) + max
  // is max(min(v_j + off, 2 max), 0)
  int off[2][3];
  if constexpr (kBuilt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool real = row[r] < S;
      const size_t at = static_cast<size_t>(b) * S + row[r];
      off[r][0] = bb.max1 - (real ? bb.pos[at] : 0);
      off[r][1] = bb.max2 - (real ? bb.cx[at] : 0);
      off[r][2] = bb.max2 - (real ? bb.cy[at] : 0);
    }
  }

  // accumulator fragment (nt, e) at 4 nt + e: row g + 8 (e >> 1), column
  // 8 nt + 2t + (e & 1), as mma.sync's n-tiles lay it out
  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  // K-major q and k (part) tiles, 8-row atoms 1 KB apart, a 16-wide k step
  // 32 bytes on; MN-major v: the same atoms, a 16-key k step 2 KB on
  const uint64_t q_desc = wgmma_desc(smem + wg * kQTile, 16, 1024);
  mbar_wait(&q_bar, 0);
  // f32: this warp's q rows split into three parts of wgmma's A registers
  // once (A register j of k step ks holds row lr[j % 2], columns 16 ks +
  // 8 (j / 2) + 2t, +1), so the score products read only k from shared
  // memory, and the pre-pass splits only k and v
  uint32_t qa[kParts<T>][4][4];
  if constexpr (kIsF32<T>) {
    const float* q_tile = reinterpret_cast<const float*>(smem + wg * kQTile);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = bias_pair(q_tile, lr[j & 1], 2 * ks + (j >> 1), t);
        split_pair(x.x, x.y, qa[0][ks][j], qa[1][ks][j], qa[2][ks][j]);
      }
    }
  }

  // Each block's O += P v runs while the next block's stage is waited for
  // and its S = q k^T is issued: the P v group is waited for (and its stage
  // released) only before the accumulators are rescaled.
  uint32_t pa[kParts<T>][4][4];  // P of the block in flight, wgmma's A registers
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
    const BiasT* bias_tile = reinterpret_cast<const BiasT*>(st + 2 * kOpTile + wg * kBias);

    // S = q k^T over d
    wgmma_fence();
    if constexpr (kIsF32<T>) {
      wgmma_by_rows_rs<T, kPartTile>(s, qa, wgmma_desc(st, 16, 1024));
    } else {
      wgmma_by_rows<T, kPartTile, kPartTile>(s, q_desc, wgmma_desc(st, 16, 1024));
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

    // scale + bias in f32; keys >= S (in the last block only) masked out.
    // Rows >= S take whatever bias lies there: they are neither stored nor
    // mixed with other rows.
    if constexpr (kBuilt) {
      // each score's bias from the expanded tables at its clamped distances,
      // summed as materialize_bias sums it and rounded once to the bias type
      const int4* keys = reinterpret_cast<const int4*>(st + 2 * kOpTile);
      const float* ex = e1 + n1;
      const float* ey = ex + n2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int4 kv = keys[8 * nt + 2 * t + c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float bv = (e1[__viaddmin_s32_relu(kv.x, off[r][0], n1 - 1)] +
                        ex[__viaddmin_s32_relu(kv.y, off[r][1], n2 - 1)]) +
                       ey[__viaddmin_s32_relu(kv.z, off[r][2], n2 - 1)];
            bv = bv + __int_as_float(kv.w);
            s[4 * nt + 2 * r + c] = s[4 * nt + 2 * r + c] * scale + mmee_round<BiasT>(bv);
          }
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 bv2 = bias_pair(bias_tile, lr[r], nt, t);
          s[4 * nt + 2 * r] = s[4 * nt + 2 * r] * scale + bv2.x;
          s[4 * nt + 2 * r + 1] = s[4 * nt + 2 * r + 1] * scale + bv2.y;
        }
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

    // O += P v: the score accumulators (rounded to bf16, or split into
    // three parts) are wgmma's A registers; v is read [key][d] as a
    // transposed (MN-major) B
    to_a(pa, s);
    wgmma_fence();
    wgmma_by_cols<T, kPartTile, 4>(acc, pa, wgmma_desc(st + kOpTile, 16, 1024));
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pa);

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

// the tensor map of a (B, H, rows, D) operand at its element strides,
// boxes of `box_rows` rows
template <typename T>
int encode_operand(CUtensorMap* map, const T* x, const Strides& st, int rows, int H, int B,
                   int box_rows = 64) {
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * sizeof(T),
                                 static_cast<cuuint64_t>(st.h) * sizeof(T),
                                 static_cast<cuuint64_t>(st.b) * sizeof(T)};
  const cuuint32_t box[4] = {Tile<T>::kBoxCols, static_cast<cuuint32_t>(box_rows), 1, 1};
  return encode_map(map, kMapType<T>, 4, x, dims, strides, box);
}

// the (P, B*H*P) map of a (B, H, P, P) plane tensor (bias, gbias, dbias),
// boxes of `rows` rows
template <typename BiasT>
int encode_plane(CUtensorMap* map, const void* x, int B, int H, int P, int rows = 64) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(B) * H * static_cast<cuuint64_t>(P)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(P) * sizeof(BiasT)};
  const cuuint32_t box[2] = {Tile<BiasT>::kBoxCols, static_cast<cuuint32_t>(rows)};
  return encode_map(map, kMapType<BiasT>, 2, x, dims, strides, box);
}

// the map of one operand's split parts, a contiguous (3 B, H, S, 64) bf16
// tensor (part p of batch b is batch p B + b), boxes of `box_rows` rows
int encode_parts(CUtensorMap* map, const bf16* parts, int B, int H, int S, int box_rows) {
  const Strides cs{static_cast<long long>(H) * S * kD, static_cast<long long>(S) * kD, kD};
  return encode_operand(map, parts, cs, S, H, 3 * B, box_rows);
}

// the forward over a (P rows)-high grid of 128-row tiles; with kBuilt the
// bias from `bb` (its expanded tables after the ring), else from maps.bias
template <typename T, typename BiasT, bool kDropout, bool kLse, bool kBuilt = false>
int launch_fwd_kernel(const FwdMaps& maps, T* o, float* lse, const Strides& so, int B, int S,
                      int H, int P, float scale, int seed, float keep, float inv_keep,
                      cudaStream_t st, const BuiltBias& bb = BuiltBias{}) {
  constexpr int base = FwdSmem<T, BiasT, kBuilt>::kBytes;
  const int smem = base + (kBuilt ? built_tables_bytes(bb.max1, bb.max2) : 0);
  auto kernel = fwd_kernel<T, BiasT, kDropout, kLse, kBuilt>;
  static std::atomic<uint64_t> ready{0};
  const int err = set_smem_limit_once(
      kernel, base + (kBuilt ? built_tables_bytes(kMaxDistance, kMaxDistance) : 0), ready);
  if (err != 0) return err;
  kernel<<<dim3((P + kFwdRows - 1) / kFwdRows, H, B), kFwdThreads, smem, st>>>(
      maps, o, lse, so, S, H, P, scale, seed, keep, inv_keep, bb);
  return static_cast<int>(cudaGetLastError());
}

// the maps of q at its strides, and of k and v: at their strides in bf16;
// in f32 of their split parts `kv_parts`, (2, 3, B, H, S, 64) bf16, which
// the caller's split pre-pass wrote (the kernel reads f32 k and v only so)
template <typename T>
int encode_qkv(FwdMaps* maps, const T* q, const T* k, const T* v, const bf16* kv_parts,
               const Strides& sq, const Strides& sk, const Strides& sv, int B, int S, int H) {
  int err = encode_operand(&maps->q, q, sq, S, H, B);
  if constexpr (kIsF32<T>) {
    if (kv_parts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t n = static_cast<size_t>(3) * B * H * S * kD;  // one operand's parts
    if (err == 0) err = encode_parts(&maps->k, kv_parts, B, H, S, 64);
    if (err == 0) err = encode_parts(&maps->v, kv_parts + n, B, H, S, 64);
  } else {
    if (err == 0) err = encode_operand(&maps->k, k, sk, S, H, B);
    if (err == 0) err = encode_operand(&maps->v, v, sv, S, H, B);
  }
  return err;
}

// with_lse = 0 is flash_attention_packed: no dropout, no lse (lse unused)
template <typename T, typename BiasT>
int launch_fwd(const T* q, const T* k, const T* v, const bf16* kv_parts, const void* bias, T* o,
               float* lse, const Strides& sq, const Strides& sk, const Strides& sv,
               const Strides& so, int B, int S, int H, int P, float scale, int seed, float keep,
               float inv_keep, int dropout, int with_lse, cudaStream_t st) {
  if (!with_lse && dropout) return static_cast<int>(cudaErrorInvalidValue);
  FwdMaps maps;
  int err = encode_qkv<T>(&maps, q, k, v, kv_parts, sq, sk, sv, B, S, H);
  if (err == 0) err = encode_plane<BiasT>(&maps.bias, bias, B, H, P);
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

// fused_bias_attention: the forward without lse or dropout, its bias built
// on chip from `bb` and rounded to T, the operands' type
template <typename T>
int launch_fused(const T* q, const T* k, const T* v, const bf16* kv_parts, T* o,
                 const Strides& sq, const Strides& sk, const Strides& sv, const Strides& so,
                 const BuiltBias& bb, int B, int S, int H, float scale, cudaStream_t st) {
  if (bb.max1 < 1 || bb.max2 < 1 || bb.max1 > kMaxDistance || bb.max2 > kMaxDistance) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdMaps maps;
  memset(&maps, 0, sizeof(maps));  // no bias map
  const int err = encode_qkv<T>(&maps, q, k, v, kv_parts, sq, sk, sv, B, S, H);
  if (err != 0) return err;
  return launch_fwd_kernel<T, T, false, false, true>(maps, o, nullptr, so, B, S, H, S, scale, 0,
                                                     1.0f, 1.0f, st, bb);
}

// calls fn(T{}, BiasT{}) with the operand and bias types the flags name
template <typename Fn>
int by_types(int qkv_is_bf16, int bias_is_bf16, Fn&& fn) {
  if (qkv_is_bf16) return bias_is_bf16 ? fn(bf16{}, bf16{}) : fn(bf16{}, 0.0f);
  return bias_is_bf16 ? fn(0.0f, bf16{}) : fn(0.0f, 0.0f);
}

// calls fn(std::integral_constant<bool, on>{}) for a runtime flag
template <typename Fn>
int by_flag(int on, Fn&& fn) {
  return on ? fn(std::true_type{}) : fn(std::false_type{});
}

// ---------------------------------------------------------------------------
// backward (sm_90a): (A) delta, dbias and dq, (B) dk and dv, each a TMA-fed
// ring with one wgmma consumer warpgroup of 64 rows; bf16 operands as
// stored, f32 operands as their three bf16 parts
// ---------------------------------------------------------------------------

constexpr int kDqStages = 2;    // depth of (A)'s ring
constexpr int kDkvStages = 2;   // depth of (B)'s ring
constexpr int kBwdThreads = 128;  // one warpgroup, which also issues the copies

// The tiling of the backward pair by operand and bias type. A block is 64
// rows (q rows in (A), keys in (B)) by kW columns (keys in (A), queries in
// (B)). bf16: 64 x 64 blocks, and 3 x 4 warps put 3 warps on each SM
// sub-partition, which leaves ptxas 168 registers a thread (5-warp CTAs with
// a producer warp got the same 168 at 2 CTAs per SM). f32 operands with an
// f32 bias: every operand tile holds three parts, so a 64-wide stage would
// fill the SM with one CTA, whose one warpgroup leaves the tensor cores idle
// through its elementwise pass; 32-wide streamed blocks fit two CTAs per SM
// (both under 114 KB, at up to 255 registers), and one CTA's products run
// while the other's elementwise pass does (on an H100: (A) 0.86 -> 0.70 ms,
// (B) 1.37 -> 0.95 ms). The chained (A) keeps 64-wide blocks: with its
// gbias tiles it holds one CTA per SM at either width (128 KB at 32), and
// 64-wide blocks halve its blocks (0.91 ms against 1.04 at 32). f32
// operands with a bf16 bias keep 64-wide blocks, one CTA per SM.
template <typename T, typename BiasT, bool kChained>
struct BwdTiling {
  static constexpr bool kNarrow = kIsF32<T> && kIsF32<BiasT>;
  static constexpr int kW = kNarrow && !kChained ? 32 : 64;  // streamed rows per block
  static constexpr int kCtas = kIsF32<T> ? (kNarrow && !kChained ? 2 : 1) : 3;
  // rows of the operand maps' and the bias maps' boxes: 32 in f32, so a
  // 32-row tile is one box and a 64-row tile two
  static constexpr int kOpBoxRows = kIsF32<T> ? 32 : 64;
  static constexpr int kBiasBoxRows = kNarrow ? 32 : 64;
};

// q, k, v, do as (D, rows, H, B) maps by their strides (f32: of their split
// parts), boxes of kOpBoxRows rows; bias, gbias and dbias as (P, B*H*P)
// maps, boxes of kBiasBoxRows rows (dbias: 16, one warp's rows)
struct BwdMaps {
  CUtensorMap q, k, v, dout, bias, gbias, dbias;
};

// the (batch, head, row) strides of every operand of a backward
struct BwdStrides {
  Strides q, k, v, o, dout, dq, dk, dv;
};

// Both kernels keep everything in dynamic shared memory, the mbarriers
// last, and declare it 1 KB aligned (the 128-byte swizzle's atom): with no
// static shared memory in front of it, two CTAs of the f32 tiling fit an
// SM (each takes 1 KB of system shared memory besides). The kernels check
// the alignment and trap where it does not hold.
//
// (A): q and do (64 rows), then the ring: each stage k and v (kW rows) and
// this CTA's 64 x kW tiles of the bias (and gbias when chained), the latter
// also the staging tile of dbias; then delta of the 64 rows and the
// barriers. bf16: 64 KB plain, three CTAs per SM; 80 KB chained, two. f32
// (f32 bias): 112 KB plain, two; 208 KB chained (64 wide), one
template <typename T, typename BiasT, bool kChained>
struct DqSmem {
  using Tiling = BwdTiling<T, BiasT, kChained>;
  static constexpr int kW = Tiling::kW;
  static constexpr int kPart = 64 * 128;        // a 64-row part tile
  static constexpr int kStreamPart = kW * 128;  // a kW-row part tile
  static constexpr int kTile = kParts<T> * kPart;
  static constexpr int kStreamTile = kParts<T> * kStreamPart;
  static constexpr int kBias = 64 * kW * static_cast<int>(sizeof(BiasT));
  static constexpr int kStage = 2 * kStreamTile + (kChained ? 2 : 1) * kBias;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kDeltaOff = kRing + kDqStages * kStage;  // 64 floats
  static constexpr int kBarOff = kDeltaOff + 64 * 4;  // full, empty, then q's barrier
  static constexpr int kBytes = kBarOff + (2 * kDqStages + 1) * 8;
  static constexpr int kTabOff = (kBytes + 15) & ~15;  // the tables mode's region
};

// the tables mode of (A): the (B, S) bucket vectors (positions, x0, y1),
// the bucket LUTs, and the per-CTA partial sums it writes, (B, H, n_qb,
// nb1 + 2 nb2) f32
struct TablesArgs {
  const int* pos;
  const int* cx;
  const int* cy;
  const int* lut1;
  const int* lut2;
  float* partial;
  int nb1, nb2, max1, max2;
};

// the tables mode's shared memory after DqSmem::kTabOff: a [bin][row] f32
// histogram of the CTA's 64 rows, each warp's key vectors of two blocks
// ([parity][warp][table][key] int), the two LUTs as bytes
constexpr int kHistPitch = 64;
// the table that thread t of a quad walks in phase p of the tables mode's
// walk (2 bits at 2 (4p + t); thread p rests): each thread walks every
// table once, and a phase's three threads three different tables
constexpr uint32_t kWalkTables = 0x6096090u;
__host__ __device__ constexpr int tables_keys_off(int n_bins) { return n_bins * kHistPitch * 4; }
__host__ __device__ constexpr int tables_lut_off(int n_bins, int kw) {
  return tables_keys_off(n_bins) + 2 * 4 * 3 * kw * 4;
}
__host__ __device__ constexpr int tables_bytes(int n_bins, int kw, int max1, int max2) {
  return tables_lut_off(n_bins, kw) + ((max1 + 1 + max2 + 1 + 15) & ~15);
}

// (B): k and v (64 rows), then the ring: each stage q, do (kW rows) and the
// bias tile [query][key] of this CTA's keys; then each stage's kW lse and
// kW delta values, and the barriers. bf16: 65 KB, three CTAs per SM; f32
// (f32 bias): 113 KB, two
template <typename T, typename BiasT>
struct DkvSmem {
  using Tiling = BwdTiling<T, BiasT, false>;
  static constexpr int kW = Tiling::kW;
  static constexpr int kPart = 64 * 128;
  static constexpr int kStreamPart = kW * 128;
  static constexpr int kTile = kParts<T> * kPart;
  static constexpr int kStreamTile = kParts<T> * kStreamPart;
  static constexpr int kBias = kW * 64 * static_cast<int>(sizeof(BiasT));
  static constexpr int kStage = 2 * kStreamTile + kBias;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kRowsOff = kRing + kDkvStages * kStage;  // lse, then delta, per stage
  static constexpr int kBarOff = kRowsOff + kDkvStages * 2 * kW * 4;  // full, empty, k/v's
  static constexpr int kBytes = kBarOff + (2 * kDkvStages + 1) * 8;
};

// the dynamic shared memory of a backward kernel, checked to be 1 KB
// aligned: a misaligned base would break the 128-byte swizzle, so it traps
__device__ __forceinline__ uint8_t* bwd_smem(uint8_t* raw) {
  if (smem_addr(raw) & 1023) __trap();
  return raw;
}

// f32 tiles (bf16 ones go through ldmatrix / stmatrix below): (A) writes
// dbias's pair (row lr, columns 8nt + 2t, +1) at the address bias_pair
// read it from; (B) reads its bias transposed with sw32 (query 8nt + 2t
// (+1), key lr), the 8 g's keys in 8 chunks and 4 words: no bank conflict
__device__ __forceinline__ void put_pair(float* tile, int lr, int nt, int t, float lo, float hi) {
  char* row = reinterpret_cast<char*>(tile) + (nt >> 2) * 8192 + lr * 128;
  const int chunk = (nt & 3) * 2 + (t >> 1);
  *reinterpret_cast<float2*>(row + ((chunk ^ (lr & 7)) << 4) + 8 * (t & 1)) =
      make_float2(lo, hi);
}

// bf16 tiles by ldmatrix / stmatrix, 4 pairs a thread per instruction j
// (0..3): pair m (0..3) is (nt = 2j + m / 2, r = m % 2). In (A)'s pattern
// pair (nt, r) holds row lr[r] = 16 warp + 8r + g, columns 8nt + 2t, +1:
// matrix m's rows are 16 warp + 8r + (0..7), each the 16-byte chunk
// nt ^ (row % 8) of its 128-byte row, so a matrix's 8 rows hit 8 chunks
__device__ __forceinline__ uint32_t pairs_addr(const bf16* tile, int warp, int lane, int j) {
  const int m = lane >> 3, q8 = lane & 7;
  const int row = warp * 16 + 8 * (m & 1) + q8;
  return smem_addr(tile) + row * 128 + (((2 * j + (m >> 1)) ^ q8) << 4);
}
// (B)'s transposed pattern, by ldmatrix.trans: pair (nt, r) holds rows
// (queries) 8nt + 2t, +1 of column (key) 16 warp + 8r + g of a [query][key]
// tile: matrix m's rows are queries 8nt + (0..7), in key chunk 2 warp + r
__device__ __forceinline__ uint32_t pairs_t_addr(const bf16* tile, int warp, int lane, int j) {
  const int m = lane >> 3, q8 = lane & 7;
  const int query = 8 * (2 * j + (m >> 1)) + q8;
  return smem_addr(tile) + query * 128 + (((2 * warp + (m & 1)) ^ q8) << 4);
}
// 64 x 64 wgmma accumulators, times `mul`, stored as T at the rows < S of
// a plane with row stride `rs`; row0 is the warpgroup's first row
template <typename T>
__device__ __forceinline__ void store_acc(T* plane, const float (&acc)[32], int row0, int lr0,
                                          int S, long long rs, float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lr0 + 8 * r;
    if (row >= S) continue;
    T* orow = plane + row * rs;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      store_pair(orow + dt * 8 + 2 * t, acc[4 * dt + 2 * r] * mul, acc[4 * dt + 2 * r + 1] * mul);
    }
  }
}

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

// a rows x cols tile of a (B, H, P, P) plane tensor (boxes of kBoxRows rows
// and 128 bytes of columns; a box column rows x 128 bytes on) (thread 0)
template <typename BiasT, int kBoxRows>
__device__ __forceinline__ void load_plane_tile(uint8_t* dst, const CUtensorMap* map,
                                                uint64_t* bar, int col0, int row0, int rows,
                                                int cols) {
  for (int c = 0; c < cols; c += Tile<BiasT>::kBoxCols) {
    for (int rb = 0; rb < rows; rb += kBoxRows) {
      tma_load_2d(dst + (c / Tile<BiasT>::kBoxCols) * rows * 128 + rb * 128, map, bar, col0 + c,
                  row0 + rb);
    }
  }
}

// (A) One CTA per (64-row q tile over all P rows, head, batch), one
// warpgroup; thread 0 also issues the copies. It loads q and do once and
// keeps a ring of kDqStages stages filled with each kW-key block's k, v,
// bias (and gbias) tiles, refilling a stage as soon as all four warps have
// released it. The warps compute delta = rowsum(do o) for their rows, then
// per block S = q k^T and dP = do v^T (wgmma, all operands K-major as
// stored), p = exp(s scale + bias - lse), ds = p (dp c - delta), zero at
// rows or keys >= S; dbias = ds (+ gbias) overwrites the bias (gbias) tile
// in place, and each warp sends its 16 rows out by a TMA store; dQ += dS k
// with dS in wgmma's A registers (rounded to bf16, or split into three
// parts) and k read [key][d] as an MN-major B. The next block's score
// products queue behind that product, and its mask bits are made while
// both run. kTables is the tables backward's (A'): keys < S only, no dbias,
// each block's ds summed into the CTA's table histogram (see walk below).
template <typename T, typename BiasT, bool kDropout, bool kChained, bool kTables>
__global__ void __launch_bounds__(kBwdThreads, (kTables ? 1 : BwdTiling<T, BiasT, kChained>::kCtas))
    bwd_dq_kernel(const __grid_constant__ BwdMaps maps,
                  const T* __restrict__ dout, const T* __restrict__ o,  // delta's inputs
                  const float* __restrict__ lse,  // (B, H, P)
                  T* __restrict__ dq,             // (B, H, S, D) by strides
                  float* __restrict__ delta,      // (B, H, P), written here
                  Strides sdo, Strides so, Strides sdq, int S, int H, int P, float scale,
                  int seed, float keep, float inv_keep, const TablesArgs tab) {
  static_assert(!(kTables && kChained), "the tables mode reads no gbias");
  using Smem = DqSmem<T, BiasT, kChained>;
  using Tiling = BwdTiling<T, BiasT, kChained>;
  constexpr int kW = Smem::kW;
  constexpr int kN = kW / 2;  // accumulators of a 64 x kW block per thread
  constexpr int kTile = Smem::kTile;
  constexpr int kStreamTile = Smem::kStreamTile;
  constexpr int kBias = Smem::kBias;
  constexpr bool kBf16Bias = !kIsF32<BiasT>;
  extern __shared__ __align__(1024) uint8_t bwd_smem_raw[];
  uint8_t* smem = bwd_smem(bwd_smem_raw);
  float* s_delta = reinterpret_cast<float*>(smem + Smem::kDeltaOff);
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(smem + Smem::kBarOff);
  uint64_t* empty_bar = full_bar + kDqStages;
  uint64_t* q_bar = empty_bar + kDqStages;

  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int plane = b * H + h;
  // every column of the plane, as dbias is P x P; in the tables mode only
  // the keys < S, which carry ds
  const int n_kb = kTables ? (S + kW - 1) / kW : P / kW;
  const int ct = threadIdx.x;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row[2] = {q0 + lr[0], q0 + lr[1]};

  // block kb's tiles into its stage (thread 0). A block with no row or key
  // < S has ds = 0: only its gbias is loaded, and it runs no product
  auto load_block = [&](int kb) {
    uint8_t* st = smem + Smem::kRing + (kb % kDqStages) * Smem::kStage;
    uint64_t* bar = &full_bar[kb % kDqStages];
    const bool live = q0 < S && kb * kW < S;
    mbar_expect_tx(bar, (live ? 2 * kStreamTile + kBias : 0) + (kChained ? kBias : 0));
    if (live) {
      load_operand<kParts<T>, Tiling::kOpBoxRows>(st, &maps.k, bar, kb * kW, kW,
                                                   Smem::kStreamPart, h, b);
      load_operand<kParts<T>, Tiling::kOpBoxRows>(st + kStreamTile, &maps.v, bar, kb * kW, kW,
                                                   Smem::kStreamPart, h, b);
      load_plane_tile<BiasT, Tiling::kBiasBoxRows>(st + 2 * kStreamTile, &maps.bias, bar,
                                                   kb * kW, plane * P + q0, 64, kW);
    }
    if constexpr (kChained) {
      load_plane_tile<BiasT, Tiling::kBiasBoxRows>(st + 2 * kStreamTile + kBias, &maps.gbias,
                                                   bar, kb * kW, plane * P + q0, 64, kW);
    }
  };
  if (ct == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4);  // one arrival per warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
    tma_prefetch_map(&maps.q);
    tma_prefetch_map(&maps.k);
    tma_prefetch_map(&maps.v);
    tma_prefetch_map(&maps.dout);
    tma_prefetch_map(&maps.bias);
    if constexpr (kChained) tma_prefetch_map(&maps.gbias);
    mbar_expect_tx(q_bar, q0 < S ? 2 * kTile : 0);
    if (q0 < S) {
      load_operand<kParts<T>, Tiling::kOpBoxRows>(smem, &maps.q, q_bar, q0, 64, Smem::kPart, h,
                                                   b);
      load_operand<kParts<T>, Tiling::kOpBoxRows>(smem + kTile, &maps.dout, q_bar, q0, 64,
                                                   Smem::kPart, h, b);
    }
    for (int kb = 0; kb < kDqStages && kb < n_kb; ++kb) load_block(kb);
  }

  // delta of the tile's rows, one thread per row (zero past S)
  if (ct < 64) {
    const int i = q0 + ct;
    float acc = 0.0f;
    if (i < S) {
      acc = row_delta(plane_of(dout, sdo, b, h) + i * sdo.s, plane_of(o, so, b, h) + i * so.s);
    }
    s_delta[ct] = acc;
    delta[static_cast<size_t>(plane) * P + i] = acc;
  }
  // the tables mode: a zeroed histogram, the LUTs as bytes, and this
  // thread's two rows' positions, x0 and y1
  const int n_bins = kTables ? tab.nb1 + 2 * tab.nb2 : 0;
  float* s_hist = reinterpret_cast<float*>(smem + Smem::kTabOff);
  int* s_keys = reinterpret_cast<int*>(smem + Smem::kTabOff + tables_keys_off(n_bins));
  uint8_t* s_lut = smem + Smem::kTabOff + tables_lut_off(n_bins, kW);
  int vrow[2][3] = {{0, 0, 0}, {0, 0, 0}};
  if constexpr (kTables) {
    for (int e = ct; e < n_bins * kHistPitch; e += kBwdThreads) s_hist[e] = 0.0f;
    for (int e = ct; e <= tab.max1; e += kBwdThreads) s_lut[e] = static_cast<uint8_t>(tab.lut1[e]);
    for (int e = ct; e <= tab.max2; e += kBwdThreads) {
      s_lut[tab.max1 + 1 + e] = static_cast<uint8_t>(tab.lut2[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] < S) {
        vrow[r][0] = tab.pos[b * S + row[r]];
        vrow[r][1] = tab.cx[b * S + row[r]];
        vrow[r][2] = tab.cy[b * S + row[r]];
      }
    }
  }
  __syncthreads();  // s_delta, the barriers' initialisation (and the tables' region)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < S ? lse[static_cast<size_t>(plane) * P + row[r]] : 0.0f;
    delta_r[r] = s_delta[lr[r]];
  }
  const Dropout drop(seed, plane, keep, inv_keep);

  float dq_acc[32], s[kN], dp[kN];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;
  uint32_t pa[kParts<T>][kW / 16][4];  // dS of the block in flight, wgmma's A registers
  const uint64_t q_desc = wgmma_desc(smem, 16, 1024);
  const uint64_t do_desc = wgmma_desc(smem + kTile, 16, 1024);

  // The tables mode: block kb's f32 ds (ds_prev, the accumulator layout:
  // rows lr[0], lr[1], keys 8nt + 2t + c) goes into the histogram while
  // block kb + 1's score products run. A quad's 4 threads hold the same two
  // rows, each its own 16 keys (8 at kW = 32), so a (row, table) column has
  // four writers: the walk runs in 4 phases, and in phase p thread t != p
  // walks table kWalkTables[p][t] for both its rows, two independent chains
  // of adds, while the three threads of a quad take three different tables.
  // No entry has two writers in a phase, every thread walks 3 tables, and
  // each (bin, row) entry sums in a fixed order. Table T's column of row r
  // is (r + 8T) % 64: the adds of one row of every quad then fall in 24
  // different banks.
  float ds_prev[kN];
  auto walk = [&](int kbp) {
    const int* kv = s_keys + ((kbp & 1) * 4 + warp) * 3 * kW;
    __syncwarp();  // the block's keys, staged by the warp
    for (int phase = 0; phase < 4; ++phase) {
      if (phase != t) {
        const int tbl = (kWalkTables >> (2 * (4 * phase + t))) & 3;
        const int* keys = kv + tbl * kW;
        const uint8_t* lut = s_lut + (tbl == 0 ? 0 : tab.max1 + 1);
        const int half = (tbl == 0 ? tab.nb1 : tab.nb2) / 2;
        const int maxd = tbl == 0 ? tab.max1 : tab.max2;
        const int v0 = tbl == 0 ? vrow[0][0] : tbl == 1 ? vrow[0][1] : vrow[0][2];
        const int v1 = tbl == 0 ? vrow[1][0] : tbl == 1 ? vrow[1][1] : vrow[1][2];
        float* base = s_hist + (tbl == 0 ? 0 : tbl == 1 ? tab.nb1 : tab.nb1 + tab.nb2) * kHistPitch;
        float* col0 = base + ((lr[0] + 8 * tbl) & 63);
        float* col1 = base + ((lr[1] + 8 * tbl) & 63);
        // every bucket first (loads that do not wait for the adds), then
        // the adds in key order, the two rows' side by side
        int b0[kW / 4], b1[kW / 4];
#pragma unroll
        for (int e = 0; e < kW / 8; ++e) {
          const int2 kk = *reinterpret_cast<const int2*>(keys + 8 * e + 2 * t);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = c ? kk.y : kk.x;
            const int rel0 = key - v0, rel1 = key - v1;
            b0[2 * e + c] = (rel0 > 0 ? half : 0) + lut[min(abs(rel0), maxd)];
            b1[2 * e + c] = (rel1 > 0 ? half : 0) + lut[min(abs(rel1), maxd)];
          }
        }
#pragma unroll
        for (int e = 0; e < kW / 4; ++e) {
          float* p0 = col0 + b0[e] * kHistPitch;
          float* p1 = col1 + b1[e] * kHistPitch;
          const float h0 = *p0, h1 = *p1;  // two columns: never one address
          *p0 = h0 + ds_prev[4 * (e >> 1) + (e & 1)];
          *p1 = h1 + ds_prev[4 * (e >> 1) + 2 + (e & 1)];
        }
      }
      __syncwarp();  // the next phase hands the columns to other threads
    }
  };
  mbar_wait(q_bar, 0);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kW;
    const int stage = kb % kDqStages;
    mbar_wait(&full_bar[stage], (kb / kDqStages) & 1);
    uint8_t* st = smem + Smem::kRing + stage * Smem::kStage;
    const uint64_t k_desc = wgmma_desc(st, 16, 1024);
    const uint64_t v_desc = wgmma_desc(st + kStreamTile, 16, 1024);
    const bool live = q0 < S && k0 < S;

    // S = q k^T and dP = do v^T over d, queued behind the previous block's
    // dQ += dS k (whose A registers stay live until the wait)
    if (live) {
      wgmma_fence();
      wgmma_by_rows<T, Smem::kPart, Smem::kStreamPart>(s, q_desc, k_desc);
      wgmma_by_rows<T, Smem::kPart, Smem::kStreamPart>(dp, do_desc, v_desc);
      wgmma_commit();
    }
    uint32_t kept = 0;  // this block's dropout mask, made while the products run
    if constexpr (kDropout) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        kept |= static_cast<uint32_t>(drop.keeps(row[(i >> 1) & 1], col)) << i;
      }
    }
    if constexpr (kTables) {  // while the products run: the previous block's
                              // walk, and this block's keys staged by the warp
      if (kb > 0) walk(kb - 1);
      int* kv = s_keys + ((kb & 1) * 4 + warp) * 3 * kW;
      for (int e = lane; e < 3 * kW; e += 32) {
        const int tbl = e / kW, j = k0 + e % kW;
        const int* vec = tbl == 0 ? tab.pos : tbl == 1 ? tab.cx : tab.cy;
        kv[e] = j < S ? vec[b * S + j] : 0;
      }
    }
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    reg_fence(dq_acc);
    reg_fence(pa);
    if (kb > 0) {
      // the previous block's dQ += dS k and this warp's dbias store out of
      // its stage are done: release the stage, and refill it
      const int prev = (kb - 1) % kDqStages;
      if (!kTables && lane == 0) tma_store_wait_read<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[prev]);
      if (ct == 0 && kb - 1 + kDqStages < n_kb) {
        mbar_wait(&empty_bar[prev], ((kb - 1) / kDqStages) & 1);
        load_block(kb - 1 + kDqStages);
      }
    }

    // ds (zero at rows or keys >= S), and dbias = ds (+ gbias) written over
    // the tile it came from
    const BiasT* bias_tile = reinterpret_cast<const BiasT*>(st + 2 * kStreamTile);
    BiasT* out = reinterpret_cast<BiasT*>(st + 2 * kStreamTile + (kChained ? kBias : 0));
    // the elementwise pass in steps of 4 pairs (bf16: one ldmatrix of the
    // bias, one of gbias and one stmatrix of dbias each), without the bounds
    // tests where the block has every row and key < S
    auto ds_tile = [&](auto all_in) {
      constexpr bool kAllIn = decltype(all_in)::value;
#pragma unroll
      for (int j = 0; j < kW / 16; ++j) {
        uint32_t bias_w[4], gbias_w[4], out_w[4];
        if constexpr (kBf16Bias) {
          ldsm_x4(bias_w, pairs_addr(bias_tile, warp, lane, j));
          if constexpr (kChained) ldsm_x4(gbias_w, pairs_addr(out, warp, lane, j));
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int nt = 2 * j + (m >> 1), r = m & 1;
          float2 bv;
          if constexpr (kBf16Bias) {
            bv = make_float2(pair_half(bias_w[m], 0), pair_half(bias_w[m], 1));
          } else {
            bv = bias_pair(bias_tile, lr[r], nt, t);
          }
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * nt + 2 * r + c;
            ds[c] = 0.0f;
            if (kAllIn || (row[r] < S && k0 + nt * 8 + 2 * t + c < S)) {
              const float p = expf(s[i] * scale + (c ? bv.y : bv.x) - lse_r[r]);
              float dpv = dp[i];
              if constexpr (kDropout) dpv *= (kept >> i) & 1u ? inv_keep : 0.0f;
              ds[c] = p * (dpv - delta_r[r]);
            }
            s[i] = ds[c];
          }
          if constexpr (kChained) {
            if constexpr (kBf16Bias) {
              ds[0] += pair_half(gbias_w[m], 0);
              ds[1] += pair_half(gbias_w[m], 1);
            } else {
              const float2 gv = bias_pair(out, lr[r], nt, t);
              ds[0] += gv.x;
              ds[1] += gv.y;
            }
          }
          if constexpr (kTables) {
            // no dbias: the walk sums ds
          } else if constexpr (kBf16Bias) {
            out_w[m] = pack_bf16x2(ds[0], ds[1]);
          } else {
            put_pair(out, lr[r], nt, t, ds[0], ds[1]);  // the pair this thread read
          }
        }
        // the warp's own rows, read above by the same warp
        if constexpr (kBf16Bias && !kTables) stsm_x4(pairs_addr(out, warp, lane, j), out_w);
      }
    };
    if (q0 + 64 <= S && k0 + kW <= S) {
      ds_tile(std::true_type{});
    } else {
      ds_tile(std::false_type{});
    }
    if constexpr (kTables) {
#pragma unroll
      for (int i = 0; i < kN; ++i) ds_prev[i] = s[i];
    } else {
      // dbias out by TMA, each warp its own 16 rows: no barrier across warps
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kW; c += Tile<BiasT>::kBoxCols) {
          tma_store_2d(&maps.dbias,
                       reinterpret_cast<const uint8_t*>(out) +
                           (c / Tile<BiasT>::kBoxCols) * 8192 + warp * 2048,
                       k0 + c, plane * P + q0 + warp * 16);
        }
        tma_store_commit();
      }
    }

    // dQ += dS k: dS rounded to bf16 or split; k read [key][d] as a
    // transposed B
    if (live) {
      to_a(pa, s);
      wgmma_fence();
      wgmma_by_cols<T, Smem::kStreamPart>(dq_acc, pa, k_desc);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  reg_fence(dq_acc);
  reg_fence(pa);
  if (!kTables && lane == 0) tma_store_wait_all();
  store_acc(plane_of(dq, sdq, b, h), dq_acc, q0, warp * 16 + g, S, sdq.s, scale, t);
  if constexpr (kTables) {
    walk(n_kb - 1);
    __syncthreads();
    // this CTA's partial sums, each bin over its 64 row columns in a fixed
    // order (rotated by the bin, so the threads of a warp read 32 banks)
    float* part = tab.partial + (static_cast<size_t>(plane) * gridDim.x + blockIdx.x) * n_bins;
    for (int bin = ct; bin < n_bins; bin += kBwdThreads) {
      const float* hrow = s_hist + bin * kHistPitch;
      float acc = 0.0f;
      for (int r = 0; r < 64; ++r) acc += hrow[(r + bin) & 63];
      part[bin] = acc;
    }
  }
}

// (B) One CTA per (64-key tile, head, batch), one warpgroup (rows: keys);
// thread 0 also issues the copies. It loads k and v once and keeps a ring
// of kDkvStages stages filled with each kW-query block's q, do and bias
// tile (rows: queries, columns: this CTA's keys), and its lse and delta by
// bulk copies. The warps run S^T = k q^T and dP^T = v do^T (wgmma, K-major
// as stored), p = exp(s scale + bias - lse) with the bias read transposed
// out of the swizzled tile, pd = p c and ds = p (dp c - delta), zero at
// queries or keys >= S (by index: the lse of pad rows may be 0 or +inf),
// then dV += (p c)^T do and dK += dS^T q with both in wgmma's A registers
// (rounded to bf16, or split into three parts) and do, q read [query][d]
// as MN-major B operands.
template <typename T, typename BiasT, bool kDropout>
__global__ void __launch_bounds__(kBwdThreads, (BwdTiling<T, BiasT, false>::kCtas))
    bwd_dkv_kernel(const __grid_constant__ BwdMaps maps,
                   const float* __restrict__ lse,    // (B, H, P)
                   const float* __restrict__ delta,  // (B, H, P)
                   T* __restrict__ dk, T* __restrict__ dv,  // (B, H, S, D) by strides
                   Strides sdk, Strides sdv, int S, int H, int P, float scale, int seed,
                   float keep, float inv_keep) {
  using Smem = DkvSmem<T, BiasT>;
  using Tiling = BwdTiling<T, BiasT, false>;
  constexpr int kW = Smem::kW;
  constexpr int kN = kW / 2;
  constexpr int kTile = Smem::kTile;
  constexpr int kStreamTile = Smem::kStreamTile;
  constexpr bool kBf16Bias = !kIsF32<BiasT>;
  extern __shared__ __align__(1024) uint8_t bwd_smem_raw[];
  uint8_t* smem = bwd_smem(bwd_smem_raw);
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(smem + Smem::kBarOff);
  uint64_t* empty_bar = full_bar + kDkvStages;
  uint64_t* kv_bar = empty_bar + kDkvStages;

  const int j0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int plane = b * H + h;
  const int n_qb = (S + kW - 1) / kW;
  const int ct = threadIdx.x;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int key[2] = {j0 + lr[0], j0 + lr[1]};

  // block qb's tiles into its stage, its lse and delta beside (thread 0)
  auto load_block = [&](int qb) {
    const int i0 = qb * kW;
    const int stage = qb % kDkvStages;
    uint8_t* st = smem + Smem::kRing + stage * Smem::kStage;
    uint8_t* rows = smem + Smem::kRowsOff + stage * 2 * kW * 4;
    uint64_t* bar = &full_bar[stage];
    mbar_expect_tx(bar, Smem::kStage + 2 * kW * 4);
    load_operand<kParts<T>, Tiling::kOpBoxRows>(st, &maps.q, bar, i0, kW, Smem::kStreamPart, h,
                                                 b);
    load_operand<kParts<T>, Tiling::kOpBoxRows>(st + kStreamTile, &maps.dout, bar, i0, kW,
                                                 Smem::kStreamPart, h, b);
    load_plane_tile<BiasT, Tiling::kBiasBoxRows>(st + 2 * kStreamTile, &maps.bias, bar, j0,
                                                 plane * P + i0, kW, 64);
    bulk_load(rows, lse + static_cast<size_t>(plane) * P + i0, kW * 4, bar);
    bulk_load(rows + kW * 4, delta + static_cast<size_t>(plane) * P + i0, kW * 4, bar);
  };
  if (ct == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4);  // one arrival per warp
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
    tma_prefetch_map(&maps.q);
    tma_prefetch_map(&maps.k);
    tma_prefetch_map(&maps.v);
    tma_prefetch_map(&maps.dout);
    tma_prefetch_map(&maps.bias);
    mbar_expect_tx(kv_bar, 2 * kTile);
    load_operand<kParts<T>, Tiling::kOpBoxRows>(smem, &maps.k, kv_bar, j0, 64, Smem::kPart, h,
                                                 b);
    load_operand<kParts<T>, Tiling::kOpBoxRows>(smem + kTile, &maps.v, kv_bar, j0, 64,
                                                 Smem::kPart, h, b);
    for (int qb = 0; qb < kDkvStages && qb < n_qb; ++qb) load_block(qb);
  }
  __syncthreads();  // the barriers' initialisation
  const Dropout drop(seed, plane, keep, inv_keep);

  float dk_acc[32], dv_acc[32], s[kN], dp[kN];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  // the block in flight's (p c)^T and dS^T as wgmma's A registers
  uint32_t pd_a[kParts<T>][kW / 16][4], ds_a[kParts<T>][kW / 16][4];
  const uint64_t k_desc = wgmma_desc(smem, 16, 1024);
  const uint64_t v_desc = wgmma_desc(smem + kTile, 16, 1024);
  mbar_wait(kv_bar, 0);

  for (int qb = 0; qb < n_qb; ++qb) {
    const int i0 = qb * kW;
    const int stage = qb % kDkvStages;
    mbar_wait(&full_bar[stage], (qb / kDkvStages) & 1);
    const uint8_t* st = smem + Smem::kRing + stage * Smem::kStage;
    const uint64_t q_desc = wgmma_desc(st, 16, 1024);
    const uint64_t do_desc = wgmma_desc(st + kStreamTile, 16, 1024);

    // S^T = k q^T and dP^T = v do^T over d, queued behind the previous
    // block's dV/dK products (whose A registers stay live until the wait)
    wgmma_fence();
    wgmma_by_rows<T, Smem::kPart, Smem::kStreamPart>(s, k_desc, q_desc);
    wgmma_by_rows<T, Smem::kPart, Smem::kStreamPart>(dp, v_desc, do_desc);
    wgmma_commit();
    uint32_t kept = 0;  // this block's dropout mask, made while the products run
    if constexpr (kDropout) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int query = i0 + (i >> 2) * 8 + 2 * t + (i & 1);
        kept |= static_cast<uint32_t>(drop.keeps(query, key[(i >> 1) & 1])) << i;
      }
    }
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    reg_fence(pd_a);
    reg_fence(ds_a);
    if (qb > 0) {  // the previous block's dV/dK products are done: release and refill
      const int prev = (qb - 1) % kDkvStages;
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[prev]);
      if (ct == 0 && qb - 1 + kDkvStages < n_qb) {
        mbar_wait(&empty_bar[prev], ((qb - 1) / kDkvStages) & 1);
        load_block(qb - 1 + kDkvStages);
      }
    }

    const BiasT* bias_tile = reinterpret_cast<const BiasT*>(st + 2 * kStreamTile);
    const float* s_lse =
        reinterpret_cast<const float*>(smem + Smem::kRowsOff + stage * 2 * kW * 4);
    const float* s_delta = s_lse + kW;
    uint32_t bias_w[8][2];  // bf16 pairs (queries 8nt + 2t, +1; key lr[r]) by ldmatrix.trans
    if constexpr (kBf16Bias) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t d[4];
        ldsm_x4_trans(d, pairs_t_addr(bias_tile, warp, lane, j));
#pragma unroll
        for (int m = 0; m < 4; ++m) bias_w[2 * j + (m >> 1)][m & 1] = d[m];
      }
    }
    auto p_ds_tile = [&](auto all_in) {  // without bounds tests where all is < S
      constexpr bool kAllIn = decltype(all_in)::value;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int r = (i >> 1) & 1;
        const int ci = (i >> 2) * 8 + 2 * t + (i & 1);  // the query within the block
        float pd = 0.0f, ds = 0.0f;
        if (kAllIn || (i0 + ci < S && key[r] < S)) {
          float bv;
          if constexpr (kBf16Bias) {
            bv = pair_half(bias_w[i >> 2][r], i & 1);
          } else {
            bv = sw32(bias_tile, ci, lr[r], kW * 128);
          }
          const float p = expf(s[i] * scale + bv - s_lse[ci]);
          const float c = kDropout ? ((kept >> i) & 1u ? inv_keep : 0.0f) : 1.0f;
          pd = p * c;
          ds = p * (dp[i] * c - s_delta[ci]);
        }
        s[i] = pd;
        dp[i] = ds;
      }
    };
    if (i0 + kW <= S && j0 + 64 <= S) {
      p_ds_tile(std::true_type{});
    } else {
      p_ds_tile(std::false_type{});
    }
    // dV += (p c)^T do and dK += dS^T q, both rounded to bf16 or split; do
    // and q read [query][d] as transposed B operands
    to_a(pd_a, s);
    to_a(ds_a, dp);
    wgmma_fence();
    wgmma_by_cols<T, Smem::kStreamPart>(dv_acc, pd_a, do_desc);
    wgmma_by_cols<T, Smem::kStreamPart>(dk_acc, ds_a, q_desc);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(dk_acc);
  reg_fence(dv_acc);
  reg_fence(pd_a);
  reg_fence(ds_a);
  store_acc(plane_of(dk, sdk, b, h), dk_acc, j0, warp * 16 + g, S, sdk.s, scale, t);
  store_acc(plane_of(dv, sdv, b, h), dv_acc, j0, warp * 16 + g, S, sdv.s, 1.0f, t);
}

// the split parts of q, k, v and do that the caller's split pre-pass
// (mmee_split_bf16x3) wrote after delta's B * H * P floats in the f32
// backwards' scratch: (4, 3, B, H, S, 64) bf16
inline const bf16* split_parts(const float* delta, int B, int H, int P) {
  return reinterpret_cast<const bf16*>(delta + static_cast<size_t>(B) * H * P);
}

// q, k, v, do (f32: their split parts, from `delta`'s scratch) and the
// bias, and gbias and dbias where given, with the boxes of BwdTiling
template <typename T, typename BiasT>
int encode_bwd_maps(BwdMaps* m, const T* q, const T* k, const T* v, const T* dout,
                    const float* delta, const void* bias, const void* gbias, const void* dbias,
                    const BwdStrides& ss, int B, int S, int H, int P) {
  using Tiling = BwdTiling<T, BiasT, false>;
  int err = 0;
  if constexpr (kIsF32<T>) {
    const bf16* parts = split_parts(delta, B, H, P);
    const size_t n = static_cast<size_t>(3) * B * H * S * kD;  // one operand's parts
    constexpr int kRows = Tiling::kOpBoxRows;
    err = encode_parts(&m->q, parts, B, H, S, kRows);
    if (err == 0) err = encode_parts(&m->k, parts + n, B, H, S, kRows);
    if (err == 0) err = encode_parts(&m->v, parts + 2 * n, B, H, S, kRows);
    if (err == 0) err = encode_parts(&m->dout, parts + 3 * n, B, H, S, kRows);
  } else {
    err = encode_operand(&m->q, q, ss.q, S, H, B);
    if (err == 0) err = encode_operand(&m->k, k, ss.k, S, H, B);
    if (err == 0) err = encode_operand(&m->v, v, ss.v, S, H, B);
    if (err == 0) err = encode_operand(&m->dout, dout, ss.dout, S, H, B);
  }
  constexpr int kBiasRows = Tiling::kBiasBoxRows;
  if (err == 0) err = encode_plane<BiasT>(&m->bias, bias, B, H, P, kBiasRows);
  if (err == 0 && gbias != nullptr) {
    err = encode_plane<BiasT>(&m->gbias, gbias, B, H, P, kBiasRows);
  }
  if (err == 0 && dbias != nullptr) err = encode_plane<BiasT>(&m->dbias, dbias, B, H, P, 16);
  return err;
}

// (B) alone: the dk/dv kernel that the tables backward shares
template <typename T, typename BiasT>
int launch_bwd_dkv(const BwdMaps& maps, const float* lse, const float* delta, T* dk, T* dv,
                   const BwdStrides& ss, int B, int S, int H, int P, float scale, int seed,
                   float keep, float inv_keep, int dropout, cudaStream_t st) {
  return by_flag(dropout, [&](auto drop) {
    auto kernel = bwd_dkv_kernel<T, BiasT, decltype(drop)::value>;
    constexpr int smem = DkvSmem<T, BiasT>::kBytes;
    static std::atomic<uint64_t> ready{0};
    const int err = set_smem_limit_once(kernel, smem, ready);
    if (err != 0) return err;
    kernel<<<dim3((S + kBK - 1) / kBK, H, B), kBwdThreads, smem, st>>>(
        maps, lse, delta, dk, dv, ss.dk, ss.dv, S, H, P, scale, seed, keep, inv_keep);
    return static_cast<int>(cudaGetLastError());
  });
}

// the backward pair, (A) then (B); gbias null unless chained; with f32
// operands `delta` is followed by the split parts of q, k, v and do
template <typename T, typename BiasT>
int launch_bwd_pair(const T* q, const T* k, const T* v, const void* bias, const T* dout,
                    const T* o, const float* lse, const void* gbias, T* dq, T* dk, T* dv,
                    void* dbias, float* delta, const BwdStrides& ss, int B, int S, int H, int P,
                    float scale, int seed, float keep, float inv_keep, int dropout,
                    cudaStream_t st) {
  BwdMaps maps;
  int err = encode_bwd_maps<T, BiasT>(&maps, q, k, v, dout, delta, bias, gbias, dbias, ss, B,
                                      S, H, P);
  if (err != 0) return err;
  err = by_flag(dropout, [&](auto drop) {
    return by_flag(gbias != nullptr, [&](auto chained) {
      constexpr bool kChained = decltype(chained)::value;
      auto kernel = bwd_dq_kernel<T, BiasT, decltype(drop)::value, kChained, false>;
      constexpr int smem = DqSmem<T, BiasT, kChained>::kBytes;
      static std::atomic<uint64_t> ready{0};
      const int e = set_smem_limit_once(kernel, smem, ready);
      if (e != 0) return e;
      kernel<<<dim3(P / kBQ, H, B), kBwdThreads, smem, st>>>(
          maps, dout, o, lse, dq, delta, ss.dout, ss.o, ss.dq, S, H, P, scale, seed, keep,
          inv_keep, TablesArgs{});
      return static_cast<int>(cudaGetLastError());
    });
  });
  if (err != 0) return err;
  return launch_bwd_dkv<T, BiasT>(maps, lse, delta, dk, dv, ss, B, S, H, P, scale, seed, keep,
                                  inv_keep, dropout, st);
}

// ---------------------------------------------------------------------------
// the split pre-pass of the f32 forwards (k, v) and backwards (q, k, v, do)
// ---------------------------------------------------------------------------

// up to four f32 (B, H, S, 64) operands and their element strides
struct SplitSrc {
  const float* x[4];
  Strides st[4];
};

// One thread per 8 values of a row of operand blockIdx.y: x into three bf16
// tensors hi, mid, lo (split_pair) of `parts`, (operand, part, B, H, S, 64)
// contiguous, 16-byte loads and stores. Bound by bytes: 4 read and 6
// written per value, 0.11 ms for q, k, v and do at B = 16, H = 12, S = 768
// on an H100 (3.35 TB/s), 0.056 ms for k and v
__global__ void __launch_bounds__(256) split_bf16x3_kernel(const __grid_constant__ SplitSrc src,
                                                           bf16* __restrict__ parts, int B,
                                                           int H, int S) {
  const long long rows = static_cast<long long>(B) * H * S;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * (kD / 8)) return;
  const float* x = nullptr;
  Strides st{0, 0, 0};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // constant indices: no local copy of src
    if (j == static_cast<int>(blockIdx.y)) {
      x = src.x[j];
      st = src.st[j];
    }
  }
  const long long row = i / (kD / 8);
  const int c = static_cast<int>(i % (kD / 8)) * 8;
  const int s = static_cast<int>(row % S);
  const int bh = static_cast<int>(row / S);
  const float* p = x + (bh / H) * st.b + (bh % H) * st.h + s * st.s + c;
  const float4 v0 = *reinterpret_cast<const float4*>(p);
  const float4 v1 = *reinterpret_cast<const float4*>(p + 4);
  uint4 hi, mid, lo;
  split_pair(v0.x, v0.y, hi.x, mid.x, lo.x);
  split_pair(v0.z, v0.w, hi.y, mid.y, lo.y);
  split_pair(v1.x, v1.y, hi.z, mid.z, lo.z);
  split_pair(v1.z, v1.w, hi.w, mid.w, lo.w);
  const size_t n = static_cast<size_t>(rows) * kD;  // one part
  bf16* out = parts + blockIdx.y * 3 * n + row * kD + c;
  *reinterpret_cast<uint4*>(out) = hi;
  *reinterpret_cast<uint4*>(out + n) = mid;
  *reinterpret_cast<uint4*>(out + 2 * n) = lo;
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
  const Strides ps = packed_strides(S, H);
  const BwdStrides ss{ps, ps, ps, ps, ps, ps, ps, ps};
  return launch_bwd_pair<T, BiasT>(q, k, v, bias, dout, o, lse, gbias, dq, dk, dv, dbias, delta,
                                   ss, B, S, H, P, scale, seed, keep, inv_keep, dropout, st);
}

template <typename T, typename BiasT>
int launch_bwd_tables(const T* q, const T* k, const T* v, const void* bias, const T* dout,
                      const T* o, const float* lse, const int* pos, const int* cx,
                      const int* cy, const int* lut1, const int* lut2, T* dq, T* dk, T* dv,
                      float* delta, float* partial, float* tables, int B, int S, int H, int P,
                      float scale, int seed, float keep, float inv_keep, int dropout, int nb1,
                      int nb2, int max1, int max2, cudaStream_t st) {
  const Strides ps = packed_strides(S, H);
  const BwdStrides ss{ps, ps, ps, ps, ps, ps, ps, ps};
  BwdMaps maps;
  int err = encode_bwd_maps<T, BiasT>(&maps, q, k, v, dout, delta, bias, nullptr, nullptr, ss, B,
                                      S, H, P);
  if (err != 0) return err;
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int n_bins = nb1 + 2 * nb2;
  const TablesArgs tab{pos, cx, cy, lut1, lut2, partial, nb1, nb2, max1, max2};
  // (A'): (A)'s tables mode over the q blocks with a row < S
  err = by_flag(dropout, [&](auto drop) {
    using Smem = DqSmem<T, BiasT, false>;
    auto kernel = bwd_dq_kernel<T, BiasT, decltype(drop)::value, false, true>;
    const int smem = Smem::kTabOff + tables_bytes(n_bins, Smem::kW, max1, max2);
    const int e = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (e != 0) return e;
    kernel<<<dim3(n_qb, H, B), kBwdThreads, smem, st>>>(maps, dout, o, lse, dq, delta, ps, ps, ps,
                                                        S, H, P, scale, seed, keep, inv_keep,
                                                        tab);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  // (B): the backward pair's dk/dv kernel
  err = launch_bwd_dkv<T, BiasT>(maps, lse, delta, dk, dv, ss, B, S, H, P, scale, seed, keep,
                                 inv_keep, dropout, st);
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
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3),
                sdo = strides_at(strides, 4), sdq = strides_at(strides, 5),
                sdk = strides_at(strides, 6), sdv = strides_at(strides, 7);
  const BwdStrides ss{sq, sk, sv, so, sdo, sdq, sdk, sdv};
  return launch_bwd_pair<T, BiasT>(q, k, v, bias, dout, o, lse, nullptr, dq, dk, dv, dbias,
                                   delta, ss, B, S, H, P, scale, seed, keep, inv_keep, dropout,
                                   st);
}

}  // namespace

// Every entry takes its operands (q, k, v, o, do and the gradients) as
// bf16 (qkv_is_bf16 = 1) or f32 (0), and the bias (and gbias, dbias) as
// bf16 (bias_is_bf16 = 1) or f32 (0). With f32 operands the kernels read
// k and v (and in the backwards q and do) only as their split parts, which
// the caller writes with mmee_split_bf16x3 before the call: every forward
// takes those of k and v as `kv_parts`, (2, 3, B, H, S, 64) bf16 (null with
// bf16 operands), and splits q itself; every backward takes `delta`,
// scratch of B * H * P floats, followed with f32 operands by the parts of
// q, k, v and do, (4, 3, B, H, S, 64) bf16.

// split_bf16x3: n (1 to 4) f32 (B, H, S, 64) operands x0.., at the element
// strides `strides` gives (a host array of 3n: batch, head, row; 16-byte
// aligned rows), each into its three bf16 parts hi, mid, lo with x = hi +
// mid + lo exactly; `parts` is (n, 3, B, H, S, 64), contiguous
extern "C" int mmee_split_bf16x3(const void* x0, const void* x1, const void* x2,
                                 const void* x3, int n, const long long* strides, void* parts,
                                 int B, int H, int S, void* stream) {
  if (n < 1 || n > 4) return static_cast<int>(cudaErrorInvalidValue);
  const void* xs[4] = {x0, x1, x2, x3};
  SplitSrc src;
  for (int i = 0; i < 4; ++i) {
    src.x[i] = static_cast<const float*>(xs[i]);
    src.st[i] = i < n ? strides_at(strides, i) : Strides{0, 0, 0};
  }
  const long long threads = static_cast<long long>(B) * H * S * (kD / 8);
  split_bf16x3_kernel<<<dim3(static_cast<unsigned>((threads + 255) / 256), n), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(src, static_cast<bf16*>(parts), B,
                                                             H, S);
  return static_cast<int>(cudaGetLastError());
}

// flash_attention_packed: o (B, S, H*D), no lse, no dropout; P a multiple
// of 64
extern "C" int mmee_flash_attention_packed(const void* q, const void* k, const void* v,
                                           const void* bias, int bias_is_bf16,
                                           int qkv_is_bf16, const void* kv_parts, void* o,
                                           int B, int S, int H, int P, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ps = packed_strides(S, H);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_fwd<T, decltype(bt)>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const bf16*>(kv_parts), bias, static_cast<T*>(o), nullptr, ps, ps, ps, ps,
        B, S, H, P, scale, 0, 1.0f, 1.0f, 0, 0, st);
  });
}

extern "C" int mmee_flash_attention_packed_train_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_is_bf16, int qkv_is_bf16, const void* kv_parts, void* o, void* lse, int B, int S,
    int H, int P, float scale, int seed, float keep, float inv_keep, int dropout,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ps = packed_strides(S, H);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_fwd<T, decltype(bt)>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const bf16*>(kv_parts), bias, static_cast<T*>(o), static_cast<float*>(lse),
        ps, ps, ps, ps, B, S, H, P, scale, seed, keep, inv_keep, dropout, 1, st);
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

// fused_bias_attention: o = softmax(q k^T scale + bias) v, each score's
// bias built on chip from the (B, S) int32 vectors pos, cx, cy and mask and
// the f32 tables t1 (nb1, H), tx and ty (nb2, H), with the attention scale
// folded in, and rounded once to the operands' type, as materialize_bias
// rounds it; keys j >= S do not exist. q, k, v and o are (B, H, S, 64) at
// the strides `strides` gives (a host array of 12: batch, head, row of q,
// k, v, o); f32 k and v are read from kv_parts only, as in
// mmee_flash_attention_packed. lut1 and lut2 are bucket_lut's tables of
// max1 + 1 and max2 + 1 entries; max1, max2 <= 1024.
extern "C" int mmee_fused_bias_attention(
    const void* q, const void* k, const void* v, int qkv_is_bf16, const void* kv_parts, void* o,
    const long long* strides, const void* pos, const void* cx, const void* cy, const void* mask,
    const void* t1, const void* tx, const void* ty, const void* lut1, const void* lut2, int B,
    int S, int H, int nb1, int nb2, int max1, int max2, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  const BuiltBias bb{static_cast<const int*>(pos),   static_cast<const int*>(cx),
                     static_cast<const int*>(cy),    static_cast<const int*>(mask),
                     static_cast<const float*>(t1),  static_cast<const float*>(tx),
                     static_cast<const float*>(ty),  static_cast<const int*>(lut1),
                     static_cast<const int*>(lut2),  nb1,
                     nb2,                            max1,
                     max2};
  const bf16* parts = static_cast<const bf16*>(kv_parts);
  if (qkv_is_bf16) {
    return launch_fused<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), parts, static_cast<bf16*>(o), sq, sk,
                              sv, so, bb, B, S, H, scale, st);
  }
  return launch_fused<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), parts, static_cast<float*>(o), sq, sk,
                             sv, so, bb, B, S, H, scale, st);
}

// ---------------------------------------------------------------------------
// head form: the forward and the plain backward on (B, H, S, D) operands
// given by their strides
// ---------------------------------------------------------------------------

// o (in the layout `strides` gives it) and lse (B, H, P) f32, +inf past S.
// `strides` is a host array of 12: (batch, head, row) of q, k, v, o.
extern "C" int mmee_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, int bias_is_bf16,
    int qkv_is_bf16, const void* kv_parts, void* o, void* lse, const long long* strides, int B,
    int S, int H, int P, float scale, int seed, float keep, float inv_keep, int dropout,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  return by_types(qkv_is_bf16, bias_is_bf16, [&](auto t, auto bt) {
    using T = decltype(t);
    return launch_fwd<T, decltype(bt)>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const bf16*>(kv_parts), bias, static_cast<T*>(o), static_cast<float*>(lse),
        sq, sk, sv, so, B, S, H, P, scale, seed, keep, inv_keep, dropout, 1, st);
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
