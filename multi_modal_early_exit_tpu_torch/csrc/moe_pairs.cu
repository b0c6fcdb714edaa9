// moe_pairs: the expert layer's work on either side of its down product, one
// pass each (models/moonlight/modeling.py::experts_apply and mlp_apply).
//
// Replaces no TPU kernel: the JAX package runs no expert layer. Composed of
// PyTorch ops, the routed experts' SwiGLU is four passes over the (pairs,
// 2F) gate-up product's strided halves (SiLU, the product with up, the
// routing weight's gather and cast, its product), and the way back is an
// index_copy_ of the (pairs, H) down product into pair order, an f32 sum over
// each token's k rows and a cast. Both sides do a few operations a byte, far
// below the card's ridge point, so their bytes bound them:
//
// swiglu_weigh_kernel: act[i] = silu(gate[i]) * up[i] * w, w =
//   weights[order[i]] (routed) or 1 (the shared experts, layer 0's MLP), in
//   f32 and rounded once to bf16; the routed call also writes
//   the inverse permutation inv[order[i]] = i that combine_pairs reads. Reads
//   each pair row of gate_up once and writes its act row once: at 98,304
//   pairs of F = 1,408 in bf16, 830 MB, 0.248 ms at 3.35 TB/s.
// combine_pairs_kernel: out[t] = sum_{j<k} pairs[inv[t k + j]] in f32, j in
//   order, rounded once. Reads each pair row once (a 16-byte vector of it a
//   thread, so a row is a contiguous run) and writes each token row once: at
//   98,304 pairs of H = 2,048 in bf16, 470 MB, 0.140 ms. No atomics: each
//   output vector is one thread's, so the result is the same on every run.
//
// Design: one thread a 16-byte vector (8 bf16) of one output row, threads of
// a block on neighbouring vectors, one vector a thread and as many blocks as
// the vectors need (millions of 16-byte loads in flight fill the card's
// memory pipe). The row of a thread's vector comes from a 32-bit division of
// its index by the vectors a row; the wrappers keep the index below 2^31.
// Operands bf16, as the configuration serves them (the grouped products take
// bf16 alone); a row's width a multiple of 8 (every width of Moonlight's
// configuration: 1,408, 2,816, 11,264 and 2,048; Kimi-Linear's 1,024, 2,048
// and 2,304).
//
// An expert layer that holds a share of the experts (Kimi-Linear's, expert
// parallelism) sorts the pairs of its own experts first and passes `held`,
// the count of those pairs, on the card: swiglu_weigh then leaves the act
// rows from `held` on unwritten (no product reads them) and combine_pairs
// counts a pair whose sorted row is `held` or later as zero. A null `held`
// (every expert here) is the plain call.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;  // ops/moe_pairs.py's MAX_K: pairs a token

constexpr int kE = 8;  // bf16 elements in a 16-byte vector

struct alignas(16) Vec {
  __nv_bfloat16 v[kE];
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads) swiglu_weigh_kernel(
    const Vec* __restrict__ gate_up,    // (rows, 2 width), gate columns first
    const float* __restrict__ weights,  // (rows,) in pair order before the sort
    const int64_t* __restrict__ order,  // (rows,): the sorted row i is pair order[i]
    Vec* __restrict__ act,              // (rows, width)
    int32_t* __restrict__ inv,          // (rows,): inv[order[i]] = i
    const int32_t* __restrict__ held,   // null, or the sorted rows of held experts
    unsigned rows, unsigned vecs) {     // vecs: 16-byte vectors in a row of act
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= rows * vecs) return;
  const unsigned row = idx / vecs, v = idx - row * vecs;
  float w = 1.0f;
  if (kWeighted) {
    const int64_t pair = order[row];
    if (v == 0) inv[pair] = static_cast<int32_t>(row);
    if (held != nullptr && row >= static_cast<unsigned>(*held)) return;
    w = weights[pair];
  }
  const Vec* in = gate_up + static_cast<size_t>(row) * 2 * vecs;
  const Vec g = in[v], u = in[vecs + v];
  Vec o;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const float s = __fmul_rn(silu(__bfloat162float(g.v[j])), __bfloat162float(u.v[j]));
    o.v[j] = __float2bfloat16_rn(kWeighted ? __fmul_rn(s, w) : s);
  }
  act[static_cast<size_t>(row) * vecs + v] = o;
}

__global__ void __launch_bounds__(kThreads) combine_pairs_kernel(
    const Vec* __restrict__ pairs,     // (tokens k, width), sorted order
    const int32_t* __restrict__ inv,   // (tokens k,): pair p is sorted row inv[p]
    const int32_t* __restrict__ held,  // null, or the sorted rows of held experts
    Vec* __restrict__ out,             // (tokens, width)
    unsigned tokens, int k, unsigned vecs) {
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= tokens * vecs) return;
  const unsigned t = idx / vecs, v = idx - t * vecs;
  const int32_t end = held != nullptr ? *held : 0x7fffffff;
  // every load first, then the sum in pair order; an absent expert's pair
  // is a row of zeros
  Vec x[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const int32_t r = inv[static_cast<size_t>(t) * k + j];
      if (r < end) {
        x[j] = pairs[static_cast<size_t>(r) * vecs + v];
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) x[j].v[e] = __float2bfloat16_rn(0.0f);
      }
    }
  }
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = __bfloat162float(x[0].v[e]);
#pragma unroll
  for (int j = 1; j < kMaxK; ++j) {
    if (j < k) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = __fadd_rn(acc[e], __bfloat162float(x[j].v[e]));
    }
  }
  Vec o;
#pragma unroll
  for (int e = 0; e < kE; ++e) o.v[e] = __float2bfloat16_rn(acc[e]);
  out[idx] = o;
}

inline unsigned blocks_for(unsigned n) { return (n + kThreads - 1) / kThreads; }

bool bad_width(int width) { return width <= 0 || width % kE != 0; }

}  // namespace

// gate_up (rows, 2 width) and act (rows, width) bf16, row-major, 16-byte
// aligned; weights (f32) and order (int64), (rows,) each, both null for an
// unweighted call, else inv (int32, rows) is written too; held (one int32 on
// the card) null, or with weights the count of leading rows to compute;
// rows * width / 8 below 2^31
extern "C" int mmee_swiglu_weigh(const void* gate_up, const void* weights, const void* order,
                                 void* act, void* inv, const void* held, int rows, int width,
                                 void* stream) {
  if (rows <= 0) return 0;
  if (bad_width(width) || (weights == nullptr) != (order == nullptr) ||
      (held != nullptr && weights == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned vecs = width / kE, blocks = blocks_for(rows * vecs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vec* in = static_cast<const Vec*>(gate_up);
  if (weights != nullptr) {
    swiglu_weigh_kernel<true><<<blocks, kThreads, 0, s>>>(
        in, static_cast<const float*>(weights), static_cast<const int64_t*>(order),
        static_cast<Vec*>(act), static_cast<int32_t*>(inv), static_cast<const int32_t*>(held),
        rows, vecs);
  } else {
    swiglu_weigh_kernel<false><<<blocks, kThreads, 0, s>>>(
        in, nullptr, nullptr, static_cast<Vec*>(act), nullptr, nullptr, rows, vecs);
  }
  return static_cast<int>(cudaGetLastError());
}

// pairs (tokens k, width) and out (tokens, width) bf16, row-major, 16-byte
// aligned; inv (int32, tokens k), a permutation; held (one int32 on the
// card) null, or the count of leading sorted rows that hold products; 1 <= k
// <= 8; tokens * width / 8 below 2^31
extern "C" int mmee_combine_pairs(const void* pairs, const void* inv, const void* held,
                                  void* out, int tokens, int k, int width, void* stream) {
  if (tokens <= 0) return 0;
  if (bad_width(width) || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned vecs = width / kE;
  combine_pairs_kernel<<<blocks_for(tokens * vecs), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(pairs), static_cast<const int32_t*>(inv),
      static_cast<const int32_t*>(held), static_cast<Vec*>(out), tokens, k, vecs);
  return static_cast<int>(cudaGetLastError());
}
