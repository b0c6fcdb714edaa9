// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tile loads and stores, bulk copies, ldmatrix / stmatrix, wgmma with its
// shared-memory descriptors, and
// the host-side encoding of TMA tensor maps (cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point, so no library links -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <string.h>

#include <atomic>
#include <mutex>

#include "common.cuh"

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the other threads and to the
// TMA unit (the async proxy); followed by __syncthreads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a wait
// that lasts about ten seconds (a copy that never lands) traps, so a fault
// surfaces as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a box of a tensor into shared memory and the bytes
// complete on an mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// a contiguous run of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// TMA stores: a box of shared memory out to a tensor. The threads that
// wrote the box fence it for the async proxy (fence_async_smem) and sync
// before one thread issues the store; that thread commits it and, before
// the box is written again, waits until the store has read it
// (tma_store_wait_read), and before it exits until every store is done.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most kPending committed stores may still be reading shared memory
template <int kPending>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma on 128-byte-swizzled tiles (rows of 64 bf16, 8-row atoms of 1 KB,
// tile bases 1 KB aligned, as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B)
// ---------------------------------------------------------------------------

// matrix descriptor: start address, leading and stride byte offsets (in
// 16-byte units) and the 128-byte swizzle
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// the asynchronous products (and from reusing them before the wait)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>  // M sets of accumulators (one per 64 columns of the head dim)
__device__ __forceinline__ void reg_fence(float (&d)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) reg_fence(d[m]);
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}
template <int N, int K>  // N sets of A fragments of K k steps (the parts of split operands)
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][K][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[n][k][j])::"memory");
    }
  }
}

#define MMEE_WGMMA_D32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define MMEE_WGMMA_REGS32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, K-major in shared memory) times
// B (16 x 64, K-major in shared memory: stored [n][k])
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMEE_WGMMA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MMEE_WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#define MMEE_WGMMA_D16(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])

// d (64 x 32 f32) (+)= A (64 x 16, K-major in shared memory) times
// B (16 x 32, K-major in shared memory: stored [n][k])
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MMEE_WGMMA_D16(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// the same at n = 64 and n = 32, by the accumulators' size
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_m64n64k16_ss(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_m64n32k16_ss(d, a, b, acc);
}

// d (64 x 64 f32) (+)= A (64 x 16 bf16 in registers, the mma.sync A
// fragment layout per warp) times B (16 x 64, K-major in shared memory:
// stored [n][k])
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMEE_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MMEE_WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32 f32) (+)= A (64 x 16 bf16 in registers, the mma.sync A
// fragment layout per warp) times B (16 x 32, K-major in shared memory:
// stored [n][k])
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : MMEE_WGMMA_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
// the same at n = 64 and n = 32, by the accumulators' size
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  wgmma_m64n64k16_rs(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  wgmma_m64n32k16_rs(d, a, b, acc);
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, the mma.sync A fragment
// layout per warp) times B (16 x 64, MN-major in shared memory: stored [k][n])
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMEE_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MMEE_WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// ---------------------------------------------------------------------------
// ldmatrix / stmatrix: four 8 x 8 b16 matrices per instruction, lane l
// giving the address of row l % 8 of matrix l / 8; thread (g = lane / 4,
// t = lane % 4) holds, per matrix, row g's columns 2t, 2t + 1 (the mma
// accumulator pattern), or with .trans rows 2t, 2t + 1 of column g
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&d)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3])
               : "memory");
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

// launchers return this plus the driver's CUresult when an encode fails;
// mmee_error_string names it
constexpr int kTensorMapError = MMEE_TENSOR_MAP_ERROR;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// what a map encodes: equal keys give equal maps, whatever the memory holds
struct MapKey {
  const void* base;
  int type, rank;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
};

// a tiled, 128-byte-swizzled map of `rank` (<= 4) dims (innermost first,
// strides in bytes of dims 1..rank-1), boxes of `box`, zeros outside the
// tensor. Maps are cached by what they encode (the caching allocator hands
// the training step the same buffers every step): an encode costs the host
// more than the rest of a launch.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  MapKey key;
  memset(&key, 0, sizeof(key));  // padding too: keys compare bytewise
  key.base = base;
  key.type = static_cast<int>(type);
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  constexpr int kSlots = 256;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static bool filled[kSlots];
  static std::mutex lock;
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(key); ++i) h = (h ^ bytes[i]) * 1099511628211ull;
  const int slot = static_cast<int>(h % kSlots);
  std::lock_guard<std::mutex> guard(lock);
  if (filled[slot] && memcmp(&keys[slot], &key, sizeof(key)) == 0) {
    *map = maps[slot];
    return 0;
  }
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  // the driver call needs a current context on this thread; a thread that
  // has made no runtime call yet (autograd's backward thread, before any
  // launch) has none: cudaSetDevice makes the device's primary context current
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) {
    return kTensorMapError + static_cast<int>(CUDA_ERROR_INVALID_CONTEXT);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(r);
  keys[slot] = key;
  maps[slot] = *map;
  filled[slot] = true;
  return 0;
}

// sets a kernel's dynamic shared-memory limit once per device (a driver
// call per launch costs the host microseconds); `ready` is the kernel's own
// mask of devices done
template <typename Kernel>
int set_smem_limit_once(Kernel kernel, int bytes, std::atomic<uint64_t>& ready) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;  // past 64 devices: every launch
  if (bit != 0 && (ready.load() & bit)) return 0;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err == 0) ready.fetch_or(bit);
  return err;
}
