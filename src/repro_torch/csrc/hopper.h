// Hopper (sm_90a) building blocks of the tensor-core attention kernels,
// shared by the flash forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): mbarriers, TMA loads, wgmma descriptors and
// instructions, the warpgroup split, the accumulator-to-A-fragment
// repacking, and the host side's tensor-map encoder.  The f32 routes'
// 3xTF32 blocks (mma.sync, ldmatrix, cp.async) come from tf32.h.
//
// Tiles live in shared memory as column chunks of (rows x 128 bytes): 64
// head-dim columns of a 2-byte type a row, written by TMA with the
// 128-byte swizzle and read by wgmma through descriptors of the same
// layout.  Every tile base is 1024-aligned (the swizzle atom: 8 rows of
// 128 bytes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

#include "tf32.h"  // kLog2e, and the f32 routes' 3xTF32 blocks

namespace {

constexpr int kChunk = 64;  // head-dim columns per 128-byte swizzled row
constexpr int kRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A (head-dim chunk, head, token, batch) box of a 4-d tensor map into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout
// SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Descriptor of 16 columns (one k-step) of a K-major operand: rows
// [0, 64) of a chunked tile whose chunks hold `chunk_rows` rows, at
// head-dim column 16 * kk (chunk kk / 4, 32 bytes into its rows).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int chunk_rows,
                                                int kk) {
  return sw128_desc(tile + (kk / 4) * chunk_rows * kRowBytes + (kk % 4) * 32, 16,
                    1024);
}

// Descriptor of an MN-major ("transposed") B operand of 64-row chunks:
// K rows [16 kk, 16 kk + 16), N columns [64 j, 64 j + 64); 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk, int j) {
  return sw128_desc(tile + j * 64 * kRowBytes + kk * 16 * kRowBytes, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FA_D32                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define FA_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), both K-major in shared
// memory; `accumulate` 0 overwrites d.
#define FA_WGMMA_SS(TY)                                                        \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_R32       \
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                        \
      : FA_D32                                                                 \
      : "l"(da), "l"(db), "r"(accumulate))
// d (64 x 64, f32) += A (64 x 16) . B (16 x 64), A K-major and B MN-major
// (the "transposed" flag) in shared memory.
#define FA_WGMMA_SS_TB(TY)                                                     \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_R32       \
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"                                        \
      : FA_D32                                                                 \
      : "l"(da), "l"(db), "r"(1))
// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64), B MN-major in
// shared memory (the "transposed" flag).
#define FA_WGMMA_RS(TY)                                                        \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_R32       \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
      : FA_D32                                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16>(float (&d)[32],
                                                        uint64_t da, uint64_t db,
                                                        int accumulate) {
  FA_WGMMA_SS("bf16");
}
template <>
__device__ __forceinline__ void wgmma_ss<__half>(float (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  FA_WGMMA_SS("f16");
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da,
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss_tb<__nv_bfloat16>(float (&d)[32],
                                                           uint64_t da,
                                                           uint64_t db) {
  FA_WGMMA_SS_TB("bf16");
}
template <>
__device__ __forceinline__ void wgmma_ss_tb<__half>(float (&d)[32], uint64_t da,
                                                    uint64_t db) {
  FA_WGMMA_SS_TB("f16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16>(float (&d)[32],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db) {
  FA_WGMMA_RS("bf16");
}
template <>
__device__ __forceinline__ void wgmma_rs<__half>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  FA_WGMMA_RS("f16");
}

// Two f32 values rounded to the input type and packed low-first, as the
// A fragment and the output stores want them; `r0`/`r1` return the
// rounded values.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1, float* r0,
                                          float* r1);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x0, float x1,
                                                         float* r0, float* r1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *r0 = __low2float(h);
  *r1 = __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x0, float x1, float* r0,
                                                  float* r1) {
  const __half2 h = __floats2half2_rn(x0, x1);
  *r0 = __low2float(h);
  *r1 = __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The accumulator of a 64 x 64 product, rounded to T and packed as the A
// fragments of a product over its 64 columns: for columns [16 kk, 16 kk +
// 16), a[kk][0..3] = (row0, lo), (row1, lo), (row0, hi), (row1, hi) of
// d[8 kk .. 8 kk + 8).  `s0`/`s1` receive the sums of the rounded values
// of rows row0 and row1 (this thread's share).
template <typename T>
__device__ __forceinline__ void pack_a(const float (&d)[32], uint32_t (&a)[4][4],
                                       float* s0, float* s1) {
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      float r0, r1;
      a[kk][r] = pack2<T>(d[i], d[i + 1], &r0, &r1);
      if (r & 1)
        sum1 += r0 + r1;
      else
        sum0 += r0 + r1;
    }
  }
  *s0 = sum0;
  *s1 = sum1;
}

// The accumulator of a 64 x 64 product, rounded to T, into a 64 x 64
// operand tile in shared memory as TMA would have written it: row r's 64
// columns in one 128-byte row, its 16-byte units XORed with r % 8 (the
// 128-byte swizzle; `tile` 1024-aligned), so that kmajor_desc reads it as
// a K-major A operand.  This thread holds rows row0 and row0 + 8 and
// columns 8 g + col + {0, 1} (col even).
template <typename T>
__device__ __forceinline__ void store_operand(uint8_t* tile, const float (&d)[32],
                                              int row0, int col) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      float r0, r1;
      const uint32_t v = pack2<T>(d[4 * g + 2 * half], d[4 * g + 2 * half + 1], &r0, &r1);
      *reinterpret_cast<uint32_t*>(tile + r * kRowBytes + ((g ^ (r & 7)) << 4) +
                                   2 * col) = v;
    }
  }
}

// Plain shared-memory stores made visible to the async proxy (wgmma's and
// TMA's reads); each writing thread fences before the barrier that
// publishes them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers 1.. over the two consumer warpgroups (256 threads): one
// side arrives without waiting, the other waits for it.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The warpgroup index, made warp-uniform for the compiler by the shuffle:
// wgmma in a branch it cannot prove uniform is serialized.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// The producer warpgroup hands its registers to NC = 2 consumer
// warpgroups (24 + 2 x 240 per thread fits the SM's 64 K registers for
// one block of 384 threads); with one consumer nothing is moved.
template <int NC>
__device__ __forceinline__ void producer_regs() {
  if (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
template <int NC>
__device__ __forceinline__ void consumer_regs() {
  if (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// -- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda); the
// static's initialisation is thread-safe, so concurrent first callers wait
// for one lookup.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The encoder is a driver call and needs a context current on the calling
// thread.  The runtime binds one to a host thread only at the thread's first
// runtime call that needs it, so a fresh thread whose first CUDA work is this
// launch has none yet (the encoder then fails).  cudaSetDevice binds the
// device's primary context (CUDA 12); it runs once per thread and device.
inline cudaError_t bind_context(int device) {
  thread_local int bound = -1;
  if (bound == device) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) bound = device;
  return err;
}

// What a tensor map is a function of: type, address, sizes and strides.
struct MapKey {
  const void* ptr;
  int64_t type, dh, heads, tokens, batch, s_head, s_tok, s_batch;
  bool operator==(const MapKey& o) const {
    return std::memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};
static_assert(sizeof(MapKey) == 72, "no padding: keys compare bytewise");

// A 4-d map over (head dim, heads, tokens, batch) with the tensor's own
// strides (elements), read in boxes of (64 columns, 1 head, 64 tokens, 1
// batch) with the 128-byte swizzle; rows past the end read as zeros.
// Encoding costs microseconds of host time a call, so the last maps are
// kept in a small direct-mapped cache: the caching allocator hands the
// same addresses back call after call, and a map depends on nothing but
// its key.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                   int dh, int heads, int tokens, int batch, int64_t s_head,
                   int64_t s_tok, int64_t s_batch) {
  struct Entry {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static std::mutex mu;
  const MapKey key{ptr, type, dh, heads, tokens, batch, s_head, s_tok, s_batch};
  const uint64_t hash = (reinterpret_cast<uint64_t>(ptr) >> 8) ^
                        static_cast<uint64_t>(tokens) * 0x9E3779B97F4A7C15ull ^
                        static_cast<uint64_t>(s_tok) ^ static_cast<uint64_t>(type);
  Entry& slot = cache[hash % kEntries];
  {
    std::lock_guard<std::mutex> hold(mu);
    if (slot.used && slot.key == key) {
      *map = slot.map;
      return true;
    }
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(tokens),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_tok) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {kChunk, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> hold(mu);
  slot = Entry{key, *map, true};
  return true;
}

}  // namespace
