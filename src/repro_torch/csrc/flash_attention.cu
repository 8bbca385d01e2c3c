// Flash attention forward on Hopper (sm_90a): causal or full attention
// over (B, Tq, H, dh) queries and (B, Tk, Kv, dh) keys/values, with GQA,
// an optional softcap and sliding window, and an f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, pallas_call at line 138).  The TPU kernel runs a
// (B*H, nq, nk) grid whose innermost kv axis is sequential, carrying the
// softmax state in VMEM scratch from one grid step to the next, and needs
// GQA expanded upstream (a jnp.repeat copy of K/V).  Here one block owns
// one (batch, head, q tile) and loops over the kv tiles itself, so the
// softmax state stays in registers; query head h reads kv head
// h / (H / Kv) in place, so no repeated copy of K/V is made.
//
// Two routes, chosen by the input type alone:
//
// * bf16 / f16: the tensor-core kernel (`flash_wgmma_kernel`).  A block
//   is NC consumer warpgroups of 64 query rows each (NC = 2 for dh 64 and
//   128, 1 for dh 256, whose output alone takes 128 f32 registers a
//   thread) and one producer warpgroup, which gives its registers to the
//   consumers (setmaxnreg 24 / 240) and whose first thread issues every
//   load.  It loads the Q tiles once and streams 64-key K and V tiles
//   through a two-stage ring in shared memory with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle; K and V each complete on an
//   mbarrier of their own), and reloads a stage when every consumer
//   thread has arrived on its "empty" barrier.
//   - S = Q.K^T is wgmma m64n64k16 (bf16/f16 in, f32 accumulators), both
//     operands read from shared memory through descriptors.
//   - O += P.V is wgmma m64n64k16 per 64 head-dim columns: P comes from
//     registers (the S accumulator exponentiated, rounded to the input
//     type and packed as the A fragment), V is read from shared memory
//     as an MN-major ("transposed") B operand, so V is never copied
//     transposed.
//   - A tile's S is issued together with the previous tile's P.V, so the
//     softmax of one overlaps the other's product.
//   - The softmax folds scale*log2(e) into the exponent's fma and uses
//     exp2 (with a softcap, tanh on the f32 scores first); row max and
//     sum are reduced over the 4 threads of a quad that own a row.  The
//     causal, window and ragged-edge masks run only on a tile that
//     crosses them.  The row sum adds up the rounded P, so the weights
//     the product uses sum to one.
//   - Tiles above the diagonal or outside the window are never loaded.
//     With two warpgroups a block takes q tiles i and n - 1 - i of one
//     head, so every block carries the same causal work; with one, the
//     heaviest tiles run first.
//   - No split over keys and no atomics: two calls give the same bytes.
//   - The branches around wgmma must be provably warp-uniform (the
//     warpgroup index goes through a shuffle), or ptxas serializes every
//     wgmma; and each softmax step runs under a uniform branch of its
//     own, or the compiler evaluates tanh and the mask for every tile.
// * f32: `flash_f32_kernel`, f32 CUDA-core FMAs from shared memory (wgmma
//   has no f32 inputs, and TF32 would not hold the f32 tolerance).
//
// TMA's rules bind the tensor-core route: every base address 16-byte
// aligned, every batch/token/head stride a multiple of 16 bytes, the head
// dim contiguous.  The wrapper raises on anything else.
//
// Arithmetic (both routes): q.k in f32, times `scale`, then
// softcap * tanh(s / softcap), then the mask; p = exp(s - m) in f32; the
// output is acc / max(l, 1e-30), rounded to the input type.  The
// tensor-core route rounds p to the input type before p.v.
//
// What bounds it: 4 * Tq * Tk * dh * H operations (about half when
// causal) against reading q, k, v and writing o once: at the prefill's
// shapes the tensor cores' rate.  At the qwen2.5-3b prefill's shape
// (B=1, T=1024, H=16, dh=128) the kernel is held back by the latency of
// one warpgroup's chain of tiles: the block with q tiles 0 and 15 runs 16
// key tiles on one warpgroup, most of them with its partner idle, about
// 0.85 us a tile (PERF.md, PR 15).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>

#include "per_device.h"

namespace {

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int B, Tq, Tk, H, Kv;
  float scale;
  float softcap;  // <= 0: off
  int causal;
  int window;  // <= 0: none
};

// The kv range [begin, end) a q tile of rows [q0, q0 + rows) can see.
__device__ __forceinline__ void kv_range(const Args& a, int q0, int rows,
                                         int* begin, int* end) {
  *end = a.causal ? min(a.Tk, q0 + rows) : a.Tk;
  *begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
}

// -- the f32 route: CUDA-core FMAs -------------------------------------------

constexpr int kF32Threads = 128;  // 4 warps
constexpr int kF32BlockK = 32;    // keys per tile: one per lane in the softmax

// Shared memory, in floats: Q tile (BQ x (DH+1)), K tile (BK x (DH+1)),
// V tile (BK x DH), scores/probabilities (BQ x (BK+1)), and the per-row
// rescale factor (BQ).  The +1 pads make the column walks of the score
// product hit 32 distinct banks.
template <int DH, int BQ>
constexpr int f32_smem_floats() {
  return BQ * (DH + 1) + kF32BlockK * (DH + 1) + kF32BlockK * DH +
         BQ * (kF32BlockK + 1) + BQ;
}
template <int DH, int BQ>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const Args a) {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static_assert(BQ % 16 == 0, "q tile must be a multiple of 16");
  constexpr int RPT = BQ / 16;      // score rows per thread
  constexpr int ROWS_W = BQ / 4;    // softmax / output rows per warp
  constexpr int COLS = DH / 32;     // output columns per lane
  constexpr int QS = DH + 1;        // padded row strides
  constexpr int KS = DH + 1;
  constexpr int SS = kF32BlockK + 1;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + kF32BlockK * KS;
  float* sS = sV + kF32BlockK * DH;
  float* sC = sS + BQ * SS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = qt * BQ;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * DH; i += kF32Threads) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    sQ[r * QS + d] = row < a.Tq ? q[row * a.q_st + d] : 0.f;
  }

  // kv range this q tile can see
  int k_begin, k_end;
  kv_range(a, q0, BQ, &k_begin, &k_end);
  const int t_begin = k_begin / kF32BlockK;
  const int t_end = (k_end + kF32BlockK - 1) / kF32BlockK;

  // per-warp softmax state of its ROWS_W rows, one row per lane slot
  float m_row = kMask;  // lane r < ROWS_W holds row warp*ROWS_W + r
  float l_row = 0.f;
  float acc[ROWS_W][COLS];
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  const int rg = tid >> 3;  // score row group: rows rg*RPT + i
  const int cg = tid & 7;   // score key columns cg + 8*j

  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * kF32BlockK;
    __syncthreads();  // previous tile's K/V/S fully consumed
    for (int i = tid; i < kF32BlockK * DH; i += kF32Threads) {
      const int j = i / DH, d = i % DH;
      const int key = k0 + j;
      const bool in = key < a.Tk;
      sK[j * KS + d] = in ? k[key * a.k_st + d] : 0.f;
      sV[j * DH + d] = in ? v[key * a.v_st + d] : 0.f;
    }
    __syncthreads();

    // scores: RPT rows x 4 keys per thread
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(rg * RPT + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 8 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 8 * j;
        const int kpos = k0 + c;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool live = kpos < a.Tk;
        if (a.causal) live = live && qpos >= kpos;
        if (a.window > 0) live = live && qpos - kpos < a.window;
        sS[r * SS + c] = live ? x : kMask;
      }
    }
    __syncthreads();

    // online softmax: warp `warp` owns rows warp*ROWS_W .. +ROWS_W,
    // lane = key column of the tile
#pragma unroll
    for (int r = 0; r < ROWS_W; ++r) {
      const int row = warp * ROWS_W + r;
      const float x = sS[row * SS + lane];
      const float m_old = __shfl_sync(0xffffffffu, m_row, r);
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = x == kMask ? 0.f : expf(x - m_new);
      sS[row * SS + lane] = p;
      const float l_tile = warp_sum(p);
      const float corr = expf(m_old - m_new);
      if (lane == r) {
        m_row = m_new;
        l_row = l_row * corr + l_tile;
      }
      if (lane == 0) sC[row] = corr;
    }
    __syncwarp();

    // acc = acc * corr + p . V over this warp's rows
#pragma unroll
    for (int r = 0; r < ROWS_W; ++r) {
      const float c = sC[warp * ROWS_W + r];
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) acc[r][cc] *= c;
    }
#pragma unroll 4
    for (int j = 0; j < kF32BlockK; ++j) {
      float vv[COLS];
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) vv[cc] = sV[j * DH + lane + 32 * cc];
#pragma unroll
      for (int r = 0; r < ROWS_W; ++r) {
        const float p = sS[(warp * ROWS_W + r) * SS + j];
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) acc[r][cc] = fmaf(p, vv[cc], acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_W; ++r) {
    const int row = q0 + warp * ROWS_W + r;
    const float l = fmaxf(__shfl_sync(0xffffffffu, l_row, r), 1e-30f);
    if (row < a.Tq) {
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        o[row * a.o_st + lane + 32 * cc] = acc[r][cc] / l;
      }
    }
  }
}

// -- the bf16/f16 route: wgmma fed by TMA --------------------------------------

constexpr int kChunk = 64;    // head-dim columns per 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kBlockK = 64;  // keys per kv tile
constexpr int kStages = 2;   // K/V ring depth

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

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout
// SWIZZLE_128B.  The swizzle atom is 8 rows of 128 bytes (1024 bytes), so
// every tile base is 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
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

// Shared-memory layout of a tensor-core block: the Q tile, the K and V
// rings, then the mbarriers (Q loaded; per stage K loaded, V loaded, and
// "empty": released by every consumer thread).  Each tile is stored as
// DH/64 column chunks of (rows x 128 bytes), the layout TMA's 128-byte
// swizzle writes and wgmma's descriptors read.
template <int DH, int NC>
struct TcLayout {
  static constexpr int BQ = 64 * NC;  // query rows: 64 per consumer warpgroup
  static constexpr int THREADS = (NC + 1) * 128;  // + the producer warpgroup
  static constexpr int KV_BYTES = kBlockK * DH * 2;  // one K or V tile
  static constexpr int K_OFF = BQ * DH * 2;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  // + slack to align the dynamic base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int DH, int NC>
__global__ void __launch_bounds__(TcLayout<DH, NC>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = TcLayout<DH, NC>;
  constexpr int ND = DH / kChunk;  // 64-column chunks of the head dim
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + L::K_OFF;
  const uint32_t sV = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;            // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;  // + 8 * stage
  const uint32_t empty = v_full + 8 * kStages;   // + 8 * stage

  // Work items, each warpgroup a 64-row q tile of one (batch, head).  One
  // consumer warpgroup: the heaviest causal tiles first.  Two: tiles i and
  // n - 1 - i, so that every block carries the same causal work (n + 1 key
  // tiles); for odd n the middle tile's block leaves warpgroup 1 idle.
  const int BH = a.B * a.H;
  const int n64 = (a.Tq + 63) / 64;
  const int item = static_cast<int>(blockIdx.x);
  const int bh = item % BH;
  const int tile0 = NC == 1 ? n64 - 1 - item / BH : item / BH;
  const int tile1 = n64 - 1 - tile0;
  const bool two = NC == 2 && tile1 > tile0;  // warpgroup 1 has rows
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  // the keys any row of the block sees
  int k_begin, k_end;
  kv_range(a, 64 * tile0, 64, &k_begin, &k_end);
  if (two) {
    int b1, e1;
    kv_range(a, 64 * tile1, 64, &b1, &e1);
    k_begin = min(k_begin, b1);
    k_end = max(k_end, e1);
  }
  const int t_begin = k_begin / kBlockK;
  const int n_tiles = max(0, (k_end + kBlockK - 1) / kBlockK - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  // warpgroup index, made warp-uniform for the compiler by the shuffle:
  // wgmma in a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == NC) {
    // producer warpgroup: it hands its registers to the consumers, and one
    // thread issues every TMA load
    if (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(q_full, (two ? 2 : 1) * 64 * DH * 2);
      for (int c = 0; c < ND; ++c) {
        tma_load(sQ + c * L::BQ * kRowBytes, &qmap, q_full, c * kChunk, h,
                 64 * tile0, b);
        if (two)
          tma_load(sQ + c * L::BQ * kRowBytes + 64 * kRowBytes, &qmap, q_full,
                   c * kChunk, h, 64 * tile1, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
        const int k0 = (t_begin + it) * kBlockK;
        mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
        for (int c = 0; c < ND; ++c)
          tma_load(sK + s * L::KV_BYTES + c * kBlockK * kRowBytes, &kmap,
                   k_full + 8 * s, c * kChunk, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
        for (int c = 0; c < ND; ++c)
          tma_load(sV + s * L::KV_BYTES + c * kBlockK * kRowBytes, &vmap,
                   v_full + 8 * s, c * kChunk, kvh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns query rows [qa, qa + 64); in the wgmma
  // accumulator layout a thread holds rows row0 and row0 + 8, columns
  // 8 * j + col + {0, 1} of every 8-column group j
  if (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const bool rows = wg == 0 || two;  // warpgroup-uniform
  const int qa = 64 * (wg == 0 ? tile0 : tile1);
  const int qb = qa + 63;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = qa + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  // scores to the log2 domain: one multiply folded into the exponent's
  // fma, or a pass of their own (softcap * tanh, or a scale <= 0, under
  // which the row max is not the max of the raw scores)
  const float sl = a.scale * kLog2e;
  const bool prescaled = capped || !(sl > 0.f);
  const float mul = prescaled ? 1.f : sl;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const uint32_t q_wg = sQ + wg * 64 * kRowBytes;

  float o[ND][32];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums
  float d[32];               // scores, then their exponentials
  uint32_t p[4][4];          // P of the last tile, packed

  // The block loads tiles [0, n_tiles); this warpgroup's rows see keys of
  // [live0, live1) (warpgroup-uniform).  The others it only releases.
  auto dead = [&](int it) {
    const int k0 = (t_begin + it) * kBlockK;
    return !rows || (a.causal && k0 > qb) ||
           (a.window > 0 && qa - (k0 + kBlockK - 1) >= a.window);
  };
  int live0 = 0, live1 = n_tiles;
  while (live0 < n_tiles && dead(live0)) ++live0;
  while (live1 > live0 && dead(live1 - 1)) --live1;
  auto wait_k = [&](int it) {
    mbar_wait(k_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto wait_v = [&](int it) {
    mbar_wait(v_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) { mbar_arrive(empty + 8 * (it % kStages)); };
  // S = Q.K^T for tile `it` into d
  auto issue_s = [&](int it) {
    const uint32_t ks = sK + (it % kStages) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // 16 head-dim columns: chunk kk / 4, 32 bytes into its rows
      const uint32_t col_bytes = (kk % 4) * 32;
      wgmma_ss<T>(d,
                  sw128_desc(q_wg + (kk / 4) * L::BQ * kRowBytes + col_bytes,
                             16, 1024),
                  sw128_desc(ks + (kk / 4) * kBlockK * kRowBytes + col_bytes,
                             16, 1024),
                  kk > 0);
    }
  };
  // O += P.V for tile `it`, V MN-major: 8-key groups 1024 bytes apart,
  // 64-column chunks kBlockK * 128 bytes apart
  auto issue_pv = [&](int it) {
    wait_v(it);
    const uint32_t vs = sV + (it % kStages) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < ND; ++j)
        wgmma_rs<T>(o[j], p[kk],
                    sw128_desc(vs + j * kBlockK * kRowBytes + kk * 16 * kRowBytes,
                               1024, 1024));
  };
  // softcap, the mask (only on a tile that crosses an edge), the new row
  // max, and exp2(s * mul - max) left in d; returns the correction
  // factors of the old sums and accumulators.  Each step is a loop under
  // a uniform branch, so that no tile pays for tanh or the mask unless
  // it needs them.
  auto softmax = [&](int it, float* c0, float* c1) {
    const int k0 = (t_begin + it) * kBlockK;
    const bool edge = k0 + kBlockK > a.Tk ||
                      (a.causal && k0 + kBlockK - 1 > qa) ||
                      (a.window > 0 && qb - k0 >= a.window);
    if (capped) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = cap_out * tanhf(d[i] * cap_in);
    } else if (prescaled) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] *= sl;
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row1 : row0;
        const int key = k0 + 8 * (i / 4) + col + (i & 1);
        bool live = key < a.Tk;
        if (a.causal) live = live && row >= key;
        if (a.window > 0) live = live && row - key < a.window;
        if (!live) d[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(d[i], d[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(d[i + 2], d[i + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // a row that has seen no key keeps max -inf: exponentiate against 0
    const float mn0 = fmaxf(m0, mx0 * mul);
    const float mn1 = fmaxf(m1, mx1 * mul);
    const float z0 = mn0 == -INFINITY ? 0.f : mn0;
    const float z1 = mn1 == -INFINITY ? 0.f : mn1;
    *c0 = ex2(m0 - z0);
    *c1 = ex2(m1 - z1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = ex2(fmaf(d[i], mul, (i & 2) ? -z1 : -z0));
  };
  // rescale O and the sums, and pack P rounded to T as wgmma's A
  // fragments: for keys [16 kk, 16 kk + 16), p[kk][0..3] = (row0, lo),
  // (row1, lo), (row0, hi), (row1, hi) of d[8 kk .. 8 kk + 8); the sums
  // add up the rounded P, so the weights P.V uses sum to one
  auto rescale_pack = [&](float c0, float c1) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= (i & 2) ? c1 : c0;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        float r0, r1;
        p[kk][r] = pack2<T>(d[i], d[i + 1], &r0, &r1);
        if (r & 1)
          s1 += r0 + r1;
        else
          s0 += r0 + r1;
      }
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
  };

  mbar_wait(q_full, 0);
  // tiles no row of this warpgroup sees: both loads must land before the
  // stage is released (a barrier's phases are told apart by parity alone)
  for (int it = 0; it < live0; ++it) {
    wait_k(it);
    wait_v(it);
    release(it);
  }
  if (live0 < live1) {
    float c0, c1;
    wait_k(live0);
    wg_fence();
    issue_s(live0);
    wg_commit();
    wg_wait<0>();
    softmax(live0, &c0, &c1);
    rescale_pack(c0, c1);
    // steady state: tile it's S and tile it-1's P.V in flight together,
    // the softmax of tile it overlapping the P.V
    for (int it = live0 + 1; it < live1; ++it) {
      wait_k(it);
      wg_fence();
      issue_s(it);
      wg_commit();
      issue_pv(it - 1);
      wg_commit();
      wg_wait<1>();  // S is in; P.V may still run
      softmax(it, &c0, &c1);
      wg_wait<0>();
      release(it - 1);
      rescale_pack(c0, c1);
    }
    wg_fence();
    issue_pv(live1 - 1);
    wg_commit();
    wg_wait<0>();
    release(live1 - 1);
  }
  for (int it = live1; it < n_tiles; ++it) {
    wait_k(it);
    wait_v(it);
    release(it);
  }
  if (!rows) return;

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* out = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = kChunk * j + 8 * g + col;
      float r0, r1;
      if (row0 < a.Tq)
        *reinterpret_cast<uint32_t*>(out + row0 * a.o_st + c) =
            pack2<T>(o[j][4 * g] * inv0, o[j][4 * g + 1] * inv0, &r0, &r1);
      if (row1 < a.Tq)
        *reinterpret_cast<uint32_t*>(out + row1 * a.o_st + c) =
            pack2<T>(o[j][4 * g + 2] * inv1, o[j][4 * g + 3] * inv1, &r0, &r1);
    }
  }
}

// -- host side -------------------------------------------------------------------

template <int DH, int BQ>
cudaError_t f32_launch(const Args& a, int device, cudaStream_t stream) {
  constexpr int smem = f32_smem_floats<DH, BQ>() * static_cast<int>(sizeof(float));
  auto kernel = flash_f32_kernel<DH, BQ>;
  static PerDevice configured;  // the attribute, per kernel and device
  const cudaError_t err = configured.once(device, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t f32_dispatch(int dh, const Args& a, int device,
                         cudaStream_t stream) {
  switch (dh) {
    case 64:
      return f32_launch<64, 64>(a, device, stream);
    case 128:
      return f32_launch<128, 64>(a, device, stream);
    case 256:
      return f32_launch<256, 32>(a, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda); the
// static's initialisation is thread-safe, so concurrent first callers wait
// for one lookup.
EncodeTiled encoder() {
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
cudaError_t bind_context(int device) {
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
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
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

template <typename T, int DH, int NC>
cudaError_t tc_launch(const Args& a, const CUtensorMap (&maps)[3], int device,
                      cudaStream_t stream) {
  using L = TcLayout<DH, NC>;
  auto kernel = flash_wgmma_kernel<T, DH, NC>;
  static PerDevice configured;  // the attribute, per kernel and device
  const cudaError_t err = configured.once(device, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  });
  if (err != cudaSuccess) return err;
  const int n_qt = (a.Tq + L::BQ - 1) / L::BQ;  // = ceil(ceil(Tq / 64) / NC)
  kernel<<<n_qt * a.B * a.H, L::THREADS, L::SMEM, stream>>>(maps[0], maps[1],
                                                           maps[2], a);
  return cudaGetLastError();
}

// The built tiles: 128 query rows (two consumer warpgroups) for dh 64 and
// 128, 64 rows (one) for dh 256; 64 keys.
template <typename T>
cudaError_t tc_dispatch(int dh, int block_q, int block_k, const Args& a,
                        CUtensorMapDataType type, int device,
                        cudaStream_t stream) {
  if (block_q != (dh == 256 ? 64 : 128) || block_k != kBlockK)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_context(device);
  if (bound != cudaSuccess) return bound;
  CUtensorMap maps[3];
  if (!encode(&maps[0], type, a.q, dh, a.H, a.Tq, a.B, a.q_sh, a.q_st, a.q_sb) ||
      !encode(&maps[1], type, a.k, dh, a.Kv, a.Tk, a.B, a.k_sh, a.k_st, a.k_sb) ||
      !encode(&maps[2], type, a.v, dh, a.Kv, a.Tk, a.B, a.v_sh, a.v_st, a.v_sb))
    return cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return tc_launch<T, 64, 2>(a, maps, device, stream);
    case 128:
      return tc_launch<T, 128, 2>(a, maps, device, stream);
    case 256:
      return tc_launch<T, 256, 1>(a, maps, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One call's sizes, strides and options, built once per call signature by
// the wrapper (its ctypes structure `_Params` has this layout), so that a
// launch passes six arguments rather than thirty.
struct Params {
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int32_t dtype;  // 0 float32 (the f32 route), 1 bfloat16, 2 float16
  int32_t B, Tq, Tk, H, Kv, dh;
  int32_t causal;
  int32_t window;   // <= 0: none
  int32_t block_q;  // tensor-core route: 128 (dh 64, 128) or 64 (dh 256)
  int32_t block_k;  // tensor-core route: 64
  float scale;
  float softcap;   // <= 0: off
  int32_t device;  // the CUDA device of q, k, v and o
};

// o[b, t, h, :] = attention of q[b, t, h, :] over k/v[b, :, h / (H/Kv), :]
// on `stream`, without synchronising; q, k, v and o of p->dtype, the head
// dim contiguous.  Returns a cudaError_t (cudaErrorInvalidValue for an
// unsupported dtype, dh or tile, or a layout TMA refuses).
static_assert(sizeof(Params) == 152 && offsetof(Params, dtype) == 96 &&
                  offsetof(Params, scale) == 140 &&
                  offsetof(Params, device) == 148,
              "Params must match the wrapper's ctypes structure");

extern "C" int flash_attention_launch(const Params* p, const void* q,
                                      const void* k, const void* v, void* o,
                                      cudaStream_t stream) {
  if (p->B <= 0 || p->Tq <= 0) return cudaSuccess;
  if (p->Tk <= 0 || p->Kv <= 0 || p->H % p->Kv != 0 || p->device < 0 ||
      p->device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const Args a{q,        k,        v,        o,        p->q_sb,   p->q_st,
               p->q_sh,  p->k_sb,  p->k_st,  p->k_sh,  p->v_sb,   p->v_st,
               p->v_sh,  p->o_sb,  p->o_st,  p->o_sh,  p->B,      p->Tq,
               p->Tk,    p->H,     p->Kv,    p->scale, p->softcap, p->causal,
               p->window};
  switch (p->dtype) {
    case 0:
      return f32_dispatch(p->dh, a, p->device, stream);
    case 1:
      return tc_dispatch<__nv_bfloat16>(p->dh, p->block_q, p->block_k, a,
                                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                        p->device, stream);
    case 2:
      return tc_dispatch<__half>(p->dh, p->block_q, p->block_k, a,
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT16, p->device,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
