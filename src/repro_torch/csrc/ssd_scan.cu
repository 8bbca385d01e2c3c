// Mamba-2 SSD within-chunk step on Hopper (sm_90a), f32.
//
// For one chunk bc of Q positions and one head h:
//
//   y_diag[q, p] = sum_{j<=q} (C_q . B_j) exp(dA_cs[q] - dA_cs[j]) dt_j x_j[p]
//   S[p, n]      = sum_j exp(dA_cs[Q-1] - dA_cs[j]) dt_j x_j[p] B_j[n]
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_chunk_fwd,
// pallas_call at line 80).  The TPU kernel takes a (BC, H / head_block)
// grid, builds the whole (Q, Q, head_block) decay tensor in VMEM and hands
// the products to the MXU; head_block (8) is a TPU tiling choice.  Here:
//
//   * one launch of 256-thread blocks (two warpgroups) of two kinds.  A y
//     block owns (chunk, 64-row q tile, set of up to 8 heads, 64 columns
//     of P); a state block owns (chunk, set of up to 4 heads, 64 columns
//     of P).  The blocks with the most work start first.  Any H works:
//     the last set of a chunk may be short;
//   * when B and C have a head stride of 0 (the model's single B/C group,
//     an expand view), every head of a set reads the same B and C: a y
//     block computes each C.B^T tile up to the diagonal once into shared
//     memory and reuses it for all its heads, and a state block loads the
//     chunk's B once for all its heads.  With per-head B/C a set is one
//     head, and the same code runs;
//   * every product runs on the tensor cores in 3xTF32: each f32 operand
//     is split into its TF32 high part and the TF32 cut of the rest, and
//     lo.hi + hi.lo + hi.hi are summed in f32 (lo.lo is dropped), close to
//     f32 accuracy; plain TF32 is not used.  C.B^T (64 x 64 per key tile,
//     K = N) runs on mma.sync m16n8k8 over all 8 warps.  The y and state
//     products run on wgmma m64nPk8, one warpgroup a head (or a 64-row
//     part of a state): A built in registers (a y block: C.B^T times the
//     head's decay exp(dA_cs[q] - dA_cs[j]) and dt_j; a state block:
//     B^T), x (a state block: x times exp(dA_cs[Q-1] - dA_cs[j]) dt_j)
//     split into two planes in shared memory, the hi.hi products and the
//     cross products in two accumulators that do not wait for each other;
//   * the decay's exponent is taken only on and below the diagonal and
//     inside the chunk: above it dA_cs[q] - dA_cs[j] > 0 can overflow, so
//     the exponent there is replaced by -inf before exp2 (a 0/1 mask
//     applied after exp would turn inf * 0 into NaN);
//   * a warpgroup loads the next x tile into registers (16-byte loads)
//     while it multiplies the current one; rows past Q (a ragged chunk,
//     any Q from 1 to 256) load as zeros and are not written;
//   * every input is read through its strides, with no broadcast copy;
//   * every sum runs in a fixed order, with no atomics: the same inputs
//     give the same bytes, which lossless paging relies on (and a head
//     stride of 0 gives the bytes of a per-head copy).
//
// What bounds it: at the prefill's shape (BC 4, Q 256, H 80, P 64, N 128)
// the causal products are about 2.7 GFLOP once C.B^T is shared (three
// times that in 3xTF32) against about 54 MB of traffic, so the memory
// rate.  The kernel is far above it (PERF.md): each warpgroup's chain of
// tiles is latency-bound.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "per_device.h"

namespace {

constexpr int kThreads = 256;  // 2 warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // rows of a q tile and of a key tile
constexpr int kMaxQ = 256;
constexpr int kYHeads = 8;  // most heads of a y block
constexpr int kSHeads = 4;  // most heads of a state block
constexpr int kPB = 64;     // most x columns (p) of a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCBS = kMaxQ + 4;  // row stride of the C.B^T tiles (floats)

// One call's sizes, strides and plan; `Params` below adds nothing else.
struct Shape {
  int64_t x_sb, x_sq, x_sh;  // element strides
  int64_t dt_sb, dt_sq, dt_sh;
  int64_t da_sb, da_sq, da_sh;
  int64_t b_sb, b_sq, b_sh;
  int64_t c_sb, c_sq, c_sh;
  int32_t device, BC, Q, H, P, N;
  int32_t y_heads;  // heads of a y block: kYHeads (shared B/C) or 1
  int32_t s_heads;  // heads of a state block: kSHeads or 1
};

struct Args {
  const float* x;     // (BC, Q, H, P)
  const float* dt;    // (BC, Q, H)
  const float* dacs;  // (BC, Q, H)
  const float* b;     // (BC, Q, H, N)
  const float* c;     // (BC, Q, H, N)
  float* y;           // (BC, Q, H, P), contiguous
  float* s;           // (BC, H, P, N), contiguous
  Shape p;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills zeros without reading.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + rows) of a (rows x width) f32 block whose rows lie
// `sq` elements apart, into shared memory rows `ld` floats apart; rows at
// or past `valid` fill with zeros.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t sq, int row0, int rows,
                                          int valid, int width) {
  const int cpr = width / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
    const int r = i / cpr, c = i % cpr;
    const bool in = r < valid;
    cp_async16(smem_addr(dst + r * ld + c * 4),
               src + (in ? row0 + r : 0) * sq + c * 4, in ? 16 : 0);
  }
}

// x = hi + lo + (what 3xTF32 drops): hi is x cut to TF32's 10 mantissa
// bits, lo the exact rest cut the same way
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// 2^x (ex2.approx, relative error about 2^-22; 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tiles of an (MT * 16) x (NTL * 8) product, spread over the warps:
// tile i = warp + 8 s (s < TPW) has m tile i % MT, which is the warp's
// own for every s (MT divides 8), and n tile i / MT.
template <int MT, int NTL>
struct Tiles {
  static constexpr int TOTAL = MT * NTL;
  static constexpr int TPW = (TOTAL + kWarps - 1) / kWarps;
};

// acc += A.B over k steps [0, ksteps) of 8, in 3xTF32.  la(mt, ks, hi, lo)
// gives this thread's A elements (g, t), (g+8, t), (g, t+4), (g+8, t+4) of
// m tile mt, k step ks, split; lb(nt, ks, hi, lo) its B elements (k t,
// n g) and (k t+4, n g); g = lane / 4, t = lane % 4.  Every accumulator
// adds lo.hi, then hi.lo, then hi.hi at each k step: one fixed order.
template <int MT, int NTL, typename LoadA, typename LoadB>
__device__ __forceinline__ void warp_gemm(float (&acc)[Tiles<MT, NTL>::TPW][4],
                                          int ksteps, LoadA la, LoadB lb) {
  using W = Tiles<MT, NTL>;
  const int warp = threadIdx.x >> 5;
  const int mt = warp % MT;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[4], al[4];
    la(mt, ks, ah, al);
    uint32_t bh[W::TPW][2], bl[W::TPW][2];
#pragma unroll
    for (int s = 0; s < W::TPW; ++s) {
      const int i = warp + kWarps * s;
      if (W::TOTAL % kWarps == 0 || i < W::TOTAL) {
        lb(i / MT, ks, bh[s], bl[s]);
      } else {
        bh[s][0] = bh[s][1] = bl[s][0] = bl[s][1] = 0u;
      }
    }
    // the three passes over all tiles in turn, so that the products of a
    // pass are independent
#pragma unroll
    for (int s = 0; s < W::TPW; ++s) mma_tf32(acc[s], al, bh[s][0], bh[s][1]);
#pragma unroll
    for (int s = 0; s < W::TPW; ++s) mma_tf32(acc[s], ah, bl[s][0], bl[s][1]);
#pragma unroll
    for (int s = 0; s < W::TPW; ++s) mma_tf32(acc[s], ah, bh[s][0], bh[s][1]);
  }
}

// -- the y and state products on wgmma ------------------------------------
//
// A warpgroup multiplies a 64 x 64-key A tile, held in registers in mma's
// m16n8k8 layout (warp w of the group owns rows 16 w..16 w + 15), by a
// 64-key x PB tile of x in shared memory: wgmma m64nPBk8 TF32, f32
// accumulators.  The x tile is stored split, a TF32 plane of the high
// parts and one of the low parts, each K-major in the no-swizzle layout:
// 8 x 4 cores of 128 bytes (8 rows of p, 4 keys each), the two cores of a
// k step 128 bytes apart, the next 8 p rows 256 bytes on.

constexpr uint32_t kLBO = 128;  // bytes between the two cores of a k step
constexpr uint32_t kSBO = 256;  // bytes between cores 8 p rows apart

template <int PB>
__device__ __forceinline__ int plane_off(int p, int j) {  // in floats
  return ((j >> 3) * (PB / 8) + (p >> 3)) * 64 + ((j >> 2) & 1) * 32 +
         (p & 7) * 4 + (j & 3);
}

__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(kLBO >> 4) << 16 |
         static_cast<uint64_t>(kSBO >> 4) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// the 128 threads of warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
// plain shared-memory stores become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define SSD_A4 "{%0, %1, %2, %3}"
template <int PB>
struct Wgmma;

// d (64 x PB) += A (64 x 8, registers) . B (8 x PB at desc), TF32
template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void run(float (&d)[8], const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void run(float (&d)[16], const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void run(float (&d)[32], const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Registers that wgmma reads or writes are pinned in program order
// against the fences and waits around it: without this the compiler may
// move their other writes and reads across those (register-only) points,
// and ptxas then serializes every wgmma.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]));
}
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A . X over one 64-key tile in 3xTF32: per k step hi.hi into dh
// and lo.hi + hi.lo into dx, two chains of products that do not wait for
// each other (the caller adds dh + dx at the end).  la(ks, hi, lo) builds
// the A tile's parts of k step ks in registers; all eight are built
// first, with their loads and exponents in flight together, then the 24
// products issue back to back.  xh/xl: the x planes.  Waits for the
// products before it returns.
template <int PB, typename LoadA>
__device__ __forceinline__ void wg_tile(float (&dh)[PB / 2], float (&dx)[PB / 2],
                                        LoadA la, const float* xh,
                                        const float* xl) {
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    la(ks, ah[ks], al[ks]);
    pin(ah[ks]);
    pin(al[ks]);
  }
  pin(dh);
  pin(dx);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint64_t bh = plane_desc(xh + ks * (PB / 8) * 64);
    const uint64_t bl = plane_desc(xl + ks * (PB / 8) * 64);
    Wgmma<PB>::run(dx, al[ks], bh);
    Wgmma<PB>::run(dh, ah[ks], bh);
    Wgmma<PB>::run(dx, ah[ks], bl);
  }
  wg_commit();
  wg_wait<0>();
  pin(dh);
  pin(dx);
}

// A 64-row x PB-column f32 tile of x, held by the 128 threads of a
// warpgroup (PB / 2 floats each) between its load and its store.
template <int PB>
struct XRegs {
  float4 v[PB / 8];
};

// The 16-byte piece (row rr, 4-column chunk c) a thread holds in turn i:
// each warp takes a block of 4 rows x 8 chunks (8 rows x 4 for PB 16),
// its lanes down the rows first, so that the plane stores below meet no
// bank conflict (PB 32 and 64; two-way for PB 16) and each row's chunks
// load as one 128-byte segment.
template <int PB>
__device__ __forceinline__ void x_piece(int i, int wt, int& rr, int& c) {
  constexpr int C = PB / 4 < 8 ? PB / 4 : 8;  // chunks of a warp's block
  constexpr int R = 32 / C;                   // rows of a warp's block
  constexpr int NBC = PB / 4 / C;             // blocks across a row
  const int b = i * 4 + (wt >> 5), l = wt & 31;
  rr = b / NBC * R + l % R;
  c = b % NBC * C + l / R;
}

// rows [row0, row0 + 64) of x (rows `sq` apart), zeros at or past `valid`
template <int PB>
__device__ __forceinline__ void x_load(XRegs<PB>& r, const float* src,
                                       int64_t sq, int row0, int valid, int wt) {
#pragma unroll
  for (int i = 0; i < PB / 8; ++i) {
    int rr, c;
    x_piece<PB>(i, wt, rr, c);
    r.v[i] = rr < valid
                 ? *reinterpret_cast<const float4*>(src + (row0 + rr) * sq + c * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the tile (each row times w[row] when w is given; rows at or past
// `valid` zero) into its two planes.  A thread stores its four columns
// starting at column (c / 2) % 4, which spreads a warp's stores over the
// 32 banks.
template <int PB>
__device__ __forceinline__ void x_store(const XRegs<PB>& r, float* xh, float* xl,
                                        const float* w, int valid, int wt) {
#pragma unroll
  for (int i = 0; i < PB / 8; ++i) {
    int rr, c;
    x_piece<PB>(i, wt, rr, c);
    const float e[4] = {r.v[i].x, r.v[i].y, r.v[i].z, r.v[i].w};
    const float scale = rr >= valid ? 0.f : w != nullptr ? w[rr] : 1.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = (u + (c >> 1)) & 3;
      uint32_t hi, lo;
      split(e[col] * scale, hi, lo);
      const int o = plane_off<PB>(c * 4 + col, rr);
      xh[o] = __uint_as_float(hi);
      xl[o] = __uint_as_float(lo);
    }
  }
}

// Shared memory of a y block, in floats: dA_cs and dt of its heads
// (kYHeads x kMaxQ each), the C.B^T tiles of its q tile (64 x kCBS), and
// a region that first holds the C and B tiles (64 x (N+4) each) and then
// each warpgroup's two x planes (64 x PB each).
template <int P, int N>
constexpr int y_floats() {
  constexpr int PB = P < kPB ? P : kPB;
  return 2 * kYHeads * kMaxQ + kTile * kCBS +
         (2 * (N + 4) > 4 * PB ? 2 * (N + 4) : 4 * PB) * kTile;
}

// ... of a state block: each head's weights exp(seg - dA_cs[j]) dt_j
// (kSHeads x kMaxQ), the chunk's B (kMaxQ x (N+8)), each warpgroup's two
// planes of the weighted x tile (64 x PB each).
template <int P, int N>
constexpr int state_floats() {
  constexpr int PB = P < kPB ? P : kPB;
  return kSHeads * kMaxQ + kMaxQ * (N + 8) + 4 * kTile * PB;
}

template <int P, int N>
constexpr int smem_bytes() {
  return 4 * (y_floats<P, N>() > state_floats<P, N>() ? y_floats<P, N>()
                                                      : state_floats<P, N>());
}

template <int P, int N>
__device__ void y_block(const Args& a, int bc, int qt, int h_first, int nh,
                        int p0, float* smem) {
  constexpr int PB = P < kPB ? P : kPB;  // x columns of this block
  constexpr int CS = N + 4;  // C and B rows: A (g, t) and B (n g, k t) walk 32 banks
  const Shape& p = a.p;
  float* sDa = smem;
  float* sDt = sDa + kYHeads * kMaxQ;
  float* sCB = sDt + kYHeads * kMaxQ;
  float* sC = sCB + kTile * kCBS;  // phase 1
  float* sB = sC + kTile * CS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int qn = min(kTile, p.Q - q0);
  const int rows = q0 + qn;  // key rows this q tile sees
  const int nj = qt + 1;     // key tiles up to the diagonal

  // dA_cs and dt of the heads, rows [0, rows), heads fastest
  for (int i = tid; i < nh * rows; i += kThreads) {
    const int j = i / nh, h = i % nh;
    sDa[h * kMaxQ + j] = a.dacs[bc * p.da_sb + j * p.da_sq + (h_first + h) * p.da_sh];
    sDt[h * kMaxQ + j] = a.dt[bc * p.dt_sb + j * p.dt_sq + (h_first + h) * p.dt_sh];
  }
  // C.B^T of the q tile against key tiles 0..qt, once for every head
  // (mma.sync, all 8 warps)
  const float* cb = a.c + bc * p.c_sb + h_first * p.c_sh;
  const float* bb = a.b + bc * p.b_sb + h_first * p.b_sh;
  load_rows(sC, CS, cb, p.c_sq, q0, kTile, qn, N);
  for (int jt = 0; jt < nj; ++jt) {
    load_rows(sB, CS, bb, p.b_sq, jt * kTile, kTile, min(kTile, p.Q - jt * kTile), N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[Tiles<4, 8>::TPW][4] = {};
    warp_gemm<4, 8>(
        acc, N / 8,
        [&](int mt, int ks, uint32_t* hi, uint32_t* lo) {
          const float* r0 = sC + (mt * 16 + g) * CS + ks * 8 + t;
          split(r0[0], hi[0], lo[0]);
          split(r0[8 * CS], hi[1], lo[1]);
          split(r0[4], hi[2], lo[2]);
          split(r0[8 * CS + 4], hi[3], lo[3]);
        },
        [&](int nt, int ks, uint32_t* hi, uint32_t* lo) {
          const float* r0 = sB + (nt * 8 + g) * CS + ks * 8 + t;
          split(r0[0], hi[0], lo[0]);
          split(r0[4], hi[1], lo[1]);
        });
#pragma unroll
    for (int s = 0; s < Tiles<4, 8>::TPW; ++s) {
      const int i = warp + kWarps * s;
      float* o = sCB + ((i % 4) * 16 + g) * kCBS + jt * kTile + (i / 4) * 8 + 2 * t;
      o[0] = acc[s][0];
      o[1] = acc[s][1];
      o[8 * kCBS] = acc[s][2];
      o[8 * kCBS + 1] = acc[s][3];
    }
    __syncthreads();  // sB is read; the next tile may load (or phase 2 begin)
  }

  // phase 2, per warpgroup: heads wg, wg + 2, ... of the set, each over
  // key tiles 0..qt: y += W . x with W = C.B^T * decay * dt on and below
  // the diagonal, built in registers, and x in two planes; the next
  // tile's x loads into registers meanwhile
  // the warpgroup index through a shuffle, so that ptxas can prove the
  // branches around wgmma warp-uniform (else it serializes them)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wt = tid & 127, wq = (tid >> 5) & 3;
  float* xh = sC + wg * 2 * kTile * PB;
  float* xl = xh + kTile * PB;
  const int mine = wg < nh ? (nh - wg + 1) / 2 : 0;  // heads of this warpgroup
  const int steps = mine * nj;
  const int64_t y_row = static_cast<int64_t>(p.H) * P;  // y is contiguous
  auto load = [&](XRegs<PB>& r, int s) {
    const int h = h_first + wg + 2 * (s / nj), jt = s % nj;
    x_load<PB>(r, a.x + bc * p.x_sb + h * p.x_sh + p0, p.x_sq, jt * kTile,
               min(kTile, p.Q - jt * kTile), wt);
  };
  XRegs<PB> xr;
  if (steps > 0) load(xr, 0);
  float dh[PB / 2] = {}, dx[PB / 2] = {};
  for (int s = 0; s < steps; ++s) {
    const int hl = wg + 2 * (s / nj), jt = s % nj;  // head of the set, key tile
    x_store<PB>(xr, xh, xl, nullptr, kTile, wt);
    fence_async_smem();
    wg_sync(wg);
    if (s + 1 < steps) load(xr, s + 1);
    const float* da = sDa + hl * kMaxQ;
    const float* dtv = sDt + hl * kMaxQ;
    wg_tile<PB>(
        dh, dx,
        [&](int ks, uint32_t* hi, uint32_t* lo) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = wq * 16 + g + (e & 1) * 8;
            const int jp = jt * kTile + ks * 8 + t + (e >> 1) * 4;
            const int qp = q0 + q;
            // computed on every lane and selected, not branched on: the
            // exponent above the diagonal (or past the chunk) is -inf
            const bool live = q < qn && jp < p.Q && qp >= jp;
            const float x = live ? (da[qp] - da[jp]) * kLog2e : -INFINITY;
            const float w = sCB[q * kCBS + jp] * fast_exp2(x) * dtv[jp];
            split(live ? w : 0.f, hi[e], lo[e]);
          }
        },
        xh, xl);
    if (jt == nj - 1) {  // the head is done: write its rows
      float* yb = a.y + (static_cast<int64_t>(bc) * p.Q + q0) * y_row +
                  static_cast<int64_t>(h_first + hl) * P + p0;
      const int q = wq * 16 + g;
#pragma unroll
      for (int i = 0; i < PB / 8; ++i) {
        if (q < qn) {
          *reinterpret_cast<float2*>(yb + q * y_row + 8 * i + 2 * t) =
              make_float2(dh[4 * i] + dx[4 * i], dh[4 * i + 1] + dx[4 * i + 1]);
        }
        if (q + 8 < qn) {
          *reinterpret_cast<float2*>(yb + (q + 8) * y_row + 8 * i + 2 * t) =
              make_float2(dh[4 * i + 2] + dx[4 * i + 2],
                          dh[4 * i + 3] + dx[4 * i + 3]);
        }
      }
#pragma unroll
      for (int i = 0; i < PB / 2; ++i) dh[i] = dx[i] = 0.f;
    }
    wg_sync(wg);  // the planes are read before they are stored again
  }
}

template <int P, int N>
__device__ void state_block(const Args& a, int bc, int h_first, int nh,
                            int p0, float* smem) {
  constexpr int PB = P < kPB ? P : kPB;  // x columns of this block
  constexpr int BS = N + 8;  // B rows: A (n g, k t) walks 32 banks
  constexpr int MT = (N + 63) / 64;  // 64-row tiles of n
  const Shape& p = a.p;
  float* sW = smem;
  float* sB = sW + kSHeads * kMaxQ;
  float* planes = sB + kMaxQ * BS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nj = (p.Q + kTile - 1) / kTile;

  // the chunk's B once for every head, and each head's weights
  // exp(dA_cs[Q-1] - dA_cs[j]) dt_j (<= dt_j for a decaying chunk)
  load_rows(sB, BS, a.b + bc * p.b_sb + h_first * p.b_sh, p.b_sq, 0,
            nj * kTile, p.Q, N);
  cp_async_commit();
  for (int i = tid; i < nh * p.Q; i += kThreads) {
    const int j = i / nh, h = i % nh;
    const int64_t base = bc * p.da_sb + (h_first + h) * p.da_sh;
    const float seg = a.dacs[base + (p.Q - 1) * p.da_sq];
    sW[h * kMaxQ + j] = fast_exp2((seg - a.dacs[base + j * p.da_sq]) * kLog2e) *
                        a.dt[bc * p.dt_sb + j * p.dt_sq + (h_first + h) * p.dt_sh];
  }
  cp_async_wait<0>();
  __syncthreads();

  // per warpgroup: units u = wg, wg + 2, ... of (head, 64 rows of n), each
  // over every key tile: S^T (n x p) += B^T . (x * w), B^T built in
  // registers from the shared B, x * w in two planes
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wt = tid & 127, wq = (tid >> 5) & 3;
  float* xh = planes + wg * 2 * kTile * PB;
  float* xl = xh + kTile * PB;
  const int units = nh * MT;
  const int mine = wg < units ? (units - wg + 1) / 2 : 0;
  const int steps = mine * nj;
  auto load = [&](XRegs<PB>& r, int s) {
    const int h = h_first + (wg + 2 * (s / nj)) / MT, jt = s % nj;
    x_load<PB>(r, a.x + bc * p.x_sb + h * p.x_sh + p0, p.x_sq, jt * kTile,
               min(kTile, p.Q - jt * kTile), wt);
  };
  XRegs<PB> xr;
  if (steps > 0) load(xr, 0);
  float dh[PB / 2] = {}, dx[PB / 2] = {};
  for (int s = 0; s < steps; ++s) {
    const int u = wg + 2 * (s / nj), jt = s % nj;
    const int hl = u / MT, m = u % MT;
    x_store<PB>(xr, xh, xl, sW + hl * kMaxQ + jt * kTile,
                min(kTile, p.Q - jt * kTile), wt);
    fence_async_smem();
    wg_sync(wg);
    if (s + 1 < steps) load(xr, s + 1);
    wg_tile<PB>(
        dh, dx,
        [&](int ks, uint32_t* hi, uint32_t* lo) {  // B^T, rows n, keys j
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = m * 64 + wq * 16 + g + (e & 1) * 8;
            const int j = jt * kTile + ks * 8 + t + (e >> 1) * 4;
            const float v = sB[j * BS + min(n, N - 1)];
            split(n < N ? v : 0.f, hi[e], lo[e]);
          }
        },
        xh, xl);
    if (jt == nj - 1) {  // the unit is done: write S[p][n] of its rows
      float* sb = a.s + (static_cast<int64_t>(bc) * p.H + h_first + hl) * P * N +
                  static_cast<int64_t>(p0) * N;
      const int n = m * 64 + wq * 16 + g;
#pragma unroll
      for (int i = 0; i < PB / 8; ++i) {
        const int pp = 8 * i + 2 * t;
        if (n < N) {
          sb[pp * N + n] = dh[4 * i] + dx[4 * i];
          sb[(pp + 1) * N + n] = dh[4 * i + 1] + dx[4 * i + 1];
        }
        if (n + 8 < N) {
          sb[pp * N + n + 8] = dh[4 * i + 2] + dx[4 * i + 2];
          sb[(pp + 1) * N + n + 8] = dh[4 * i + 3] + dx[4 * i + 3];
        }
      }
#pragma unroll
      for (int i = 0; i < PB / 2; ++i) dh[i] = dx[i] = 0.f;
    }
    wg_sync(wg);  // the planes are read before they are stored again
  }
}

// One block per (chunk, q tile, head set, 64 columns of P) for y and per
// (chunk, head set, 64 columns of P) for the states.  Block order, the
// most work first: the y blocks of the last two q tiles (the most key
// tiles), then the state blocks, then the other q tiles' y blocks from
// the last down.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PB = P < kPB ? P : kPB;
  constexpr int NP = P / PB;  // column blocks
  const Shape& p = a.p;
  const int yg = (p.H + p.y_heads - 1) / p.y_heads;
  const int sg = (p.H + p.s_heads - 1) / p.s_heads;
  const int n_qt = (p.Q + kTile - 1) / kTile;
  const int ny = p.BC * yg * NP;  // y blocks of one q tile
  const int n_first = min(2, n_qt) * ny;  // y blocks ahead of the states
  const int n_state = p.BC * sg * NP;
  int idx = static_cast<int>(blockIdx.x);
  int qt;
  if (idx < n_first) {
    qt = n_qt - 1 - idx / ny;
  } else if (idx < n_first + n_state) {
    idx -= n_first;
    const int set = idx % (sg * NP) / NP;
    const int h_first = set * p.s_heads;
    state_block<P, N>(a, idx / (sg * NP), h_first,
                      min(p.s_heads, p.H - h_first), (idx % NP) * PB, smem);
    return;
  } else {
    idx -= n_first + n_state;
    qt = n_qt - 3 - idx / ny;
  }
  idx %= ny;
  const int set = idx % (yg * NP) / NP;
  const int h_first = set * p.y_heads;
  y_block<P, N>(a, idx / (yg * NP), qt, h_first, min(p.y_heads, p.H - h_first),
                (idx % NP) * PB, smem);
}

template <int P, int N>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<P, N>();
  static PerDevice configured;  // the opt-in, per device
  const cudaError_t e = configured.once(a.p.device, [&] {
    return cudaFuncSetAttribute(ssd_chunk_kernel<P, N>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
  });
  if (e != cudaSuccess) return e;
  ssd_chunk_kernel<P, N><<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const Args& a, int blocks, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(a, blocks, stream);
    case 32:
      return launch<P, 32>(a, blocks, stream);
    case 64:
      return launch<P, 64>(a, blocks, stream);
    case 128:
      return launch<P, 128>(a, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One call's sizes, strides and plan, built once per call signature by
// the wrapper (its ctypes structure `_Params` has this layout).
struct Params {
  Shape shape;
  int32_t blocks;  // the grid: BC * (ceil(Q/64) y sets + state sets x P/64)
  int32_t pad_;
};

static_assert(sizeof(Params) == 160 && offsetof(Params, blocks) == 152 &&
                  offsetof(Shape, device) == 120,
              "Params must match the wrapper's ctypes structure");

// y_diag and the chunk states of (BC, Q, H) f32 inputs, on `stream`, in
// one launch, without synchronising.  Strides in elements (the last dim of
// x, B and C contiguous; bases and strides 16-byte aligned; a head stride
// of 0 allowed); y and s are contiguous outputs.  1 <= Q <= 256, P and N
// in {16, 32, 64, 128}.  Returns a cudaError_t.
extern "C" int ssd_chunk_launch(const Params* p, const float* x,
                                const float* dt, const float* dacs,
                                const float* b, const float* c, float* y,
                                float* s, cudaStream_t stream) {
  const Shape& sh = p->shape;
  if (sh.BC <= 0 || sh.H <= 0) return cudaSuccess;
  if (sh.Q < 1 || sh.Q > kMaxQ || sh.device < 0 || sh.device >= kMaxDevices ||
      sh.y_heads < 1 || sh.y_heads > kYHeads || sh.s_heads < 1 ||
      sh.s_heads > kSHeads || p->blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const Args a{x, dt, dacs, b, c, y, s, sh};
  switch (sh.P) {
    case 16:
      return dispatch_n<16>(sh.N, a, p->blocks, stream);
    case 32:
      return dispatch_n<32>(sh.N, a, p->blocks, stream);
    case 64:
      return dispatch_n<64>(sh.N, a, p->blocks, stream);
    case 128:
      return dispatch_n<128>(sh.N, a, p->blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_chunk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
