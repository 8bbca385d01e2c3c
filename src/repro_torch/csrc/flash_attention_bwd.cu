// Flash attention backward on Hopper (sm_90a): dq, dk, dv of the forward
// in flash_attention.cu from q (B, Tq, H, D), k and v (B, Tk, Kv, D), the
// forward's output o and its per-row log-sum-exp `lse` (f32, (B, H, Tq)),
// and the output's gradient do, for causal or full attention with GQA, an
// optional softcap and sliding window, any Tq and Tk.  Head dims (q/k, v)
// square at 64, 128 and 256, or MLA's (192, 128) (deepseek-v2's 128 "nope"
// and 64 rotary columns of q and k against v's 128): every kernel but the
// dh-256 split ones is a template on the pair (DQK, DV), as the forward's
// are.  bf16, f16 and f32.
//
// Replaces the TPU side's jax.vjp of the XLA twin of the Pallas forward
// (repro/models/layers.py, chunked_attention): the reference has no Pallas
// kernel for the backward pass, and XLA differentiates the twin.
//
// The arithmetic, per (row i, key j) that i sees, with x = scale * q.k:
//   y  = softcap * tanh(x / softcap)   (y = x without a softcap)
//   P  = exp(y - lse_i)                 (recomputed, never stored)
//   dP = do_i . v_j
//   dy = P * (dP - D_i),  D_i = do_i . o_i
//   dx = dy * (1 - tanh^2)              (dx = dy without a softcap)
//   dq_i += scale * dx k_j,  dk_j += scale * dx q_i,  dv_j += P do_i
// with query head h reading kv head h / (H / Kv); dk and dv of a kv head
// sum over its H / Kv query heads.
//
// What bounds it: 5 products of 2 * D operations per (row, key) pair seen
// (Q.K^T, dO.V^T, P^T.dO, dS^T.Q, dS.K) against reading q, k, v, o, do once
// and writing dq, dk, dv: at training shapes the tensor cores' rate (the
// qwen2.5-3b step's B=1, T=4096, H=16, D=128, causal: 171.8 GFLOP, 0.174 ms
// at the bf16 peak, against 0.023 ms for its 76 MB).  Both routes run 7:
// the dq pass recomputes Q.K^T and dO.V^T rather than keep P or dS in
// memory (0.243 ms as run).
//
// Four launches a call, on one of two routes (the wrapper's plan names
// it, and the launch refuses a plan that disagrees with its own rule):
//   1. delta_kernel: D = rowsum(do * o) and lse * log2(e), one warp a row,
//      into f32 (B, H, Tp) buffers padded to Tp = Tq rounded up to 128
//      (pad rows: D = 0, lse = +inf, so their weights are 0).
//   2. dk/dv per (kv tile, batch, query head), in f32, into a per-query-
//      head slot: one block per kv tile (128 keys on the wgmma route)
//      keeps the tile's dk and dv in registers and walks the q tiles that
//      see it in order, the heaviest blocks (the first keys, under a
//      causal mask) first.  Per-query-head partials fill the card at the
//      training shape (32 kv tiles x 16 heads = 512 blocks); a block per
//      kv head walking its query heads would make 64 blocks for 132 SMs.
//   3. dq per (q tile, batch, head): the block keeps dq in registers and
//      walks the kv tiles the q tile sees, the last q tiles first.
//   4. reduce_kernel: dk, dv = the sum of the H / Kv per-head slots, in
//      head order, rounded to the input type.
// No atomics and no split whose order varies: the same inputs give the
// same bytes, which a training run resumed from a checkpoint relies on.
//
// * "wgmma" (bf16 / f16, (D, Dv) (64, 64), (128, 128), (192, 128) and (256,
//   256)): kernels 2 and 3 run on the tensor cores, fed by TMA, with the
//   forward's building blocks (hopper.h).  A block is two consumer
//   warpgroups of 64 resident rows each and one producer warpgroup
//   (setmaxnreg 24 / 240) whose first thread loads the resident tiles
//   once and streams 64-row tiles through a two-stage ring
//   (128-byte swizzle; one mbarrier per stage for its loads, one that
//   every consumer thread releases).  TMA reads rows past Tq or Tk as
//   zeros; a padded row's lse of +inf gives it P = 0.
//   - dk/dv (`dkdv_wgmma_kernel`): K and V resident, Q and dO streamed
//     with their rows' lse and D (a bulk copy each).  Per q tile,
//     S^T = K.Q^T and dP^T = V.dO^T are SS products with both operands
//     K-major as they lie in memory; P^T = exp2(S^T scale log2e - lse
//     log2e) (tanh first under a softcap; the causal and window masks
//     only on a tile that crosses them); dS^T = P^T (dP^T - D) (times 1 -
//     tanh^2 under a softcap); then dV += P^T.dO and dK += dS^T.Q are RS
//     products: P^T and dS^T rounded to the input type as A fragments
//     from registers, dO and Q read MN-major ("transposed"), so nothing is
//     copied transposed.  At D 128 dk and dv take 128 f32 registers a
//     consumer thread, S^T and dP^T 32 each.
//   - dq (`dq_wgmma_kernel`): Q and dO resident with their rows' lse and
//     D in registers, K and V streamed; S = Q.K^T and dP = dO.V^T as SS
//     products, dS in registers, dQ += dS.K an RS product with K MN-major.
//   - Each warpgroup skips the tiles no row of it sees (it still releases
//     them); the branches around wgmma are warpgroup-uniform.
//   - Against the bound: every product runs on the tensor cores from
//     operands as they lie in memory, P and dS never leave registers, and
//     the two consumer warpgroups of a block take turns on the tensor
//     cores while the other computes P and dS.  At the training shape the
//     four launches take about 1.8x the as-run bound on an H100 SXM at
//     700 W (PERF.md has the times by kernel).
//   - D 256 (`dkdv_wide_kernel`, `dq_wide_kernel`): the layout above
//     cannot hold it.  A warpgroup's dk and dv over 256 columns would take
//     256 f32 registers a thread, and 128 resident rows of two 256-wide
//     tiles plus two stages of two streamed ones need 256 KB of shared
//     memory.  So a block keeps 64 resident rows (K and V 64 KB; Q and dO
//     streamed, 128 KB) and splits the head dim between its consumer
//     warpgroups: each owns 128 columns of dk and dv (or of dq), 128
//     accumulator registers.  The two score products are split instead:
//     warpgroup 0 takes S^T = K.Q^T, warpgroup 1 dP^T = V.dO^T, each over
//     all 256 columns, at the same time.  Warpgroup 0 writes P^T to
//     shared memory in the input type (the 128-byte-swizzled K-major
//     layout TMA gives the other tiles) and hands P (1 - tanh^2) over in
//     f32 through a 16 KB exchange tile; warpgroup 1 makes dS^T there and
//     writes it beside P^T.  Both 64 x 64 tiles then feed dV += P^T.dO and
//     dK += dS^T.Q as shared-memory operands, each warpgroup over its own
//     columns of dO and Q (read MN-major).  Named barriers order the hand-
//     overs (P^T and the exchange tile written; dS^T written; each tile
//     read before it is written again).  The dq kernel is the same with Q
//     and dO resident: S and dP split, dS through shared memory, dQ += dS.K
//     split by columns.  Every q tile of a 64-key block's walk (and every
//     key tile of a q block's) has a row that sees a key, so none is
//     skipped; the causal and window masks act on the tiles that cross
//     them.  226 KB of shared memory, one block an SM.
//   - (192, 128), MLA: the dh-128 kernels instantiated at (192, 128),
//     162 KB of shared memory (q and k stream in three 128-byte column
//     chunks, v and do in two).  A dk/dv consumer holds dk (96 f32
//     registers) and dv (64); with S^T and dP^T (32 each) live together,
//     as the square kernels hold them, ptxas spills past setmaxnreg's 240.
//     So at q/k wider than v (`kLean`) the consumer never holds two f32
//     tiles: S^T, then P^T packed in the input type (16 registers: dV's A
//     fragments) while P (1 - tanh^2) stays f32, dV += P^T.dO, P (1 -
//     tanh^2) packed in its place, then dP^T, dS^T = P (1 - tanh^2) (dP^T
//     - D) from the packed value, dK += dS^T.Q.  The cost: P (1 - tanh^2)
//     is rounded to the input type before dS^T (the square kernels round
//     only dS^T), and dV's product no longer overlaps dP^T's within a
//     warpgroup.  dq holds 96 registers of dQ and needs no change.
// * "tf32x3" (f32 at every pair of head dims): kernels 2 and 3 on the
//   tensor cores in 3xTF32 (mma.sync m16n8k8, tf32.h): each f32 operand
//   split in registers into its TF32 high part and the TF32 cut of the
//   rest, lo.hi + hi.lo + hi.hi summed in f32, as the forward's f32 route
//   and the SSD kernels do.  wgmma takes TF32 only with its shared-memory
//   operands K-major: dV += P^T.dO, dK += dS^T.Q and dQ += dS.K sum over
//   the rows of dO, Q and K, which would need transposed copies, so this
//   route uses mma.sync, whose operands come from registers.
//   - dk/dv (`dkdv_tf32_kernel`): 4 warps of 16 keys a block (64 keys),
//     K and V resident, Q and dO streamed by cp.async with their rows'
//     lse2 and delta.  Keys are the M dimension: S^T = K.Q^T, P^T =
//     exp2(S^T scale log2e - lse2), dP^T = V.dO^T, dS^T = P^T (dP^T - D)
//     (times 1 - tanh^2 under a softcap), dV += P^T.dO, dK += dS^T.Q.  At
//     dh 64 and 128 two such groups take 32 rows each of every 64-row q
//     tile and sum their dk and dv at the end, which halves the first
//     keys' walk (at T=1024 every block is resident at once, so that
//     walk is the kernel).
//   - dq (`dq_tf32_kernel`): 4 warps of 16 rows (64 rows), Q and dO
//     resident with each lane's two rows' lse2 and delta in registers, K
//     and V streamed: S = Q.K^T, dP = dO.V^T, dS, dQ += dS.K; at dh 64
//     and 128 two groups take 32 keys each of every 64-key tile, summed
//     at the end.
//   - The score products read both operands by ldmatrix (rows along the
//     head dim, as they lie in memory).  The other three take P^T, dS^T or
//     dS from the accumulators as A fragments with no shuffle: the m16n8
//     accumulator holds columns 2t, 2t + 1 of its 8, the A fragment k
//     positions t, t + 4, so k position t stands for column 2t and t + 4
//     for 2t + 1, and the B operand (dO, Q or K) is read in that order,
//     rows 2t and 2t + 1.  No tile is transposed.
//   - Row strides of head dim + 4 floats (= 4 mod 32) keep every fragment
//     read on 32 banks; 16-byte cp.async where the bases and strides
//     allow, else 4-byte, so any layout with the head dim contiguous runs.
//   - At dh 256 and (192, 128) a dk/dv block is 8 warps: each key warp's
//     dk and dv are split between two warps by columns, each of which
//     makes S^T and dP^T whole (dk and dv at 256 would take 256 f32
//     registers a thread).  Tiles at each pair: `tf32_dispatch`.
//   - Against the bound (the TF32 peak, 495 TFLOP/s on an H100 SXM): 7
//     products a (row, key) pair, each run three times, so the as-run
//     bound is 3 x 7/5 of the 5 products' (PERF.md has the times).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.h"
#include "per_device.h"

namespace fa_bwd {

constexpr int kThreads = 256;  // delta_kernel: 8 warps, a row each
constexpr int kRowPad = 128;   // the delta / lse2 buffers' row padding

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;      // do, the output's gradient
  const float* lse;   // (B, H, Tq)
  float* delta;       // (B, H, Tp) scratch: rowsum(do * o), 0 past Tq
  float* lse2;        // (B, H, Tp) scratch: lse * log2(e), +inf past Tq
  float* dk_part;     // (B, H, Tk, D) scratch: dk per query head
  float* dv_part;     // (B, H, Tk, Dv) scratch: dv per query head
  void* dq;           // (B, Tq, H, D), contiguous
  void* dk;           // (B, Tk, Kv, D), contiguous
  void* dv;           // (B, Tk, Kv, Dv), contiguous
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int64_t g_sb, g_st, g_sh;
  int B, Tq, Tk, H, Kv;
  int D;   // head dim of q and k
  int Dv;  // head dim of v, o and do
  int Tp;  // Tq rounded up to kRowPad
  float scale;
  float softcap;  // <= 0: off
  int causal;
  int window;  // <= 0: none
  int vec;     // f32 route: q, k, v, do bases and strides 16-byte aligned
};

// -- 1. D = rowsum(do * o), lse * log2(e) ----------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args a) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.B) * a.H * a.Tp) return;
  const int t = static_cast<int>(row % a.Tp);  // warp-uniform
  const int64_t bh = row / a.Tp;
  const int h = static_cast<int>(bh % a.H);
  const int b = static_cast<int>(bh / a.H);
  float s = 0.f;
  if (t < a.Tq) {
    const T* o = static_cast<const T*>(a.o) + b * a.o_sb + t * a.o_st + h * a.o_sh;
    const T* g = static_cast<const T*>(a.g) + b * a.g_sb + t * a.g_st + h * a.g_sh;
    for (int d = lane; d < a.Dv; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    a.delta[row] = s;
    a.lse2[row] = t < a.Tq ? a.lse[bh * a.Tq + t] * kLog2e : INFINITY;
  }
}

// -- the f32 route ("tf32x3"): 3xTF32 on mma.sync ------------------------------

constexpr int kF32Rows = 64;  // keys of a dk/dv block, q rows of a dq block
                              // (4 warps of 16)

// Shared memory of dq_tf32_kernel, in floats: Q and dO resident (64 rows),
// then STAGES stages of a K and a V tile (KSPLIT * BK rows each).  Row
// strides are the head dims + 4 (= 4 mod 32), so that ldmatrix's eight
// rows and the key-order reads (rows 2t and 2t + 1, columns g) fall on
// distinct banks.
template <int DQK, int DV, int BK, int KSPLIT, int STAGES>
struct DqLayout {
  static constexpr int QS = DQK + 4, GS = DV + 4, KS = DQK + 4, VS = DV + 4;
  static constexpr int TK = KSPLIT * BK;  // keys a stage holds
  static constexpr int G = kF32Rows * QS;
  static constexpr int K = G + kF32Rows * GS;  // the first stage
  static constexpr int STAGE = TK * (KS + VS);
  static constexpr int BYTES = (K + STAGES * STAGE) * 4;
  static_assert(KSPLIT == 1 || 4 * 32 * DQK / 2 <= STAGES * STAGE,
                "the ring holds a group's dq");
};

// Shared memory of dkdv_tf32_kernel, in floats: K and V resident (64
// keys), then STAGES stages of a Q and a dO tile (KSPLIT * BQ rows each)
// with their rows' lse2 and delta.
template <int DQK, int DV, int BQ, int KSPLIT, int STAGES>
struct DkdvLayout {
  static constexpr int KS = DQK + 4, VS = DV + 4, QS = DQK + 4, GS = DV + 4;
  static constexpr int TQ = KSPLIT * BQ;          // q rows a stage holds
  static constexpr int V = kF32Rows * KS;
  static constexpr int Q = V + kF32Rows * VS;     // the first stage
  static constexpr int G = TQ * QS;               // within a stage
  static constexpr int ROWS = G + TQ * GS;        // lse2, then delta
  static constexpr int STAGE = ROWS + 2 * TQ;
  static constexpr int BYTES = (Q + STAGES * STAGE) * 4;
  static_assert(KSPLIT == 1 || 4 * 32 * (DQK + DV) / 2 <= STAGES * STAGE,
                "the ring holds a group's dk and dv");
};

// P and dS in place of the m16n8 accumulators s and dp, as `grads` makes
// them on the wgmma route: p = exp2(y log2e - lse2), ds = p (dp - delta)
// (times 1 - tanh^2 under a softcap); element (j, e)'s lse2 and delta from
// row_of(j, e).
template <int NJ, typename RowOf>
__device__ __forceinline__ void grads_tf32(float (&s)[1][NJ][4], float (&dp)[1][NJ][4],
                                           bool capped, float sl, float cap_in,
                                           float cap_out, RowOf row_of) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lse2, del;
      row_of(j, e, &lse2, &del);
      if (capped) {
        const float t = tanhf(s[0][j][e] * cap_in);
        const float p = ex2(fmaf(t, cap_out, -lse2));
        s[0][j][e] = p;
        dp[0][j][e] = p * (dp[0][j][e] - del) * (1.f - t * t);
      } else {
        const float p = ex2(fmaf(s[0][j][e], sl, -lse2));
        s[0][j][e] = p;
        dp[0][j][e] = p * (dp[0][j][e] - del);
      }
    }
}

// A warp's accumulators (N floats a lane) into `x` (shared memory all of
// whose loads are consumed), float4 by float4 at 32 float4s a step, and
// back added onto another warp's: the second group of warps stashes, and
// after a __syncthreads the first folds them into its own, in that order.
template <int N>
__device__ __forceinline__ void stash(const float (&acc)[N / 4][4], float* x, int w,
                                      int lane) {
  float4* p = reinterpret_cast<float4*>(x) + w * (N / 4) * 32 + lane;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    p[32 * j] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N / 4][4], const float* x, int w,
                                     int lane) {
  const float4* p = reinterpret_cast<const float4*>(x) + w * (N / 4) * 32 + lane;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 b = p[32 * j];
    acc[j][0] += b.x;
    acc[j][1] += b.y;
    acc[j][2] += b.z;
    acc[j][3] += b.w;
  }
}

// dk, dv per (64-key tile, batch, query head) into the query head's f32
// slots.  Warp w takes keys 16 (w % 4) .. + 16; with CS column groups,
// columns (w / 4) % CS of CS of dk and dv; with KSPLIT row groups, rows
// (w / 4 / CS) * BQ .. + BQ of each stage's KSPLIT * BQ.  Per q tile, in
// order: S^T = K.Q^T and dP^T = V.dO^T (K, V, Q and dO by ldmatrix; with
// CS 2 the two column groups of a key warp each make them whole), P^T and
// dS^T, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as A fragments
// in key order and dO and Q read by rows 2t, 2t + 1.  The row groups' dk
// and dv are summed at the end, the first's then the second's.  The first
// keys, which see the most rows under a causal mask, run first.
template <int DQK, int DV, int BQ, int CS, int KSPLIT, int STAGES>
__global__ void __launch_bounds__(128 * CS * KSPLIT) dkdv_tf32_kernel(const Args a) {
  using L = DkdvLayout<DQK, DV, BQ, KSPLIT, STAGES>;
  constexpr int NT = 128 * CS * KSPLIT;
  constexpr int NQ = BQ / 8;          // 8-row groups of a warp's rows
  constexpr int WK = DQK / CS;        // columns of dk a warp holds
  constexpr int WV = DV / CS;         // of dv
  constexpr int UNROLL = DQK + DV > 192 ? 1 : 2;  // registers: 0 spills
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp % 4, cg = (warp / 4) % CS, grp = warp / (4 * CS);
  const int BH = a.B * a.H;
  const int kt = static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int k0 = kt * kF32Rows;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* g = static_cast<const float*>(a.g) + b * a.g_sb + h * a.g_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* lse2 = a.lse2 + static_cast<int64_t>(bh) * a.Tp;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Tp;

  // the q tiles with a row that may see a key of [k0, k0 + 64)
  const int n_qt = (a.Tq + L::TQ - 1) / L::TQ;
  const int qt_begin = a.causal ? min(n_qt, k0 / L::TQ) : 0;
  int qt_end = n_qt;
  if (a.window > 0) qt_end = min(n_qt, (k0 + kF32Rows - 2 + a.window) / L::TQ + 1);
  const int n_it = max(0, qt_end - qt_begin);

  load_tile_async<DQK, kF32Rows, NT>(sm, L::KS, k, a.k_st, k0, a.Tk, a.vec);
  load_tile_async<DV, kF32Rows, NT>(sm + L::V, L::VS, v, a.v_st, k0, a.Tk, a.vec);
  // a stage: Q and dO rows, and the rows' lse2 and delta (padded to Tp, a
  // multiple of TQ: past Tq lse2 +inf and delta 0, so P = dS = 0 there)
  auto load_q = [&](int it) {
    float* st = sm + L::Q + (it % STAGES) * L::STAGE;
    const int q0 = (qt_begin + it) * L::TQ;
    load_tile_async<DQK, L::TQ, NT>(st, L::QS, q, a.q_st, q0, a.Tq, a.vec);
    load_tile_async<DV, L::TQ, NT>(st + L::G, L::GS, g, a.g_st, q0, a.Tq, a.vec);
    const int i = static_cast<int>(threadIdx.x);
    if (i < L::TQ / 4)
      cp_async16(smem_addr(st + L::ROWS + 4 * i), lse2 + q0 + 4 * i, 16);
    else if (i < L::TQ / 2)
      cp_async16(smem_addr(st + L::ROWS + L::TQ + 4 * (i - L::TQ / 4)),
                 delta + q0 + 4 * (i - L::TQ / 4), 16);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_q(s);
    cp_async_commit();
  }

  // warp kw owns keys [ka, ka + 16): a lane holds keys key0 and key1, and
  // q rows 8 j + col + {0, 1} of each 8-row group j of its group's rows
  const int ka = k0 + 16 * kw;
  const int key0 = ka + lane / 4;
  const int key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  const float sl = a.scale * kLog2e;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const float* sK = sm + 16 * kw * L::KS;
  const float* sV = sm + L::V + 16 * kw * L::VS;

  float dk[WK / 8][4], dv[WV / 8][4];
#pragma unroll
  for (int j = 0; j < WK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < WV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + STAGES - 1 < n_it) load_q(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile it (and K, V) landed
    __syncthreads();
    const int q0 = (qt_begin + it) * L::TQ + grp * BQ;  // this group's rows
    // rows none of which sees a key of this warp's (warp-uniform)
    const bool dead = ka >= a.Tk || (a.causal && q0 + BQ - 1 < ka) ||
                      (a.window > 0 && q0 - (ka + 15) >= a.window);
    if (!dead) {
      const float* st = sm + L::Q + (it % STAGES) * L::STAGE;
      const float* sQ = st + grp * BQ * L::QS;
      const float* sG = st + L::G + grp * BQ * L::GS;
      const float* lse_s = st + L::ROWS + grp * BQ;
      const float* del_s = lse_s + L::TQ;
      float s[1][NQ][4], dp[1][NQ][4];
      zero(s);
      zero(dp);
      mma3<1, NQ, DQK, UNROLL>(s, KRows{sK, L::KS}, KRows{sQ, L::QS});
      mma3<1, NQ, DV, UNROLL>(dp, KRows{sV, L::VS}, KRows{sG, L::GS});
      // element (j, e): key (e & 2 ? key1 : key0), q row q0 + 8 j + col + (e & 1)
      grads_tf32(s, dp, capped, sl, cap_in, cap_out, [&](int j, int e, float* l, float* d_) {
        const int c = 8 * j + col + (e & 1);
        *l = lse_s[c];
        *d_ = del_s[c];
      });
      const bool edge = (a.causal && ka + 15 > q0) ||
                        (a.window > 0 && q0 + BQ - 1 - ka >= a.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = (e & 2) ? key1 : key0;
            const int row = q0 + 8 * j + col + (e & 1);
            bool live = true;
            if (a.causal) live = row >= key;
            if (a.window > 0) live = live && row - key < a.window;
            if (!live) s[0][j][e] = dp[0][j][e] = 0.f;
          }
      }
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t pa[4], da[4];
        acc_as_a(s[0][kk], pa);
        mma3_pairs<WV / 8>(dv, pa, sG + 8 * kk * L::GS + cg * WV, L::GS);
        acc_as_a(dp[0][kk], da);
        mma3_pairs<WK / 8>(dk, da, sQ + 8 * kk * L::QS + cg * WK, L::QS);
      }
    }
    __syncthreads();  // the stage is read before it is loaded again
  }

  if (KSPLIT == 2) {  // the row groups' sums, the first's then the second's
    float* xk = sm + L::Q;
    float* xv = xk + 4 * CS * 32 * WK / 2;
    const int w = warp % (4 * CS);
    if (grp == 1) {
      stash<WK / 2>(dk, xk, w, lane);
      stash<WV / 2>(dv, xv, w, lane);
    }
    __syncthreads();
    if (grp == 1) return;
    fold<WK / 2>(dk, xk, w, lane);
    fold<WV / 2>(dv, xv, w, lane);
  }
  float* dkp = a.dk_part + static_cast<int64_t>(bh) * a.Tk * DQK + cg * WK + col;
  float* dvp = a.dv_part + static_cast<int64_t>(bh) * a.Tk * DV + cg * WV + col;
#pragma unroll
  for (int j = 0; j < WK / 8; ++j) {
    if (key0 < a.Tk)
      *reinterpret_cast<float2*>(dkp + static_cast<int64_t>(key0) * DQK + 8 * j) =
          make_float2(dk[j][0] * a.scale, dk[j][1] * a.scale);
    if (key1 < a.Tk)
      *reinterpret_cast<float2*>(dkp + static_cast<int64_t>(key1) * DQK + 8 * j) =
          make_float2(dk[j][2] * a.scale, dk[j][3] * a.scale);
  }
#pragma unroll
  for (int j = 0; j < WV / 8; ++j) {
    if (key0 < a.Tk)
      *reinterpret_cast<float2*>(dvp + static_cast<int64_t>(key0) * DV + 8 * j) =
          make_float2(dv[j][0], dv[j][1]);
    if (key1 < a.Tk)
      *reinterpret_cast<float2*>(dvp + static_cast<int64_t>(key1) * DV + 8 * j) =
          make_float2(dv[j][2], dv[j][3]);
  }
}

// dq per (64-row q tile, batch, head).  Warp w takes rows 16 (w % 4) .. +
// 16 and, with KSPLIT key groups, keys (w / 4) * BK .. + BK of each stage's
// KSPLIT * BK; per kv tile: S = Q.K^T and dP = dO.V^T (by ldmatrix), dS,
// then dQ += dS.K with dS as A fragments in key order and K read by rows
// 2t, 2t + 1.  The key groups' dq are summed at the end, the first's then
// the second's.  Under a causal mask the last q tiles, which see the most
// keys, run first.
template <int DQK, int DV, int BK, int KSPLIT, int STAGES>
__global__ void __launch_bounds__(128 * KSPLIT) dq_tf32_kernel(const Args a) {
  using L = DqLayout<DQK, DV, BK, KSPLIT, STAGES>;
  constexpr int NT = 128 * KSPLIT;
  constexpr int NK = BK / 8;  // 8-key groups of a warp's keys
  constexpr int UNROLL = DQK > 128 ? 1 : 2;  // registers: 0 spills
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % 4, grp = warp / 4;
  const int BH = a.B * a.H;
  const int n_qt = (a.Tq + kF32Rows - 1) / kF32Rows;
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) / BH
                          : static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = qt * kF32Rows;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* g = static_cast<const float*>(a.g) + b * a.g_sb + h * a.g_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the kv tiles with a key that a row of [q0, q0 + 64) sees
  const int n_kt = (a.Tk + L::TK - 1) / L::TK;
  int kt_end = n_kt;
  if (a.causal) kt_end = min(n_kt, (q0 + kF32Rows - 1) / L::TK + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / L::TK : 0;
  const int n_it = max(0, kt_end - kt_begin);

  load_tile_async<DQK, kF32Rows, NT>(sm, L::QS, q, a.q_st, q0, a.Tq, a.vec);
  load_tile_async<DV, kF32Rows, NT>(sm + L::G, L::GS, g, a.g_st, q0, a.Tq, a.vec);
  auto load_kv = [&](int it) {
    float* st = sm + L::K + (it % STAGES) * L::STAGE;
    const int k0 = (kt_begin + it) * L::TK;
    load_tile_async<DQK, L::TK, NT>(st, L::KS, k, a.k_st, k0, a.Tk, a.vec);
    load_tile_async<DV, L::TK, NT>(st + L::TK * L::KS, L::VS, v, a.v_st, k0, a.Tk,
                                   a.vec);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_kv(s);
    cp_async_commit();
  }

  // warp rw owns rows [qa, qa + 16): a lane holds rows row0 and row1
  // (their lse2 and delta in registers: the buffers are padded to Tp, past
  // Tq +inf and 0), keys 8 j + col + {0, 1} of each 8-key group j
  const int qa = q0 + 16 * rw;
  const int qb = qa + 15;
  const int row0 = qa + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const float* lse2 = a.lse2 + static_cast<int64_t>(bh) * a.Tp;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Tp;
  const float lse0 = lse2[row0], lse1 = lse2[row1];
  const float del0 = delta[row0], del1 = delta[row1];
  const bool capped = a.softcap > 0.f;
  const float sl = a.scale * kLog2e;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const float* sQ = sm + 16 * rw * L::QS;
  const float* sG = sm + L::G + 16 * rw * L::GS;

  float dq[DQK / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + STAGES - 1 < n_it) load_kv(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile it (and Q, dO) landed
    __syncthreads();
    const int k0 = (kt_begin + it) * L::TK + grp * BK;  // this group's keys
    const bool dead = (a.causal && k0 > qb) ||
                      (a.window > 0 && qa - (k0 + BK - 1) >= a.window);
    if (!dead) {
      const float* sK = sm + L::K + (it % STAGES) * L::STAGE + grp * BK * L::KS;
      const float* sV = sm + L::K + (it % STAGES) * L::STAGE + L::TK * L::KS +
                        grp * BK * L::VS;
      float s[1][NK][4], dp[1][NK][4];
      zero(s);
      zero(dp);
      mma3<1, NK, DQK, UNROLL>(s, KRows{sQ, L::QS}, KRows{sK, L::KS});
      mma3<1, NK, DV, UNROLL>(dp, KRows{sG, L::GS}, KRows{sV, L::VS});
      grads_tf32(s, dp, capped, sl, cap_in, cap_out, [&](int, int e, float* l, float* d_) {
        *l = (e & 2) ? lse1 : lse0;
        *d_ = (e & 2) ? del1 : del0;
      });
      const bool edge = k0 + BK > a.Tk || (a.causal && k0 + BK - 1 > qa) ||
                        (a.window > 0 && qb - k0 >= a.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e & 2) ? row1 : row0;
            const int key = k0 + 8 * j + col + (e & 1);
            bool live = key < a.Tk;
            if (a.causal) live = live && row >= key;
            if (a.window > 0) live = live && row - key < a.window;
            if (!live) dp[0][j][e] = 0.f;
          }
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t da[4];
        acc_as_a(dp[0][kk], da);
        mma3_pairs<DQK / 8>(dq, da, sK + 8 * kk * L::KS, L::KS);
      }
    }
    __syncthreads();  // the stage is read before it is loaded again
  }

  if (KSPLIT == 2) {  // the key groups' sums, the first's then the second's
    if (grp == 1) stash<DQK / 2>(dq, sm + L::K, rw, lane);
    __syncthreads();
    if (grp == 1) return;
    fold<DQK / 2>(dq, sm + L::K, rw, lane);
  }
  float* out = static_cast<float*>(a.dq) + col;
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j) {
    if (row0 < a.Tq)
      *reinterpret_cast<float2*>(
          out + ((static_cast<int64_t>(b) * a.Tq + row0) * a.H + h) * DQK + 8 * j) =
          make_float2(dq[j][0] * a.scale, dq[j][1] * a.scale);
    if (row1 < a.Tq)
      *reinterpret_cast<float2*>(
          out + ((static_cast<int64_t>(b) * a.Tq + row1) * a.H + h) * DQK + 8 * j) =
          make_float2(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
}

// -- both routes: dk, dv = the sum over a kv head's query heads ---------------

constexpr int kReduceThreads = 256;

// Four f32 values rounded to T into 4 consecutive outputs (16-byte or
// 8-byte aligned: every head dim is a multiple of 4).
template <typename T>
__device__ __forceinline__ void store4(T* out, float4 v) {
  float r0, r1;
  uint2 u;
  u.x = pack2<T>(v.x, v.y, &r0, &r1);
  u.y = pack2<T>(v.z, v.w, &r0, &r1);
  *reinterpret_cast<uint2*>(out) = u;
}
template <>
__device__ __forceinline__ void store4<float>(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

// Rows (batch, key, kv head) of dk (blockIdx.y 0) or dv (1), several to
// a block, a thread to four columns: each column the sum of the row's
// H / Kv query heads' f32 slots of `dk_part` / `dv_part` ((B, H, Tk, W)),
// in head order (the same sum every call), rounded to T into the (B, Tk,
// Kv, W) output.  A block holds kReduceThreads / (max(D, Dv) / 4) rows.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) reduce_kernel(const Args a) {
  const bool is_v = blockIdx.y != 0;
  const int W = is_v ? a.Dv : a.D;
  const int W4 = W / 4;
  const int rows = kReduceThreads / (max(a.D, a.Dv) / 4);
  const int local = static_cast<int>(threadIdx.x) / W4;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows + local;  // (b Tk + t) Kv + kvh
  if (local >= rows || row >= static_cast<int64_t>(a.B) * a.Tk * a.Kv) return;
  const int d4 = static_cast<int>(threadIdx.x) - local * W4;
  const int kvh = static_cast<int>(row % a.Kv);
  const int64_t bt = row / a.Kv;
  const int t = static_cast<int>(bt % a.Tk);
  const int b = static_cast<int>(bt / a.Tk);
  const int rep = a.H / a.Kv;
  const float* part = is_v ? a.dv_part : a.dk_part;
  const float4* src = reinterpret_cast<const float4*>(
                          part + ((static_cast<int64_t>(b) * a.H + kvh * rep) * a.Tk + t) * W) +
                      d4;
  const int64_t head_stride = static_cast<int64_t>(a.Tk) * W4;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < rep; ++r) {
    const float4 v = src[r * head_stride];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  store4<T>(static_cast<T*>(is_v ? a.dv : a.dk) + row * W + 4 * d4, sum);
}

// -- the wgmma route: tiles --------------------------------------------------

constexpr int kNC = 2;      // consumer warpgroups a block
constexpr int kStages = 2;  // the streamed tiles' ring depth

// Shared memory of a tensor-core block, templated on the head dims of q/k
// (DQK) and v/do (DV): two resident tiles of 128 rows (dk/dv: K and V;
// dq: Q and dO), the rings of two streamed tiles of 64 rows (dk/dv: Q and
// dO; dq: K and V), each stage's 64 rows of lse2 and delta (read by dk/dv
// only), then the mbarriers (resident tiles loaded; per stage "full" and
// "empty").  In both kernels tensor 0 of a pair has DQK columns and
// tensor 1 DV; each tile is stored as column chunks of (rows x 128 bytes).
template <int DQK, int DV>
struct TcLayout {
  static constexpr int BR = 64 * kNC;  // resident rows: 64 a consumer
  static constexpr int THREADS = (kNC + 1) * 128;  // + the producer
  static constexpr int HALF_BYTES = 64 * (DQK + DV) * 2;  // 64 rows of both
  static constexpr int ST0_BYTES = 64 * DQK * 2;          // one streamed tile
  static constexpr int ST1_BYTES = 64 * DV * 2;
  static constexpr int RES0 = 0;
  static constexpr int RES1 = RES0 + BR * DQK * 2;
  static constexpr int ST0 = RES1 + BR * DV * 2;
  static constexpr int ST1 = ST0 + kStages * ST0_BYTES;
  static constexpr int ROWS = ST1 + kStages * ST1_BYTES;
  static constexpr int ROW_BYTES = 2 * 64 * 4;  // lse2 then delta
  static constexpr int BAR = ROWS + kStages * ROW_BYTES;
  // + slack to align the dynamic base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR + 8 * (1 + 2 * kStages) + 1024;
};

// A tensor-core block's mbarriers, initialised by its first thread.
struct Bars {
  uint32_t res_full, full, empty;  // full and empty: + 8 * stage
};

template <typename L>
__device__ __forceinline__ Bars init_bars(uint32_t base) {
  const Bars bars{base + L::BAR, base + L::BAR + 8, base + L::BAR + 8 + 8 * kStages};
  if (threadIdx.x == 0) {
    mbar_init(bars.res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full + 8 * s, 1);
      mbar_init(bars.empty + 8 * s, kNC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here
  return bars;
}

// Rows [r0, r0 + 64) of one head of a tensor of D columns into a chunked
// tile whose chunks hold `chunk_rows` rows, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, int chunk_rows,
                                          const CUtensorMap* map, uint32_t bar,
                                          int head, int r0, int b) {
  for (int c = 0; c < D / kChunk; ++c)
    tma_load(dst + c * chunk_rows * kRowBytes, map, bar, c * kChunk, head, r0, b);
}

// The producer thread's resident load: rows [r0, r0 + 64 * halves) of
// tensors 0 and 1 (one head) into the resident tiles, on res_full.
template <typename L, int DQK, int DV>
__device__ __forceinline__ void load_resident(uint32_t base, const Bars& bars,
                                              const CUtensorMap* m0,
                                              const CUtensorMap* m1, int head,
                                              int r0, int halves, int b) {
  mbar_expect_tx(bars.res_full, halves * L::HALF_BYTES);
  for (int half = 0; half < halves; ++half) {
    const uint32_t at = half * 64 * kRowBytes;
    load_rows<DQK>(base + L::RES0 + at, L::BR, m0, bars.res_full, head,
                   r0 + 64 * half, b);
    load_rows<DV>(base + L::RES1 + at, L::BR, m1, bars.res_full, head,
                  r0 + 64 * half, b);
  }
}

// The producer thread's streamed load of tile `it` (rows r0 .. r0 + 64 of
// tensors 0 and 1) into its stage, after the stage's last use is released.
template <typename L, int DQK, int DV>
__device__ __forceinline__ void load_stream(uint32_t base, const Bars& bars, int it,
                                            const CUtensorMap* m0,
                                            const CUtensorMap* m1, int head,
                                            int r0, int b, int extra_bytes) {
  const int s = it % kStages;
  if (it >= kStages) mbar_wait(bars.empty + 8 * s, ((it / kStages) - 1) & 1);
  const uint32_t bar = bars.full + 8 * s;
  mbar_expect_tx(bar, L::HALF_BYTES + extra_bytes);
  load_rows<DQK>(base + L::ST0 + s * L::ST0_BYTES, 64, m0, bar, head, r0, b);
  load_rows<DV>(base + L::ST1 + s * L::ST1_BYTES, 64, m1, bar, head, r0, b);
}

// s = A0.B0^T over DQK columns and dp = A1.B1^T over DV (64 x 64 each,
// f32): A rows of a resident tile (this warpgroup's 64 of 128), B a
// streamed tile of 64 rows, both K-major.
template <typename T, int DQK, int DV>
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32],
                                             uint32_t a0, uint32_t a1, uint32_t b0,
                                             uint32_t b1) {
  constexpr int BR = TcLayout<DQK, DV>::BR;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    wgmma_ss<T>(s, kmajor_desc(a0, BR, kk), kmajor_desc(b0, 64, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    wgmma_ss<T>(dp, kmajor_desc(a1, BR, kk), kmajor_desc(b1, 64, kk), kk > 0);
  wg_commit();
}

// acc[j] += A . B for the 64 columns of chunk j of N: A the packed 64 x 64
// fragments, B a streamed tile of 64 rows and N columns read MN-major.
template <typename T, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N / kChunk][32],
                                         const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < N / kChunk; ++j) wgmma_rs<T>(acc[j], a[kk], mnmajor_desc(b, kk, j));
}

// P and dS in place of the scores s and dp: p = exp2(y log2e - lse2),
// ds = p (dp - delta) (times 1 - tanh^2 under a softcap).  Element i's
// lse2 and delta come from `row_of(i)`.  Each variant is a loop under a
// uniform branch, so that no tile pays for tanh unless it needs it.
template <typename RowOf>
__device__ __forceinline__ void grads(float (&s)[32], float (&dp)[32], bool capped,
                                      float sl, float cap_in, float cap_out,
                                      RowOf row_of) {
  if (capped) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float lse2, del;
      row_of(i, &lse2, &del);
      const float t = tanhf(s[i] * cap_in);
      const float p = ex2(fmaf(t, cap_out, -lse2));
      s[i] = p;
      dp[i] = p * (dp[i] - del) * (1.f - t * t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float lse2, del;
      row_of(i, &lse2, &del);
      const float p = ex2(fmaf(s[i], sl, -lse2));
      s[i] = p;
      dp[i] = p * (dp[i] - del);
    }
  }
}

// The accumulator of keys key0 and key1 (64 x 64 CH, f32) times `mul`
// into the first 64 CH floats of rows STRIDE floats apart of `out`, keys
// past Tk skipped.
template <int CH, int STRIDE>
__device__ __forceinline__ void store_keys(float* out, const float (&acc)[CH][32],
                                           int key0, int key1, int col, int Tk,
                                           float mul) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = kChunk * j + 8 * g + col;
      if (key0 < Tk)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(key0) * STRIDE + c) =
            make_float2(acc[j][4 * g] * mul, acc[j][4 * g + 1] * mul);
      if (key1 < Tk)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(key1) * STRIDE + c) =
            make_float2(acc[j][4 * g + 2] * mul, acc[j][4 * g + 3] * mul);
    }
  }
}

// The two values pack2 packed, back in f32.
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t u, float* x0, float* x1);
template <>
__device__ __forceinline__ void unpack2<__nv_bfloat16>(uint32_t u, float* x0, float* x1) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u);
  *x0 = __low2float(h);
  *x1 = __high2float(h);
}
template <>
__device__ __forceinline__ void unpack2<__half>(uint32_t u, float* x0, float* x1) {
  const __half2 h = *reinterpret_cast<const __half2*>(&u);
  *x0 = __low2float(h);
  *x1 = __high2float(h);
}

// -- the wgmma route: dk, dv per (128-key tile, batch, query head) ------------

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(TcLayout<DQK, DV>::THREADS, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap gmap, const Args a) {
  using L = TcLayout<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows_smem = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::ROWS);

  const int BH = a.B * a.H;
  const int kt = static_cast<int>(blockIdx.x) / BH;  // under a causal mask the
  const int bh = static_cast<int>(blockIdx.x) % BH;  // first keys see the most rows
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int k0 = kt * L::BR;
  // the 64-row q tiles with a row that may see a key of [k0, k0 + 128)
  const int n_qt = (a.Tq + 63) / 64;
  const int qt_begin = a.causal ? min(n_qt, k0 / 64) : 0;
  int qt_end = n_qt;
  if (a.window > 0) qt_end = min(n_qt, (k0 + L::BR - 2 + a.window) / 64 + 1);
  const int n_it = max(0, qt_end - qt_begin);
  const bool two = k0 + 64 < a.Tk;  // the second warpgroup has keys

  const Bars bars = init_bars<L>(base);
  const int wg = warpgroup();
  if (wg == kNC) {
    producer_regs<kNC>();
    if (threadIdx.x == kNC * 128) {
      load_resident<L, DQK, DV>(base, bars, &kmap, &vmap, kvh, k0, two ? 2 : 1, b);
      const float* lse2 = a.lse2 + static_cast<int64_t>(bh) * a.Tp;
      const float* delta = a.delta + static_cast<int64_t>(bh) * a.Tp;
      for (int it = 0; it < n_it; ++it) {
        const int q0 = (qt_begin + it) * 64;
        load_stream<L, DQK, DV>(base, bars, it, &qmap, &gmap, h, q0, b, L::ROW_BYTES);
        const uint32_t rows = base + L::ROWS + (it % kStages) * L::ROW_BYTES;
        const uint32_t bar = bars.full + 8 * (it % kStages);
        bulk_load(rows, lse2 + q0, 64 * 4, bar);
        bulk_load(rows + 64 * 4, delta + q0, 64 * 4, bar);
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns keys [ka, ka + 64); in the accumulator
  // layout a thread holds keys key0 and key0 + 8, and q rows 8 g + col +
  // {0, 1} of each streamed tile's 8-row group g
  consumer_regs<kNC>();
  const int ka = k0 + 64 * wg;
  const bool keys = ka < a.Tk;  // warpgroup-uniform
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int key0 = ka + 16 * warp + lane / 4;
  const int key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  const float sl = a.scale * kLog2e;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const uint32_t k_wg = base + L::RES0 + wg * 64 * kRowBytes;
  const uint32_t v_wg = base + L::RES1 + wg * 64 * kRowBytes;

  float dk[DQK / kChunk][32], dv[DV / kChunk][32];
#pragma unroll
  for (int j = 0; j < DQK / kChunk; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / kChunk; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[j][i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
  // q/k wider than v (MLA's (192, 128)): the order that holds fewer
  // registers at once (`kLean` below)
  constexpr bool kLean = DQK > DV;

  mbar_wait(bars.res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int q0 = (qt_begin + it) * 64;
    mbar_wait(bars.full + 8 * st, (it / kStages) & 1);
    const bool dead = !keys || (a.causal && q0 + 63 < ka) ||
                      (a.window > 0 && q0 - (ka + 63) >= a.window);
    if (!dead) {
      if constexpr (kLean) {
        // (192, 128): S^T; P^T packed in the input type (dv's A fragments)
        // and P (1 - tanh^2) kept in f32; dV += P^T.dO; P (1 - tanh^2)
        // packed in its place; dP^T; dS^T from the packed values; dK +=
        // dS^T.Q.  One f32 tile and two packed ones at most beside dk and dv.
        const uint32_t qs = base + L::ST0 + st * L::ST0_BYTES;
        const uint32_t gs = base + L::ST1 + st * L::ST1_BYTES;
        const float* lse_s = rows_smem + st * (L::ROW_BYTES / 4);
        const float* del_s = lse_s + 64;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk)
          wgmma_ss<T>(s, kmajor_desc(k_wg, L::BR, kk), kmajor_desc(qs, 64, kk), kk > 0);
        wg_commit();
        wg_wait<0>();
        const bool edge = (a.causal && ka + 63 > q0) ||
                          (a.window > 0 && q0 + 63 - ka >= a.window);
        // elements i, i + 1 (i = 8 kk + 2 r): key (r & 1 ? key1 : key0), q
        // rows q0 + c and q0 + c + 1, c = 8 (i / 4) + col
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r;
            const int c = 8 * (i / 4) + col;
            const int key = (r & 1) ? key1 : key0;
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float pc;
              if (capped) {
                const float t = tanhf(s[i + e] * cap_in);
                p[e] = ex2(fmaf(t, cap_out, -lse_s[c + e]));
                pc = p[e] * (1.f - t * t);
              } else {
                p[e] = ex2(fmaf(s[i + e], sl, -lse_s[c + e]));
                pc = p[e];
              }
              if (edge) {
                const int row = q0 + c + e;
                bool live = true;
                if (a.causal) live = row >= key;
                if (a.window > 0) live = live && row - key < a.window;
                if (!live) p[e] = pc = 0.f;
              }
              s[i + e] = pc;
            }
            float r0, r1;
            pa[kk][r] = pack2<T>(p[0], p[1], &r0, &r1);
          }
        }
        wg_fence();
        issue_rs<T, DV>(dv, pa, gs);
        wg_commit();
        wg_wait<0>();
        if (capped) {
          float unused0, unused1;
          pack_a<T>(s, pa, &unused0, &unused1);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss<T>(dp, kmajor_desc(v_wg, L::BR, kk), kmajor_desc(gs, 64, kk), kk > 0);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r;
            const int c = 8 * (i / 4) + col;
            float x0, x1, r0, r1;
            unpack2<T>(pa[kk][r], &x0, &x1);
            da[kk][r] = pack2<T>(x0 * (dp[i] - del_s[c]), x1 * (dp[i + 1] - del_s[c + 1]),
                                 &r0, &r1);
          }
        }
        wg_fence();
        issue_rs<T, DQK>(dk, da, qs);
        wg_commit();
        wg_wait<0>();
      } else {
        const uint32_t qs = base + L::ST0 + st * L::ST0_BYTES;
        const uint32_t gs = base + L::ST1 + st * L::ST1_BYTES;
        issue_scores<T, DQK, DV>(s, dp, k_wg, v_wg, qs, gs);
        wg_wait<0>();
        // element i: key (i & 2 ? key1 : key0), q row q0 + 8 (i / 4) + col + (i & 1)
        const float* lse_s = rows_smem + st * (L::ROW_BYTES / 4);
        const float* del_s = lse_s + 64;
        grads(s, dp, capped, sl, cap_in, cap_out, [&](int i, float* l, float* d_) {
          const int c = 8 * (i / 4) + col + (i & 1);
          *l = lse_s[c];
          *d_ = del_s[c];
        });
        const bool edge = (a.causal && ka + 63 > q0) ||
                          (a.window > 0 && q0 + 63 - ka >= a.window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = (i & 2) ? key1 : key0;
            const int row = q0 + 8 * (i / 4) + col + (i & 1);
            bool live = true;
            if (a.causal) live = row >= key;
            if (a.window > 0) live = live && row - key < a.window;
            if (!live) s[i] = dp[i] = 0.f;
          }
        }
        float unused0, unused1;
        pack_a<T>(s, pa, &unused0, &unused1);
        pack_a<T>(dp, da, &unused0, &unused1);
        wg_fence();
        issue_rs<T, DV>(dv, pa, gs);
        issue_rs<T, DQK>(dk, da, qs);
        wg_commit();
        wg_wait<0>();
      }
    }
    mbar_arrive(bars.empty + 8 * st);
  }
  if (!keys) return;

  // this query head's f32 slots: dk (times scale) and dv of the tile's keys
  float* dkp = a.dk_part + static_cast<int64_t>(bh) * a.Tk * DQK;
  float* dvp = a.dv_part + static_cast<int64_t>(bh) * a.Tk * DV;
  store_keys<DQK / kChunk, DQK>(dkp, dk, key0, key1, col, a.Tk, a.scale);
  store_keys<DV / kChunk, DV>(dvp, dv, key0, key1, col, a.Tk, 1.f);
}

// -- the wgmma route: dq per (128-row q tile, batch, head) --------------------

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(TcLayout<DQK, DV>::THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap gmap, const Args a) {
  using L = TcLayout<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int BH = a.B * a.H;
  const int n_qb = (a.Tq + L::BR - 1) / L::BR;
  // causal: the last q tiles see the most kv tiles, so they run first
  const int qb = a.causal ? n_qb - 1 - static_cast<int>(blockIdx.x) / BH
                          : static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = qb * L::BR;
  // the 64-key tiles with a key that a row of [q0, q0 + 128) may see
  const int n_kt = (a.Tk + 63) / 64;
  const int kt_end = a.causal ? min(n_kt, (q0 + L::BR - 1) / 64 + 1) : n_kt;
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / 64 : 0;
  const int n_it = max(0, kt_end - kt_begin);
  const bool two = q0 + 64 < a.Tq;  // the second warpgroup has rows

  const Bars bars = init_bars<L>(base);
  const int wg = warpgroup();
  if (wg == kNC) {
    producer_regs<kNC>();
    if (threadIdx.x == kNC * 128) {
      load_resident<L, DQK, DV>(base, bars, &qmap, &gmap, h, q0, two ? 2 : 1, b);
      for (int it = 0; it < n_it; ++it)
        load_stream<L, DQK, DV>(base, bars, it, &kmap, &vmap, kvh,
                                (kt_begin + it) * 64, b, 0);
    }
    return;
  }

  // consumer warpgroup `wg` owns q rows [qa, qa + 64): a thread holds rows
  // row0 and row0 + 8, and keys 8 g + col + {0, 1} of each 8-key group g
  consumer_regs<kNC>();
  const int qa = q0 + 64 * wg;
  const bool rows = qa < a.Tq;  // warpgroup-uniform
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = qa + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  const float sl = a.scale * kLog2e;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const uint32_t q_wg = base + L::RES0 + wg * 64 * kRowBytes;
  const uint32_t g_wg = base + L::RES1 + wg * 64 * kRowBytes;
  // the rows' lse2 and delta (padded: every row of the block has them)
  const int64_t at = static_cast<int64_t>(bh) * a.Tp;
  const float lse0 = a.lse2[at + row0], lse1 = a.lse2[at + row1];
  const float del0 = a.delta[at + row0], del1 = a.delta[at + row1];

  float dq[DQK / kChunk][32];
#pragma unroll
  for (int j = 0; j < DQK / kChunk; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[j][i] = 0.f;
  float s[32], dp[32];
  uint32_t da[4][4];

  mbar_wait(bars.res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int k0 = (kt_begin + it) * 64;
    mbar_wait(bars.full + 8 * st, (it / kStages) & 1);
    const bool dead = !rows || (a.causal && k0 > qa + 63) ||
                      (a.window > 0 && qa - (k0 + 63) >= a.window);
    if (!dead) {
      const uint32_t ks = base + L::ST0 + st * L::ST0_BYTES;
      const uint32_t vs = base + L::ST1 + st * L::ST1_BYTES;
      issue_scores<T, DQK, DV>(s, dp, q_wg, g_wg, ks, vs);
      wg_wait<0>();
      // element i: row (i & 2 ? row1 : row0), key k0 + 8 (i / 4) + col + (i & 1)
      grads(s, dp, capped, sl, cap_in, cap_out, [&](int i, float* l, float* d_) {
        *l = (i & 2) ? lse1 : lse0;
        *d_ = (i & 2) ? del1 : del0;
      });
      const bool edge = k0 + 64 > a.Tk || (a.causal && k0 + 63 > qa) ||
                        (a.window > 0 && qa + 63 - k0 >= a.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i & 2) ? row1 : row0;
          const int key = k0 + 8 * (i / 4) + col + (i & 1);
          bool live = key < a.Tk;
          if (a.causal) live = live && row >= key;
          if (a.window > 0) live = live && row - key < a.window;
          if (!live) dp[i] = 0.f;
        }
      }
      float unused0, unused1;
      pack_a<T>(dp, da, &unused0, &unused1);
      wg_fence();
      issue_rs<T, DQK>(dq, da, ks);
      wg_commit();
      wg_wait<0>();
    }
    mbar_arrive(bars.empty + 8 * st);
  }
  if (!rows) return;

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int j = 0; j < DQK / kChunk; ++j) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = kChunk * j + 8 * g + col;
      float r0, r1;
      if (row0 < a.Tq)
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<int64_t>(b) * a.Tq + row0) * a.H + h) * DQK + c) =
            pack2<T>(dq[j][4 * g] * a.scale, dq[j][4 * g + 1] * a.scale, &r0, &r1);
      if (row1 < a.Tq)
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<int64_t>(b) * a.Tq + row1) * a.H + h) * DQK + c) =
            pack2<T>(dq[j][4 * g + 2] * a.scale, dq[j][4 * g + 3] * a.scale, &r0, &r1);
    }
  }
}

// -- the wgmma route at head dim 256: the head dim split over the consumers --

constexpr int kWide = 256;  // the head dim of the split kernels

// Named barriers between the two consumer warpgroups of a split block.
enum : int {
  kBarP = 1,      // warpgroup 0 has written P^T and the exchange tile
  kBarDS = 2,     // warpgroup 1 has written dS^T (dq: dS)
  kBarDone0 = 3,  // warpgroup 0 has read the last dS^T (dq: dS)
  kBarDone1 = 4,  // warpgroup 1 has read the last P^T and exchange tile
};

// Shared memory of a split block (one layout for both kernels): two
// resident tiles of 64 rows x 256 columns (dk/dv: K and V; dq: Q and dO),
// the rings of two streamed tiles of 64 rows (dk/dv: Q and dO; dq: K and
// V), two 64 x 64 operand tiles in the input type (dk/dv: P^T and dS^T;
// dq: dS in the second), the f32 exchange tile (32 floats a consumer
// thread: P (1 - tanh^2) of the elements it holds), each stage's 64 rows
// of lse2 and delta (dk/dv), then the mbarriers: 226 KB of the 227.
struct WideLayout {
  static constexpr int THREADS = (kNC + 1) * 128;
  static constexpr int TILE = 64 * kWide * 2;
  static constexpr int OP_BYTES = 64 * 64 * 2;
  static constexpr int RES0 = 0;
  static constexpr int RES1 = RES0 + TILE;
  static constexpr int ST0 = RES1 + TILE;
  static constexpr int ST1 = ST0 + kStages * TILE;
  static constexpr int OPA = ST1 + kStages * TILE;
  static constexpr int OPB = OPA + OP_BYTES;
  static constexpr int XCH = OPB + OP_BYTES;
  static constexpr int ROWS = XCH + 32 * 128 * 4;
  static constexpr int ROW_BYTES = 2 * 64 * 4;  // lse2 then delta
  static constexpr int BAR = ROWS + kStages * ROW_BYTES;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * kStages) + 1024;
};
static_assert(WideLayout::SMEM <= 232448, "a split block must fit one SM");

// The producer thread's streamed load of tile `it` (64 rows at r0 of both
// tensors) into its stage, after the stage's last use is released.
__device__ __forceinline__ void load_wide(uint32_t base, const Bars& bars, int it,
                                          const CUtensorMap* m0,
                                          const CUtensorMap* m1, int head, int r0,
                                          int b, int extra_bytes) {
  using L = WideLayout;
  const int s = it % kStages;
  if (it >= kStages) mbar_wait(bars.empty + 8 * s, ((it / kStages) - 1) & 1);
  const uint32_t bar = bars.full + 8 * s;
  mbar_expect_tx(bar, 2 * L::TILE + extra_bytes);
  load_rows<kWide>(base + L::ST0 + s * L::TILE, 64, m0, bar, head, r0, b);
  load_rows<kWide>(base + L::ST1 + s * L::TILE, 64, m1, bar, head, r0, b);
}

// s = A.B^T over the 256 columns (64 x 64, f32): A a resident tile, B a
// streamed tile, both K-major; waits for it.
template <typename T>
__device__ __forceinline__ void wide_scores(float (&s)[32], uint32_t a, uint32_t b) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kWide / 16; ++kk)
    wgmma_ss<T>(s, kmajor_desc(a, 64, kk), kmajor_desc(b, 64, kk), kk > 0);
  wg_commit();
  wg_wait<0>();
}

// acc[j] += A . B[:, 128 wg + 64 j ..] over 64 rows: A an operand tile, B
// a streamed tile read MN-major.
template <typename T>
__device__ __forceinline__ void wide_half(float (&acc)[2][32], uint32_t a,
                                          uint32_t b, int wg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_ss_tb<T>(acc[j], kmajor_desc(a, 64, kk), mnmajor_desc(b, kk, 2 * wg + j));
}

// dk, dv per (64-key tile, batch, query head) at head dim 256.  K and V
// resident, Q and dO streamed.  Per q tile warpgroup 0 takes S^T = K.Q^T
// and warpgroup 1 dP^T = V.dO^T, each over all 256 columns; warpgroup 0
// turns S^T into P^T, writes it to shared memory in the input type and
// hands P (1 - tanh^2) over in f32; warpgroup 1 makes dS^T = that times
// (dP^T - D) and writes it beside P^T; then each warpgroup adds P^T.dO and
// dS^T.Q to its own 128 columns of dv and dk (128 f32 registers).
template <typename T>
__global__ void __launch_bounds__(WideLayout::THREADS, 1)
    dkdv_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap gmap, const Args a) {
  using L = WideLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const float* rows_smem = reinterpret_cast<const float*>(sm + L::ROWS);
  float* xch = reinterpret_cast<float*>(sm + L::XCH);

  const int BH = a.B * a.H;
  const int kt = static_cast<int>(blockIdx.x) / BH;  // the first keys see the
  const int bh = static_cast<int>(blockIdx.x) % BH;  // most rows: they run first
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int k0 = kt * 64;
  // the q tiles with a row that sees a key of [k0, k0 + 64): all of them
  // see one, so no tile of the walk is skipped
  const int n_qt = (a.Tq + 63) / 64;
  const int qt_begin = a.causal ? min(n_qt, k0 / 64) : 0;
  int qt_end = n_qt;
  if (a.window > 0) qt_end = min(n_qt, (k0 + 62 + a.window) / 64 + 1);
  const int n_it = max(0, qt_end - qt_begin);

  const Bars bars = init_bars<L>(base);
  const int wg = warpgroup();
  if (wg == kNC) {
    producer_regs<kNC>();
    if (threadIdx.x == kNC * 128) {
      mbar_expect_tx(bars.res_full, 2 * L::TILE);
      load_rows<kWide>(base + L::RES0, 64, &kmap, bars.res_full, kvh, k0, b);
      load_rows<kWide>(base + L::RES1, 64, &vmap, bars.res_full, kvh, k0, b);
      const float* lse2 = a.lse2 + static_cast<int64_t>(bh) * a.Tp;
      const float* delta = a.delta + static_cast<int64_t>(bh) * a.Tp;
      for (int it = 0; it < n_it; ++it) {
        const int q0 = (qt_begin + it) * 64;
        load_wide(base, bars, it, &qmap, &gmap, h, q0, b, L::ROW_BYTES);
        const uint32_t rows = base + L::ROWS + (it % kStages) * L::ROW_BYTES;
        const uint32_t bar = bars.full + 8 * (it % kStages);
        bulk_load(rows, lse2 + q0, 64 * 4, bar);
        bulk_load(rows + 64 * 4, delta + q0, 64 * 4, bar);
      }
    }
    return;
  }

  // both warpgroups hold the same elements of a 64 x 64 product: keys key0
  // and key0 + 8, q rows 8 g + col + {0, 1} of each 8-row group g
  consumer_regs<kNC>();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wt = threadIdx.x % 128;
  const int key0 = k0 + 16 * warp + lane / 4;
  const int key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  const float sl = a.scale * kLog2e;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const uint32_t opa = base + L::OPA, opb = base + L::OPB;

  float dk[2][32], dv[2][32], s[32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[j][i] = dv[j][i] = 0.f;

  mbar_wait(bars.res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int q0 = (qt_begin + it) * 64;
    mbar_wait(bars.full + 8 * st, (it / kStages) & 1);
    const uint32_t qs = base + L::ST0 + st * L::TILE;
    const uint32_t gs = base + L::ST1 + st * L::TILE;
    const float* lse_s = rows_smem + st * (L::ROW_BYTES / 4);
    const float* del_s = lse_s + 64;
    // S^T (warpgroup 0) or dP^T (1), outside the branches below: ptxas
    // serializes a wgmma it cannot prove warp-uniform.  Element i: key
    // (i & 2 ? key1 : key0), q row q0 + 8 (i / 4) + col + (i & 1)
    wide_scores<T>(s, base + (wg == 0 ? L::RES0 : L::RES1), wg == 0 ? qs : gs);
    if (wg == 0) {
      const bool edge = (a.causal && k0 + 63 > q0) ||
                        (a.window > 0 && q0 + 63 - k0 >= a.window);
      if (it > 0) pair_sync(kBarDone1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + col + (i & 1);
        float p, pc;
        if (capped) {
          const float t = tanhf(s[i] * cap_in);
          p = ex2(fmaf(t, cap_out, -lse_s[c]));
          pc = p * (1.f - t * t);
        } else {
          p = ex2(fmaf(s[i], sl, -lse_s[c]));
          pc = p;
        }
        if (edge) {
          const int key = (i & 2) ? key1 : key0;
          const int row = q0 + c;
          bool live = true;
          if (a.causal) live = row >= key;
          if (a.window > 0) live = live && row - key < a.window;
          if (!live) p = pc = 0.f;
        }
        s[i] = p;
        xch[i * 128 + wt] = pc;
      }
      store_operand<T>(sm + L::OPA, s, 16 * warp + lane / 4, col);
      fence_async_smem();
      pair_arrive(kBarP);
      pair_sync(kBarDS);
    } else {
      pair_sync(kBarP);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = xch[i * 128 + wt] * (s[i] - del_s[8 * (i / 4) + col + (i & 1)]);
      if (it > 0) pair_sync(kBarDone0);
      store_operand<T>(sm + L::OPB, s, 16 * warp + lane / 4, col);
      fence_async_smem();
      pair_arrive(kBarDS);
    }
    wg_fence();
    wide_half<T>(dv, opa, gs, wg);
    wide_half<T>(dk, opb, qs, wg);
    wg_commit();
    wg_wait<0>();
    if (it + 1 < n_it) pair_arrive(wg == 0 ? kBarDone0 : kBarDone1);
    mbar_arrive(bars.empty + 8 * st);
  }

  // this query head's f32 slots of the warpgroup's 128 columns: dk (times
  // scale) and dv of the tile's keys
  const int64_t slot = static_cast<int64_t>(bh) * a.Tk * kWide + 128 * wg;
  store_keys<2, kWide>(a.dk_part + slot, dk, key0, key1, col, a.Tk, a.scale);
  store_keys<2, kWide>(a.dv_part + slot, dv, key0, key1, col, a.Tk, 1.f);
}

// dq per (64-row q tile, batch, head) at head dim 256.  Q and dO
// resident, K and V streamed.  Per key tile warpgroup 0 takes S = Q.K^T
// and hands P (1 - tanh^2) over, warpgroup 1 takes dP = dO.V^T and writes
// dS to shared memory in the input type; then each warpgroup adds dS.K to
// its own 128 columns of dq.
template <typename T>
__global__ void __launch_bounds__(WideLayout::THREADS, 1)
    dq_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap gmap, const Args a) {
  using L = WideLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float* xch = reinterpret_cast<float*>(sm + L::XCH);

  const int BH = a.B * a.H;
  const int n_qb = (a.Tq + 63) / 64;
  // causal: the last q tiles see the most key tiles, so they run first
  const int qb = a.causal ? n_qb - 1 - static_cast<int>(blockIdx.x) / BH
                          : static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = qb * 64;
  // the key tiles with a key that a row of [q0, q0 + 64) sees
  const int n_kt = (a.Tk + 63) / 64;
  const int kt_end = a.causal ? min(n_kt, (q0 + 63) / 64 + 1) : n_kt;
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / 64 : 0;
  const int n_it = max(0, kt_end - kt_begin);

  const Bars bars = init_bars<L>(base);
  const int wg = warpgroup();
  if (wg == kNC) {
    producer_regs<kNC>();
    if (threadIdx.x == kNC * 128) {
      mbar_expect_tx(bars.res_full, 2 * L::TILE);
      load_rows<kWide>(base + L::RES0, 64, &qmap, bars.res_full, h, q0, b);
      load_rows<kWide>(base + L::RES1, 64, &gmap, bars.res_full, h, q0, b);
      for (int it = 0; it < n_it; ++it)
        load_wide(base, bars, it, &kmap, &vmap, kvh, (kt_begin + it) * 64, b, 0);
    }
    return;
  }

  // both warpgroups hold rows row0 and row0 + 8, and keys 8 g + col + {0,
  // 1} of each 8-key group g
  consumer_regs<kNC>();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wt = threadIdx.x % 128;
  const int row0 = q0 + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  const float sl = a.scale * kLog2e;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const uint32_t opb = base + L::OPB;
  // the rows' lse2 and delta (padded: every row of the block has them)
  const int64_t at = static_cast<int64_t>(bh) * a.Tp;
  const float lse0 = a.lse2[at + row0], lse1 = a.lse2[at + row1];
  const float del0 = a.delta[at + row0], del1 = a.delta[at + row1];

  float dq[2][32], s[32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[j][i] = 0.f;

  mbar_wait(bars.res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int k0 = (kt_begin + it) * 64;
    mbar_wait(bars.full + 8 * st, (it / kStages) & 1);
    const uint32_t ks = base + L::ST0 + st * L::TILE;
    const uint32_t vs = base + L::ST1 + st * L::TILE;
    // S (warpgroup 0) or dP (1); element i: row (i & 2 ? row1 : row0), key
    // k0 + 8 (i / 4) + col + (i & 1)
    wide_scores<T>(s, base + (wg == 0 ? L::RES0 : L::RES1), wg == 0 ? ks : vs);
    if (wg == 0) {
      const bool edge = k0 + 64 > a.Tk || (a.causal && k0 + 63 > q0) ||
                        (a.window > 0 && q0 + 63 - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float lse2 = (i & 2) ? lse1 : lse0;
        float pc;
        if (capped) {
          const float t = tanhf(s[i] * cap_in);
          pc = ex2(fmaf(t, cap_out, -lse2)) * (1.f - t * t);
        } else {
          pc = ex2(fmaf(s[i], sl, -lse2));
        }
        if (edge) {
          const int row = (i & 2) ? row1 : row0;
          const int key = k0 + 8 * (i / 4) + col + (i & 1);
          bool live = key < a.Tk;
          if (a.causal) live = live && row >= key;
          if (a.window > 0) live = live && row - key < a.window;
          if (!live) pc = 0.f;
        }
        xch[i * 128 + wt] = pc;
      }
      pair_arrive(kBarP);
      pair_sync(kBarDS);  // also: warpgroup 1 has read the exchange tile
    } else {
      pair_sync(kBarP);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = xch[i * 128 + wt] * (s[i] - ((i & 2) ? del1 : del0));
      if (it > 0) pair_sync(kBarDone0);
      store_operand<T>(sm + L::OPB, s, 16 * warp + lane / 4, col);
      fence_async_smem();
      pair_arrive(kBarDS);
    }
    wg_fence();
    wide_half<T>(dq, opb, ks, wg);
    wg_commit();
    wg_wait<0>();
    if (wg == 0 && it + 1 < n_it) pair_arrive(kBarDone0);
    mbar_arrive(bars.empty + 8 * st);
  }

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = 128 * wg + kChunk * j + 8 * g + col;
      float r0, r1;
      if (row0 < a.Tq)
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<int64_t>(b) * a.Tq + row0) * a.H + h) * kWide + c) =
            pack2<T>(dq[j][4 * g] * a.scale, dq[j][4 * g + 1] * a.scale, &r0, &r1);
      if (row1 < a.Tq)
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<int64_t>(b) * a.Tq + row1) * a.H + h) * kWide + c) =
            pack2<T>(dq[j][4 * g + 2] * a.scale, dq[j][4 * g + 3] * a.scale, &r0, &r1);
    }
  }
}

// -- host side -------------------------------------------------------------------

template <typename Kernel>
cudaError_t configure(Kernel kernel, int bytes, int device, PerDevice& done) {
  return done.once(device, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
  });
}

int blocks(int64_t threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

template <typename T>
cudaError_t launch_delta(const Args& a, cudaStream_t stream) {
  delta_kernel<T><<<blocks(static_cast<int64_t>(a.B) * a.H * a.Tp * 32), kThreads, 0,
                    stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const Args& a, cudaStream_t stream) {
  const int rows = kReduceThreads / (std::max(a.D, a.Dv) / 4);  // a block's
  const int64_t n_rows = static_cast<int64_t>(a.B) * a.Tk * a.Kv;
  const dim3 grid(static_cast<unsigned>((n_rows + rows - 1) / rows), 2);
  reduce_kernel<T><<<grid, kReduceThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// One f32 route's tiles: dk/dv blocks of 64 keys in CS column groups and
// KSPLIT_K row groups walking q tiles of KSPLIT_K * BQ rows, QSTAGES deep;
// dq blocks of 64 rows in KSPLIT_Q key groups walking kv tiles of KSPLIT_Q
// * BK keys, KSTAGES deep.
template <int DQK, int DV, int BQ, int CS, int KSPLIT_K, int QSTAGES, int BK,
          int KSPLIT_Q, int KSTAGES>
cudaError_t tf32_launch(const Args& a, int device, cudaStream_t stream) {
  using LK = DkdvLayout<DQK, DV, BQ, KSPLIT_K, QSTAGES>;
  using LQ = DqLayout<DQK, DV, BK, KSPLIT_Q, KSTAGES>;
  static_assert(LK::BYTES <= 232448 && LQ::BYTES <= 232448,
                "an f32 block must fit one SM");
  static PerDevice dkdv_done, dq_done;  // the attributes, per kernel and device
  auto dkdv = dkdv_tf32_kernel<DQK, DV, BQ, CS, KSPLIT_K, QSTAGES>;
  auto dq = dq_tf32_kernel<DQK, DV, BK, KSPLIT_Q, KSTAGES>;
  cudaError_t err = configure(dkdv, LK::BYTES, device, dkdv_done);
  if (err != cudaSuccess) return err;
  err = configure(dq, LQ::BYTES, device, dq_done);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  if ((err = launch_delta<float>(a, stream)) != cudaSuccess) return err;
  dkdv<<<((a.Tk + kF32Rows - 1) / kF32Rows) * BH, 128 * CS * KSPLIT_K, LK::BYTES,
         stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<((a.Tq + kF32Rows - 1) / kF32Rows) * BH, 128 * KSPLIT_Q, LQ::BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce<float>(a, stream);
}

// The f32 route's tiles at each pair of head dims.  At 64 and 128 both
// kernels split each stage's walked axis between two groups of 4 warps
// (the last q tiles' or the first keys' walk, the longest, takes half as
// long), two stages deep: dk/dv 103 and 199 KB of shared memory, dq 102
// and 198 KB.  At 256 and (192, 128) a dk/dv block's 8 warps split dk and
// dv by columns instead (at 256 they would take 256 f32 registers a
// thread), and the dq blocks are one group of 4 warps (195 and 164 KB).
cudaError_t tf32_dispatch(const Args& a, int device, cudaStream_t stream) {
  if (a.D == 192 && a.Dv == 128)
    return tf32_launch<192, 128, 32, 2, 1, 2, 32, 1, 2>(a, device, stream);
  if (a.Dv != a.D) return cudaErrorInvalidValue;
  switch (a.D) {
    case 64:
      return tf32_launch<64, 64, 32, 1, 2, 2, 32, 2, 2>(a, device, stream);
    case 128:
      return tf32_launch<128, 128, 32, 1, 2, 2, 32, 2, 2>(a, device, stream);
    case 256:
      return tf32_launch<256, 256, 32, 2, 1, 1, 32, 1, 1>(a, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int DQK, int DV>
cudaError_t tc_launch(const Args& a, const CUtensorMap (&m)[4], int device,
                      cudaStream_t stream) {
  using L = TcLayout<DQK, DV>;
  static PerDevice dkdv_done, dq_done;  // the attributes, per kernel and device
  auto dkdv = dkdv_wgmma_kernel<T, DQK, DV>;
  auto dq = dq_wgmma_kernel<T, DQK, DV>;
  cudaError_t err = configure(dkdv, L::SMEM, device, dkdv_done);
  if (err != cudaSuccess) return err;
  err = configure(dq, L::SMEM, device, dq_done);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  if ((err = launch_delta<T>(a, stream)) != cudaSuccess) return err;
  dkdv<<<((a.Tk + L::BR - 1) / L::BR) * BH, L::THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<((a.Tq + L::BR - 1) / L::BR) * BH, L::THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce<T>(a, stream);
}

template <typename T>
cudaError_t wide_launch(const Args& a, const CUtensorMap (&m)[4], int device,
                        cudaStream_t stream) {
  using L = WideLayout;
  static PerDevice dkdv_done, dq_done;  // the attributes, per kernel and device
  auto dkdv = dkdv_wide_kernel<T>;
  auto dq = dq_wide_kernel<T>;
  cudaError_t err = configure(dkdv, L::SMEM, device, dkdv_done);
  if (err != cudaSuccess) return err;
  err = configure(dq, L::SMEM, device, dq_done);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  if ((err = launch_delta<T>(a, stream)) != cudaSuccess) return err;
  dkdv<<<((a.Tk + 63) / 64) * BH, L::THREADS, L::SMEM, stream>>>(m[0], m[1], m[2],
                                                                  m[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<((a.Tq + 63) / 64) * BH, L::THREADS, L::SMEM, stream>>>(m[0], m[1], m[2],
                                                               m[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce<T>(a, stream);
}

// The head dims the tensor-core route is built for: (64, 64), (128, 128),
// (256, 256) and MLA's (192, 128).
bool tc_built(int dqk, int dv) {
  return (dqk == dv && (dqk == 64 || dqk == 128 || dqk == 256)) ||
         (dqk == 192 && dv == 128);
}

// Tensor maps of q, k, v and do (TMA: 16-byte aligned bases and strides,
// which the wrapper's plan checks), then the kernels of the head dims.
template <typename T>
cudaError_t tc_dispatch(const Args& a, CUtensorMapDataType type, int device,
                        cudaStream_t stream) {
  const cudaError_t bound = bind_context(device);
  if (bound != cudaSuccess) return bound;
  CUtensorMap m[4];
  if (!encode(&m[0], type, a.q, a.D, a.H, a.Tq, a.B, a.q_sh, a.q_st, a.q_sb) ||
      !encode(&m[1], type, a.k, a.D, a.Kv, a.Tk, a.B, a.k_sh, a.k_st, a.k_sb) ||
      !encode(&m[2], type, a.v, a.Dv, a.Kv, a.Tk, a.B, a.v_sh, a.v_st, a.v_sb) ||
      !encode(&m[3], type, a.g, a.Dv, a.H, a.Tq, a.B, a.g_sh, a.g_st, a.g_sb))
    return cudaErrorInvalidValue;
  switch (a.D) {
    case 64:
      return tc_launch<T, 64, 64>(a, m, device, stream);
    case 128:
      return tc_launch<T, 128, 128>(a, m, device, stream);
    case 192:  // Dv 128 (tc_built)
      return tc_launch<T, 192, 128>(a, m, device, stream);
    default:
      return wide_launch<T>(a, m, device, stream);
  }
}

}  // namespace fa_bwd

using namespace fa_bwd;

// One call's sizes, strides and options, built once per call signature by
// the wrapper (its ctypes structure `_Params` has this layout).
struct Params {
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int64_t g_sb, g_st, g_sh;  // of do
  int32_t dtype;  // 0 float32, 1 bfloat16, 2 float16
  int32_t B, Tq, Tk, H, Kv;
  int32_t D;   // of q and k
  int32_t Dv;  // of v, o and do
  int32_t causal;
  int32_t window;  // <= 0: none
  int32_t route;   // 0 tf32x3, 1 wgmma: the wrapper's plan
  float scale;
  float softcap;  // <= 0: off
  int32_t device;
};
static_assert(sizeof(Params) == 176 && offsetof(Params, dtype) == 120 &&
                  offsetof(Params, route) == 160 && offsetof(Params, scale) == 164 &&
                  offsetof(Params, device) == 172,
              "Params must match the wrapper's ctypes structure");

// dq (B, Tq, H, D), dk (B, Tk, Kv, D) and dv (B, Tk, Kv, Dv), contiguous in
// the input type, from q, k (head dim D), v, o, do (Dv) of p->dtype, the
// head dims contiguous, and lse (f32, (B, H, Tq) contiguous), on `stream`,
// without synchronising.  `delta` and `lse2` (B, H, Tq rounded up to 128)
// and `dk_part` (B, H, Tk, D), `dv_part` (B, H, Tk, Dv) are f32 scratch.
// The route is "wgmma" for bf16 and f16 at (D, Dv) = (64, 64), (128, 128),
// (192, 128) or (256, 256), "tf32x3" for f32 at the same pairs.
// Returns a cudaError_t
// (cudaErrorInvalidValue for an unsupported dtype or head dims, a route
// other than this rule's, or a layout TMA refuses).
extern "C" int flash_attention_bwd_launch(const Params* p, const void* q,
                                          const void* k, const void* v,
                                          const void* o, const void* g,
                                          const float* lse, float* delta, float* lse2,
                                          float* dk_part, float* dv_part, void* dq,
                                          void* dk, void* dv, cudaStream_t stream) {
  if (p->B <= 0 || p->Tq <= 0 || p->Tk <= 0) return cudaSuccess;
  if (p->Kv <= 0 || p->H % p->Kv != 0 || p->device < 0 || p->device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const bool tc = p->dtype != 0 && tc_built(p->D, p->Dv);
  if (p->route != (tc ? 1 : 0)) return cudaErrorInvalidValue;
  const int Tp = (p->Tq + kRowPad - 1) / kRowPad * kRowPad;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  const int64_t strides = p->q_sb | p->q_st | p->q_sh | p->k_sb | p->k_st | p->k_sh |
                          p->v_sb | p->v_st | p->v_sh | p->g_sb | p->g_st | p->g_sh;
  const int vec = bases % 16 == 0 && strides % 4 == 0;  // f32: 4 elements
  const Args a{q,       k,       v,       o,       g,        lse,      delta,
               lse2,    dk_part, dv_part, dq,      dk,       dv,       p->q_sb,
               p->q_st, p->q_sh, p->k_sb, p->k_st, p->k_sh,  p->v_sb,  p->v_st,
               p->v_sh, p->o_sb, p->o_st, p->o_sh, p->g_sb,  p->g_st,  p->g_sh,
               p->B,    p->Tq,   p->Tk,   p->H,    p->Kv,    p->D,     p->Dv,
               Tp,      p->scale, p->softcap, p->causal, p->window, vec};
  if (p->dtype == 0) return tf32_dispatch(a, p->device, stream);
  if (!tc) return cudaErrorInvalidValue;
  switch (p->dtype) {
    case 1:
      return tc_dispatch<__nv_bfloat16>(a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                        p->device, stream);
    case 2:
      return tc_dispatch<__half>(a, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, p->device,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
