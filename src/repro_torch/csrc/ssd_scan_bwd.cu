// Mamba-2 SSD within-chunk step, backward, on Hopper (sm_90a), f32.
//
// The forward (ssd_scan.cu), for one chunk of Q positions and one head h
// reading B/C group g = h / (H / G), with a = dA_cs, s = a[Q-1], j <= q:
//
//   L[q,j] = exp(a_q - a_j)  (0 above the diagonal)    G = C.B^T
//   W = G o L o dt_j,  y_diag = W.x
//   e_j = exp(s - a_j) dt_j,  S = sum_j e_j x_j (x) B_j
//
// Given Y = dy_diag and Sg = dS this computes
//
//   dW    = (Y.x^T) masked to j <= q,   M = dW o W
//   dx    = W^T.Y + e o (B.Sg^T)
//   f_j   = sum_{p,n} x[j,p] B[j,n] Sg[p,n]
//   ddt_j = sum_q dW[q,j] G[q,j] L[q,j] + f_j exp(s - a_j)
//   ddA_k = sum_j M[k,j] - sum_q M[q,k] - f_k e_k + [k = Q-1] sum_j f_j e_j
//   dG    = dW o L o dt_j, summed over the group's heads
//   dC    = dG.B,   dB = dG^T.C + sum_h (e_h o x_h).Sg_h
//
// Replaces the TPU side's jax.vjp of the einsums of the reference's
// chunked SSD (repro/models/ssm.py, _ssd_chunked): the reference has no
// Pallas backward, and never puts its Pallas SSD kernel on a model path.
// The reference takes exp over the whole chunk and masks after it; above
// the diagonal that exponent passes f32's range at a long chunk and a
// strong decay, and its ddA_cs turns non-finite.  Here, as in the forward,
// the exponent is taken only on and below the diagonal and inside the
// chunk (it is -inf elsewhere, so exp gives 0 without an inf * 0).
//
// Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8,
// tf32.h): each f32 operand split into its TF32 high part and the
// rest, lo.hi, hi.lo and hi.hi summed in f32, close to f32 accuracy.  A
// block of 256 threads (8 warps) takes a product of 64 rows as 4 x 2 warp
// tiles.  Operands whose rows run along the product's k axis in shared
// memory load by ldmatrix (four 8 x 4 f32 matrices an instruction); the
// others element by element, from tiles whose row strides keep a
// fragment's 32 reads on 32 banks.  Three launches a call,
// in order on the caller's stream:
//   1. pair_kernel, per (chunk, group, 64 x 64 tile pair on or below the
//      diagonal): G = C.B^T into f32 scratch gs (BC, G, Qp, Qp), Qp = Q
//      rounded up to 64, and kept in registers; then, walking the group's
//      heads in order, per head dW = Y.x^T (K = P), dG += dW o L o dt_j
//      (summed on chip in head order, in registers), and M = dW o W and
//      dW o G o L summed over the tile's keys and rows into 3 x 64 floats
//      a head (scratch ms), the next heads' Y and x tiles loading
//      (cp.async) while this one multiplies.  dG goes to f32 scratch dg
//      (BC, G, Qp, Qp), once per group.
//   2. head_kernel, per (chunk, head): walks the key tiles j, and for each
//      the q tiles at or below it, in order: W^T (from G and the head's
//      decay) into shared memory and dx += W^T.Y; then the state terms of
//      the key tile, u = B.Sg^T (K = N), dx += e o u and f = rowsum(x o
//      u); ddt and ddA take M's and dW G L's sums from ms, in tile order.
//      dx, ddt and ddA are per head and leave it final.
//   3. group_kernel, per (chunk, group, 64-row tile, 64 columns of N, dB
//      or dC): dC = dG.B over the tile's rows, or dB = dG^T.C over its
//      keys plus the state term sum_h (e_h o x_h).Sg_h as one product of
//      depth H/G * P, walking the heads in order with the next head's
//      tiles loading meanwhile.
// No atomics: every sum runs in one fixed order (over a tile, in the mma
// and then by shuffle trees and warps in order; over tiles, in tile
// order; over heads, in head order), so the same inputs give the same
// bytes, which a training run resumed from a checkpoint relies on.  With
// per-head B/C (G = H) a group is one head, and the same code runs.
//
// What bounds it: at the mamba2-2.7b training shape (a 4096-token
// microbatch: BC 16, Q 256, H 80, P 64, N 128, G 1) the per-head products
// (dW, W^T.Y, B.Sg^T, x.Sg) are 21.5 GFLOP and the group's 0.4 (three
// times that as run in 3xTF32), against 0.31 GB of inputs and outputs (x,
// dy and dx 84 MB each, dS 42 MB), so the memory rate (0.092 ms at 3.35
// TB/s; 0.044 ms for the operations at the TF32 peak).  dG and the state
// term of dB never pass through per-head scratch: G and dG (4 MB each
// there) and the per-head sums (9.8 MB) do.  As run, the mma.sync products
// take most of the time: the per-head kernel without them runs in under
// half its time (PERF.md).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "per_device.h"
#include "tf32.h"

namespace ssd_bwd {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows of a q tile and of a key tile
constexpr int kMaxQ = 256;
constexpr int kNB = 64;    // most columns of N a group block takes
// Buffers of the head walks: a head's tiles load (cp.async) while the
// heads before it multiply.
constexpr int kPairStages = 2;
constexpr int kGroupStages = 2;

// Blocks an SM of pair_kernel and head_kernel: two where their registers
// fit 128 a thread without spilling (ptxas, P 64 and N >= 64: mamba2's
// widths), else one.
__host__ __device__ constexpr int blocks_per_sm(int p, int n) {
  return p == 64 && n >= 64 ? 2 : 1;
}

// Row strides (floats) of shared tiles W floats wide (W a multiple of 16):
// A(W) for a tile read with its rows spread over the lanes' g = lane / 4
// and columns over t = lane % 4, or by ldmatrix (stride = 4 mod 8 floats:
// the reads of a fragment, or ldmatrix's eight rows, hit distinct banks),
// B(W) for one read with rows over t and columns over g (stride = 8 mod
// 32).
__host__ __device__ constexpr int A_(int w) { return w + 4; }
__host__ __device__ constexpr int B_(int w) { return w + 8; }

// One call's sizes, strides (in elements) and grids, built once per call
// signature by the wrapper (its ctypes structure `_Params`, field for field).
struct Params {
  int64_t x_sb, x_sq, x_sh;
  int64_t dt_sb, dt_sq, dt_sh;
  int64_t da_sb, da_sq, da_sh;
  int64_t b_sb, b_sq, b_sg;
  int64_t c_sb, c_sq, c_sg;
  int64_t dy_sb, dy_sq, dy_sh;
  int64_t ds_sb, ds_sh, ds_sp;
  int32_t device, BC, Q, H, G, P, N, qp;
  int32_t pair_blocks, head_blocks, group_blocks, pad_;
};

struct Args {
  const float* x;   // (BC, Q, H, P)
  const float* dt;  // (BC, Q, H)
  const float* da;  // (BC, Q, H)
  const float* b;   // (BC, Q, G, N)
  const float* c;   // (BC, Q, G, N)
  const float* dy;  // (BC, Q, H, P)
  const float* ds;  // (BC, H, P, N)
  float* dx;        // (BC, Q, H, P), contiguous, as the outputs below
  float* ddt;       // (BC, Q, H)
  float* dda;       // (BC, Q, H)
  float* db;        // (BC, Q, G, N)
  float* dc;        // (BC, Q, G, N)
  float* gs;        // scratch (BC, G, Qp, Qp): C.B^T, tiles on or below the diagonal
  float* dg;        // scratch (BC, G, Qp, Qp): dG, the same tiles
  float* ms;        // scratch (BC, H, pairs, 3, 64): each head's sums of one
                    // tile pair: M over its keys, M and dW G L over its rows
  Params p;
};

// Rows [row0, row0 + rows) of a (rows x W) f32 matrix whose rows lie `sq`
// elements apart (its last dim contiguous, 16-byte aligned) into shared
// memory rows `ld` floats apart, by cp.async; rows at or past `valid`
// fill with zeros.  The caller commits and waits.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t sq, int row0, int rows,
                                          int valid) {
  constexpr int CPR = W / 4;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR, row = row0 + r;
    const bool in = row < valid;
    cp_async16(smem_addr(dst + r * ld + c * 4), src + (in ? row : 0) * sq + c * 4,
               in ? 16 : 0);
  }
}

// n values of a vector with stride `st` from element `first`, by 4-byte
// cp.async (zeros at or past `valid`), threads [t0, t0 + n) of the block.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int64_t st,
                                         int first, int n, int valid, int t0) {
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i >= 0 && i < n) {
    const bool in = first + i < valid;
    cp_async4(smem_addr(dst + i), src + (in ? first + i : 0) * st, in ? 4 : 0);
  }
}

// The (q tile, key tile) pair `pair` of the tiles on or below the diagonal.
__device__ __forceinline__ void pair_tiles(int pair, int& qt, int& jt) {
  qt = 0;
  while (pair > qt) pair -= ++qt;
  jt = pair;
}

// -- 1. G = C.B^T, dG and M's sums, per (chunk, group, tile pair) -------------

// Shared memory of pair_kernel, in floats: phase 1 the C and B tiles (64 x
// N each); phase 2 kPairStages buffers of a head's Y and x tiles (64 x P
// each), its dA_cs rows of the q tile and of the key tile and dt of the
// key tile, then two buffers of the warps' partial sums of M and dW G L
// (2 column warps x 64 rows, then 4 row warps x 64 keys, twice).
template <int P, int N>
struct PairSmem {
  static constexpr int YS = A_(P), XS = A_(P), CS = A_(N);
  static constexpr int VEC = 3 * kTile;
  static constexpr int BUF = kTile * YS + kTile * XS + VEC;
  static constexpr int PART = 2 * kTile + 8 * kTile;
  static constexpr int PHASE1 = 2 * kTile * CS;
  static constexpr int PHASE2 = kPairStages * BUF + 2 * PART;
  static constexpr int FLOATS = PHASE1 > PHASE2 ? PHASE1 : PHASE2;
  static constexpr int BYTES = FLOATS * 4;
};

// The sum over t = lane % 4 of a value each lane holds (lanes with the
// same g = lane / 4), in a fixed tree order.
__device__ __forceinline__ float sum_t(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// ... over g (lanes with the same t).
__device__ __forceinline__ float sum_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(P, N))
    pair_kernel(const Args a) {
  using S = PairSmem<P, N>;
  extern __shared__ __align__(16) float smem[];
  const Params& p = a.p;
  const int nt = p.qp / kTile, pairs = nt * (nt + 1) / 2;
  int idx = static_cast<int>(blockIdx.x);
  const int pair = idx % pairs;
  int qt, jt;
  pair_tiles(pair, qt, jt);
  idx /= pairs;
  const int g = idx % p.G, bc = idx / p.G;
  const int rep = p.H / p.G, h0 = g * rep;
  const int q0 = qt * kTile, j0 = jt * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 16 q rows x 32 keys a warp
  const int64_t out0 = (static_cast<int64_t>(bc * p.G + g) * p.qp + q0) * p.qp + j0;

  // G = C_q . B_j, kept in registers (this thread's elements of the tile)
  float gr[1][4][4];
  zero(gr);
  {
    float* sc = smem;
    float* sb = smem + kTile * S::CS;
    load_rows<N>(sc, S::CS, a.c + bc * p.c_sb + g * p.c_sg, p.c_sq, q0, kTile, p.Q);
    load_rows<N>(sb, S::CS, a.b + bc * p.b_sb + g * p.b_sg, p.b_sq, j0, kTile, p.Q);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mma3<1, 4, N>(gr, KRows{sc + 16 * wm * S::CS, S::CS},
                  KRows{sb + 32 * wn * S::CS, S::CS});
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = 16 * wm + gq + 4 * e, c = 32 * wn + 8 * jj + 2 * tq;
        *reinterpret_cast<float2*>(a.gs + out0 + static_cast<int64_t>(r) * p.qp + c) =
            make_float2(gr[0][jj][e], gr[0][jj][e + 1]);
      }
    __syncthreads();  // phase 2 reuses the tiles' memory
  }

  // Per head, in order: dW = Y.x^T; dG += dW o L o dt_j; and M = dW o W
  // (W = G o L o dt_j) and dW o G o L summed over the tile's keys and rows
  // into partials that the next iteration combines and stores.
  float* part = smem + kPairStages * S::BUF;  // two buffers of S::PART
  auto load = [&](int hh, int buf) {
    float* ys = smem + buf * S::BUF;
    float* xs = ys + kTile * S::YS;
    float* vs = xs + kTile * S::XS;
    const int h = h0 + hh;
    load_rows<P>(ys, S::YS, a.dy + bc * p.dy_sb + h * p.dy_sh, p.dy_sq, q0, kTile, p.Q);
    load_rows<P>(xs, S::XS, a.x + bc * p.x_sb + h * p.x_sh, p.x_sq, j0, kTile, p.Q);
    const float* da = a.da + bc * p.da_sb + h * p.da_sh;
    load_vec(vs, da, p.da_sq, q0, kTile, p.Q, 0);
    load_vec(vs + kTile, da, p.da_sq, j0, kTile, p.Q, kTile);
    load_vec(vs + 2 * kTile, a.dt + bc * p.dt_sb + h * p.dt_sh, p.dt_sq, j0, kTile, p.Q,
             2 * kTile);
  };
  // head hh's partials, summed over the warps in order, to ms: M over the
  // keys (by row), then M and dW G L over the rows (by key)
  auto store_sums = [&](int hh) {
    if (tid < 3 * kTile) {
      const float* pb = part + (hh & 1) * S::PART;
      const int which = tid / kTile, i = tid % kTile;
      float v;
      if (which == 0) {
        v = pb[i] + pb[kTile + i];
      } else {
        const float* pc = pb + 2 * kTile + (which - 1) * 4 * kTile;
        v = ((pc[i] + pc[kTile + i]) + pc[2 * kTile + i]) + pc[3 * kTile + i];
      }
      const int64_t at = (static_cast<int64_t>(bc) * p.H + h0 + hh) * pairs + pair;
      a.ms[at * 3 * kTile + tid] = v;
    }
  };
  float dg[1][4][4];
  zero(dg);
  for (int hh = 0; hh < kPairStages - 1; ++hh) {
    if (hh < rep) load(hh, hh);
    cp_async_commit();  // empty past the last head: one group a head
  }
  for (int hh = 0; hh < rep; ++hh) {
    const int ahead = hh + kPairStages - 1;
    if (ahead < rep) load(ahead, ahead % kPairStages);
    cp_async_commit();
    cp_async_wait<kPairStages - 1>();  // head hh's group has landed
    __syncthreads();
    if (hh > 0) store_sums(hh - 1);
    const float* ys = smem + (hh % kPairStages) * S::BUF;
    const float* xs = ys + kTile * S::YS;
    const float* vs = xs + kTile * S::XS;
    float dw[1][4][4];
    zero(dw);
    mma3<1, 4, P>(dw, KRows{ys + 16 * wm * S::YS, S::YS},
                  KRows{xs + 32 * wn * S::XS, S::XS});
    float rs[2] = {0.f, 0.f}, cs[4][2][2];  // rows g, g + 8; (M, dW G L) by key
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) cs[jj][u][0] = cs[jj][u][1] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wm + gq + 8 * (e >> 1);
        const int c = 32 * wn + 8 * jj + 2 * tq + (e & 1);
        const int q = q0 + r, j = j0 + c;
        // the exponent only on and below the diagonal, inside the chunk
        const bool live = j <= q && q < p.Q;
        const float x = live ? (vs[r] - vs[kTile + c]) * kLog2e : -INFINITY;
        const float L = fast_exp2(x), dtj = vs[2 * kTile + c];
        const float w = dw[0][jj][e];
        dg[0][jj][e] = fmaf(w * L, dtj, dg[0][jj][e]);
        const float gl = gr[0][jj][e] * L;
        const float m = w * (gl * dtj);
        rs[e >> 1] += m;
        cs[jj][e & 1][0] += m;
        cs[jj][e & 1][1] = fmaf(w, gl, cs[jj][e & 1][1]);
      }
    float* pb = part + (hh & 1) * S::PART;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float v = sum_t(rs[u]);
      if (tq == 0) pb[wn * kTile + 16 * wm + gq + 8 * u] = v;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float v = sum_g(cs[jj][u][k]);
          if (gq == 0)
            pb[2 * kTile + (4 * k + wm) * kTile + 32 * wn + 8 * jj + 2 * tq + u] = v;
        }
    __syncthreads();  // the buffer is read before a later head's load
  }
  store_sums(rep - 1);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = 16 * wm + gq + 4 * e, c = 32 * wn + 8 * jj + 2 * tq;
      *reinterpret_cast<float2*>(a.dg + out0 + static_cast<int64_t>(r) * p.qp + c) =
          make_float2(dg[0][jj][e], dg[0][jj][e + 1]);
    }
}

// -- 2. dx, ddt, ddA per (chunk, head) -----------------------------------------

// Shared memory of head_kernel, in floats: x's key tile (64 x P); a
// region that holds, inside the q loop, two buffers of Y's q tile (64 x
// P) and the G tile (64 x 64) and the W^T tile (64 x 64), and after the
// loop B's key tile (64 x N) and dS (P x N); then the chunk's rows.
template <int P, int N>
struct HeadSmem {
  static constexpr int XS = A_(P), YS = A_(P), GS = A_(kTile), WS = A_(kTile),
                       BS = A_(N), SS = A_(N);
  static constexpr int X = 0;
  static constexpr int REGION = X + kTile * XS;
  static constexpr int BUF = kTile * YS + kTile * GS;  // Y, then G
  static constexpr int WT = REGION + 2 * BUF;
  static constexpr int SG = REGION + kTile * BS;       // after the loop
  static constexpr int IN_LOOP = 2 * BUF + kTile * WS;
  static constexpr int AFTER = kTile * BS + P * SS;
  static constexpr int ROWS = REGION + (IN_LOOP > AFTER ? IN_LOOP : AFTER);
  // dA_cs, dt, sum_q M[q, j], f_j e_j (kMaxQ each); the key tile's e_j,
  // exp(s - a_j), sum_q dW G L (64 each); f by column warp (2 x 64)
  static constexpr int FLOATS = ROWS + 4 * kMaxQ + 3 * kTile + 2 * kTile;
  static constexpr int BYTES = FLOATS * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(P, N))
    head_kernel(const Args a) {
  using S = HeadSmem<P, N>;
  constexpr int NJP = P / 16;  // n8 tiles of a warp's half of P
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + S::X;
  float* wt = smem + S::WT;
  float* bs = smem + S::REGION;  // after the q loop
  float* sg = smem + S::SG;
  float* a_s = smem + S::ROWS;   // dA_cs of the chunk
  float* dt_s = a_s + kMaxQ;     // dt of the chunk
  float* col_m = dt_s + kMaxQ;   // sum_q M[q, j]
  float* fe = col_m + kMaxQ;     // f_j e_j
  float* e_s = fe + kMaxQ;       // the key tile's e_j
  float* ex_s = e_s + kTile;     // its exp(s - a_j)
  float* dd_s = ex_s + kTile;    // its sum_q dW G L
  float* part_f = dd_s + kTile;  // its f by column warp: 2 x 64

  const Params& p = a.p;
  const int bc = static_cast<int>(blockIdx.x) / p.H;
  const int h = static_cast<int>(blockIdx.x) % p.H;
  const int g = h / (p.H / p.G);
  const int Q = p.Q, nt = p.qp / kTile, pairs = nt * (nt + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 16 keys x P / 2 columns a warp
  const float* x = a.x + bc * p.x_sb + h * p.x_sh;
  const float* dy = a.dy + bc * p.dy_sb + h * p.dy_sh;
  const float* bm = a.b + bc * p.b_sb + g * p.b_sg;
  const float* gsm = a.gs + static_cast<int64_t>(bc * p.G + g) * p.qp * p.qp;
  // this head's sums of M and dW G L by tile pair (from pair_kernel)
  const float* msum = a.ms + (static_cast<int64_t>(bc) * p.H + h) * pairs * 3 * kTile;
  const int64_t row_out = static_cast<int64_t>(p.H);  // (BC, Q, H) row stride
  const int64_t out0 = static_cast<int64_t>(bc) * Q * p.H + h;

  for (int t = tid; t < kMaxQ; t += kThreads) {
    const bool in = t < Q;
    a_s[t] = in ? a.da[bc * p.da_sb + t * p.da_sq + h * p.da_sh] : 0.f;
    dt_s[t] = in ? a.dt[bc * p.dt_sb + t * p.dt_sq + h * p.dt_sh] : 0.f;
  }
  __syncthreads();
  const float s_last = a_s[Q - 1];
  // this thread's keys of a key tile: 16 wm + gq and + 8
  const int kr0 = 16 * wm + gq, kr1 = kr0 + 8;
  // Y's q tile qt and the G tile (qt, jt) into buffer `buf`
  auto load_step = [&](int qt, int jt, int buf) {
    float* ys = smem + S::REGION + buf * S::BUF;
    load_rows<P>(ys, S::YS, dy, p.dy_sq, qt * kTile, kTile, Q);
    load_rows<kTile>(ys + kTile * S::YS, S::GS,
                     gsm + static_cast<int64_t>(qt * kTile) * p.qp + jt * kTile, p.qp, 0,
                     kTile, kTile);
  };

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kTile;
    load_rows<P>(xs, S::XS, x, p.x_sq, j0, kTile, Q);
    load_step(jt, jt, 0);
    cp_async_commit();
    float dxa[1][NJP][4];
    zero(dxa);
    for (int qt = jt; qt < nt; ++qt) {
      const int q0 = qt * kTile, buf = (qt - jt) & 1;
      // the next q tile's Y and G load while this one multiplies
      if (qt + 1 < nt) {
        load_step(qt + 1, jt, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ys = smem + S::REGION + buf * S::BUF;
      const float* gt = ys + kTile * S::YS;
      // W^T[j][q] = G[q][j] L[q, j] dt_j: this thread's two keys, by q
      // columns 32 wn + 4 i + tq
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kr = u ? kr1 : kr0, j = j0 + kr;
        const float aj = a_s[j], dtj = dt_s[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int qc = 32 * wn + 4 * i + tq, q = q0 + qc;
          // the exponent only on and below the diagonal, inside the chunk
          const bool live = j <= q && q < Q;
          const float ex = live ? (a_s[q] - aj) * kLog2e : -INFINITY;
          wt[kr * S::WS + qc] = gt[qc * S::GS + kr] * fast_exp2(ex) * dtj;
        }
      }
      __syncthreads();
      // dx_j += W^T . Y_q: keys 16 wm .., P columns (P / 2) wn ..
      {
        const float* yb = ys + (P / 2) * wn;
        mma3<1, NJP, kTile>(dxa, KRows{wt + 16 * wm * S::WS, S::WS},
                            [&](int k, int n) { return yb[k * S::YS + n]; });
      }
      __syncthreads();  // the buffer and wt are read
    }

    // B's key tile and dS; the key tile's sums over q from pair_kernel's
    // (in q tile order); e and exp(s - a_j)
    load_rows<N>(bs, S::BS, bm, p.b_sq, j0, kTile, Q);
    load_rows<N>(sg, S::SS, a.ds + bc * p.ds_sb + h * p.ds_sh, p.ds_sp, 0, P, P);
    cp_async_commit();
    if (tid < 2 * kTile) {
      const int which = 1 + tid / kTile, i = tid % kTile;
      float v = 0.f;
      for (int qt = jt; qt < nt; ++qt)
        v += msum[((qt * (qt + 1)) / 2 + jt) * 3 * kTile + which * kTile + i];
      if (which == 1)
        col_m[j0 + i] = v;
      else
        dd_s[i] = v;
    } else if (tid < 3 * kTile) {
      const int i = tid - 2 * kTile, j = j0 + i;
      const float ex = j < Q ? fast_exp2((s_last - a_s[j]) * kLog2e) : 0.f;
      ex_s[i] = ex;
      e_s[i] = ex * dt_s[j];
    }
    cp_async_wait<0>();
    __syncthreads();
    // u = B_j . dS^T: dx_j += e_j u, f_j = sum_p x_j u
    {
      float uu[1][NJP][4];
      zero(uu);
      mma3<1, NJP, N>(uu, KRows{bs + 16 * wm * S::BS, S::BS},
                      KRows{sg + (P / 2) * wn * S::SS, S::SS});
      const float e0 = e_s[kr0], e1 = e_s[kr1];
      float fp[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < NJP; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = (e & 2) ? kr1 : kr0;
          const int pc = (P / 2) * wn + 8 * jj + 2 * tq + (e & 1);
          dxa[0][jj][e] = fmaf((e & 2) ? e1 : e0, uu[0][jj][e], dxa[0][jj][e]);
          fp[e >> 1] = fmaf(xs[kr * S::XS + pc], uu[0][jj][e], fp[e >> 1]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = sum_t(fp[u]);
        if (tq == 0) part_f[wn * kTile + kr0 + 8 * u] = v;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + kr0 + 8 * u;
        if (j < Q) {
          float* out = a.dx + ((static_cast<int64_t>(bc) * Q + j) * p.H + h) * P +
                       (P / 2) * wn + 2 * tq;
#pragma unroll
          for (int jj = 0; jj < NJP; ++jj)
            *reinterpret_cast<float2*>(out + 8 * jj) =
                make_float2(dxa[0][jj][2 * u], dxa[0][jj][2 * u + 1]);
        }
      }
    }
    __syncthreads();
    if (tid < kTile && j0 + tid < Q) {
      const int j = j0 + tid;
      const float f = part_f[tid] + part_f[kTile + tid];
      a.ddt[out0 + j * row_out] = dd_s[tid] + f * ex_s[tid];
      fe[j] = f * e_s[tid];
    }
    __syncthreads();  // xs, bs, sg and the key tile's rows are read
  }
  // ddA_k = sum_j M[k, j] (pair_kernel's, in key tile order) - sum_q M[q, k]
  // - f_k e_k (+ sum_j f_j e_j at k = Q - 1)
  if (tid < Q) {
    const int qt = tid / kTile, i = tid % kTile;
    float row_m = 0.f;
    for (int jt = 0; jt <= qt; ++jt)
      row_m += msum[((qt * (qt + 1)) / 2 + jt) * 3 * kTile + i];
    float d = row_m - col_m[tid] - fe[tid];
    if (tid == Q - 1) {
      float total = 0.f;
      for (int j = 0; j < Q; ++j) total += fe[j];
      d += total;
    }
    a.dda[out0 + tid * row_out] = d;
  }
}

// -- 3. dC and dB per (chunk, group, 64-row tile, 64 columns of N) -------------

// Shared memory of group_kernel, in floats: the dG tile (64 x 64) and the
// B or C tile's columns (64 x NB), then for dB kGroupStages buffers of a
// head's x tile (64 x P), dS columns (P x NB) and dA_cs and dt rows.
template <int P, int N>
struct GroupSmem {
  static constexpr int NB = N < kNB ? N : kNB;
  static constexpr int DGS = A_(kTile);  // dC reads it by rows (A(q, j))
  static constexpr int DGT = B_(kTile);  // dB by columns (A(j, q) = dG[q][j])
  static constexpr int MS = B_(NB);      // B (k = j) or C (k = q) columns
  static constexpr int XS = A_(P), SS = B_(NB);
  static constexpr int VEC = 2 * kTile + 1;  // dA_cs and dt of the keys, dA_cs[Q-1]
  static constexpr int BUF = kTile * XS + P * SS + VEC + 3;  // 16-byte aligned
  static constexpr int PHASE1 = kTile * DGT + kTile * MS;
  static constexpr int FLOATS =
      PHASE1 > kGroupStages * BUF ? PHASE1 : kGroupStages * BUF;
  static constexpr int BYTES = FLOATS * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2) group_kernel(const Args a) {
  using S = GroupSmem<P, N>;
  constexpr int NB = S::NB, NJ = NB / 16, NCH = N / NB;
  extern __shared__ __align__(16) float smem[];
  const Params& p = a.p;
  const int nt = p.qp / kTile;
  // the dB blocks first: they walk the group's heads
  const int per_kind = p.BC * p.G * nt * NCH;
  int idx = static_cast<int>(blockIdx.x);
  const bool is_db = idx < per_kind;
  if (!is_db) idx -= per_kind;
  const int n0 = (idx % NCH) * NB;
  idx /= NCH;
  const int t = idx % nt;
  idx /= nt;
  const int g = idx % p.G, bc = idx / p.G;
  const int rep = p.H / p.G, h0 = g * rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 16 rows x NB / 2 columns a warp
  const float* dgm = a.dg + static_cast<int64_t>(bc * p.G + g) * p.qp * p.qp;
  float acc[1][NJ][4];
  zero(acc);

  float* st = smem;                       // the dG tile
  float* ms = smem + kTile * S::DGT;      // B's or C's columns
  const int stride = is_db ? S::DGT : S::DGS;
  // dC (rows of q tile t): sum over key tiles o <= t of dG[t, o] . B_o;
  // dB (keys of tile t): sum over q tiles o >= t of dG[o, t]^T . C_o
  const int first = is_db ? t : 0, last = is_db ? nt : t + 1;
  for (int o = first; o < last; ++o) {
    const int qt = is_db ? o : t, jt = is_db ? t : o;
    load_rows<kTile>(st, stride,
                     dgm + static_cast<int64_t>(qt * kTile) * p.qp + jt * kTile, p.qp,
                     0, kTile, kTile);
    if (is_db)
      load_rows<NB>(ms, S::MS, a.c + bc * p.c_sb + g * p.c_sg + n0, p.c_sq, qt * kTile,
                    kTile, p.Q);
    else
      load_rows<NB>(ms, S::MS, a.b + bc * p.b_sb + g * p.b_sg + n0, p.b_sq, jt * kTile,
                    kTile, p.Q);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* mb = ms + (NB / 2) * wn;
    if (is_db) {
      const float* sa = st + 16 * wm;
      mma3<1, NJ, kTile>(acc, [&](int m, int k) { return sa[k * S::DGT + m]; },
                  [&](int k, int n) { return mb[k * S::MS + n]; });
    } else {
      const float* sa = st + 16 * wm * S::DGS;
      mma3<1, NJ, kTile>(acc, KRows{sa, S::DGS},
                  [&](int k, int n) { return mb[k * S::MS + n]; });
    }
    __syncthreads();
  }

  const int r0 = t * kTile + 16 * wm + gq;  // this thread's rows r0, r0 + 8
  if (is_db) {
    // + sum over the group's heads, in order, of (e_h o x_h) . dS_h
    const int j0 = t * kTile;
    auto load = [&](int hh, int buf) {
      float* xs = smem + buf * S::BUF;
      float* ss = xs + kTile * S::XS;
      float* vs = ss + P * S::SS;
      const int h = h0 + hh;
      load_rows<P>(xs, S::XS, a.x + bc * p.x_sb + h * p.x_sh, p.x_sq, j0, kTile, p.Q);
      load_rows<NB>(ss, S::SS, a.ds + bc * p.ds_sb + h * p.ds_sh + n0, p.ds_sp, 0, P, P);
      const float* da = a.da + bc * p.da_sb + h * p.da_sh;
      load_vec(vs, da, p.da_sq, j0, kTile, p.Q, 0);
      load_vec(vs + kTile, a.dt + bc * p.dt_sb + h * p.dt_sh, p.dt_sq, j0, kTile, p.Q,
               kTile);
      load_vec(vs + 2 * kTile, da, p.da_sq, p.Q - 1, 1, p.Q, 2 * kTile);
    };
    for (int hh = 0; hh < kGroupStages - 1; ++hh) {
      if (hh < rep) load(hh, hh);
      cp_async_commit();  // empty past the last head: one group a head
    }
    for (int hh = 0; hh < rep; ++hh) {
      const int ahead = hh + kGroupStages - 1;
      if (ahead < rep) load(ahead, ahead % kGroupStages);
      cp_async_commit();
      cp_async_wait<kGroupStages - 1>();  // head hh's group has landed
      __syncthreads();
      const float* xs = smem + (hh % kGroupStages) * S::BUF;
      const float* ss = xs + kTile * S::XS;
      const float* vs = ss + P * S::SS;
      const float s_last = vs[2 * kTile];
      const float* xa = xs + 16 * wm * S::XS;
      const float* sb = ss + (NB / 2) * wn;
      // e_j = exp(s - a_j) dt_j of the two keys whose A elements this
      // thread reads (rows gq and gq + 8 of the warp's 16), 0 past Q
      float ew[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = 16 * wm + gq + 8 * u;
        ew[u] = j0 + m < p.Q ? fast_exp2((s_last - vs[m]) * kLog2e) * vs[kTile + m] : 0.f;
      }
      mma3<1, NJ, P>(acc, KRowsScaled{xa, S::XS, {ew[0], ew[1]}},
                     [&](int k, int n) { return sb[k * S::SS + n]; });
      __syncthreads();  // the buffer is read before a later head's load
    }
  }
  float* out = is_db ? a.db : a.dc;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = r0 + 8 * u;
    if (row >= p.Q) continue;
    float* o = out + ((static_cast<int64_t>(bc) * p.Q + row) * p.G + g) * N + n0 +
               (NB / 2) * wn + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      *reinterpret_cast<float2*>(o + 8 * jj) =
          make_float2(acc[0][jj][2 * u], acc[0][jj][2 * u + 1]);
  }
}

template <int P, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static PerDevice configured;  // the shared-memory opt-ins, per device
  cudaError_t e = configured.once(a.p.device, [] {
    cudaError_t err = cudaFuncSetAttribute(pair_kernel<P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           PairSmem<P, N>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(head_kernel<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 HeadSmem<P, N>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(group_kernel<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 GroupSmem<P, N>::BYTES);
    return err;
  });
  if (e != cudaSuccess) return e;
  pair_kernel<P, N><<<a.p.pair_blocks, kThreads, PairSmem<P, N>::BYTES, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  head_kernel<P, N><<<a.p.head_blocks, kThreads, HeadSmem<P, N>::BYTES, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  group_kernel<P, N><<<a.p.group_blocks, kThreads, GroupSmem<P, N>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(const Args& a, cudaStream_t stream) {
  switch (a.p.N) {
    case 16:
      return launch<P, 16>(a, stream);
    case 32:
      return launch<P, 32>(a, stream);
    case 64:
      return launch<P, 64>(a, stream);
    case 128:
      return launch<P, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ssd_bwd

using ssd_bwd::Params;

static_assert(sizeof(Params) == 216 && offsetof(Params, device) == 168 &&
                  offsetof(Params, pair_blocks) == 200,
              "Params must match the wrapper's ctypes structure");

// dx, ddt, ddA_cs, dB and dC of the SSD chunk step from its f32 inputs and
// the gradients dy (of y_diag) and dS (of the states), on `stream`, in three
// launches, without synchronising.  Strides in elements (the last dim of x,
// B, C, dy and dS contiguous, every base and row 16-byte aligned); the
// outputs and the scratch gs, dg and ms are contiguous, of the sizes in
// Args.
// 1 <= Q <= 256, P and N in {16, 32, 64, 128}, G dividing H.  Returns a
// cudaError_t.
extern "C" int ssd_chunk_bwd_launch(const Params* p, const float* x,
                                    const float* dt, const float* da,
                                    const float* b, const float* c,
                                    const float* dy, const float* ds, float* dx,
                                    float* ddt, float* dda, float* db, float* dc,
                                    float* gs, float* dg, float* ms,
                                    cudaStream_t stream) {
  if (p->BC <= 0 || p->H <= 0) return cudaSuccess;
  const int nt = (p->Q + ssd_bwd::kTile - 1) / ssd_bwd::kTile;
  const int nch = p->N > ssd_bwd::kNB ? p->N / ssd_bwd::kNB : 1;
  if (p->Q < 1 || p->Q > ssd_bwd::kMaxQ || p->device < 0 ||
      p->device >= kMaxDevices || p->G < 1 || p->H % p->G != 0 ||
      p->qp != nt * ssd_bwd::kTile ||
      p->pair_blocks != p->BC * p->G * (nt * (nt + 1) / 2) ||
      p->head_blocks != p->BC * p->H || p->group_blocks != 2 * p->BC * p->G * nt * nch) {
    return cudaErrorInvalidValue;
  }
  const ssd_bwd::Args a{x, dt, da, b, c, dy, ds, dx, ddt, dda, db, dc, gs, dg, ms, *p};
  switch (p->P) {
    case 16:
      return ssd_bwd::dispatch_n<16>(a, stream);
    case 32:
      return ssd_bwd::dispatch_n<32>(a, stream);
    case 64:
      return ssd_bwd::dispatch_n<64>(a, stream);
    case 128:
      return ssd_bwd::dispatch_n<128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_chunk_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
