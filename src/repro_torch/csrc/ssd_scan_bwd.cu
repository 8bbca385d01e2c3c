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
//   dC    = dG.B,   dB = dG^T.C + sum_h e o (x.Sg)
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
// Three launches a call, in order on the caller's stream, each one block
// of 256 threads (a 16 x 16 grid; a thread owns 4 rows, 16 apart, of a
// 64-row tile and every 16th column):
//   1. cb_kernel, per (chunk, group, 64 x 64 tile pair on or below the
//      diagonal): G = C.B^T into f32 scratch gs (BC, G, Qp, Qp), Qp = Q
//      rounded up to 64.
//   2. head_kernel, per (chunk, head): walks the key tiles j, and for each
//      the q tiles at or below it, in order.  It keeps dx's key tile in
//      registers, writes dG's tile into the per-head scratch dgh (BC, H,
//      Qp, Qp), sums M's rows and columns and ddt's y part in shared
//      memory, then adds the state terms (B.Sg^T, x.Sg) of the key tile
//      and writes e o (x.Sg) into the per-head scratch dbs (BC, H, Qp, N).
//      dx, ddt and ddA are per head and leave this kernel final.
//   3. group_kernel, per (chunk, group, 64-row tile, dC or dB): sums the
//      group's heads' dG tiles in head order, then runs dC = dG.B (the
//      tile's rows) or dB = dG^T.C plus the heads' dbs rows (the tile's
//      keys), once per group: mamba2-2.7b's one group read by 80 heads
//      takes its N-wide products once, as the forward shares C.B^T.
// No atomics: every sum runs in one fixed order (over a tile, the 16
// column threads by a shuffle tree, the 16 row threads in row order; over
// tiles, in tile order; over heads, in head order), so the same inputs
// give the same bytes, which a training run resumed from a checkpoint
// relies on.  With per-head B/C (G = H) a group is one head, and the same
// code runs.
//
// What bounds it: at the mamba2-2.7b training shape (a 4096-token
// microbatch: BC 16, Q 256, H 80, P 64, N 128, G 1) the per-head products
// (dW, W^T.Y, B.Sg^T, x.Sg) are 21.5 GFLOP and the group's 0.4, against
// 0.31 GB of inputs and outputs (x, dy and dx 84 MB each, dS 42 MB), so the
// memory rate (0.092 ms at 3.35 TB/s; 0.044 ms for the operations at the
// TF32 peak).  This first version runs f32 FMAs on CUDA cores and moves
// dG and e o (x.Sg) through 0.5 GB of scratch, far above that bound: a
// later redesign would keep dG on chip and put the products on the
// tensor cores.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "per_device.h"

namespace ssd_bwd {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows of a q tile and of a key tile
constexpr int kLanes = 16;  // column threads of a tile (and row threads)
constexpr int kMaxQ = 256;
constexpr int kTL = kTile + 1;  // row stride of a 64 x 64 tile in shared memory

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
  int32_t cb_blocks, head_blocks, group_blocks, pad_;
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
  float* dgh;       // scratch (BC, H, Qp, Qp): dG per head, the same tiles
  float* dbs;       // scratch (BC, H, Qp, N): e o (x.dS) per head
  Params p;
};

// Rows [row0, row0 + 64) of a (rows x W) f32 matrix whose rows lie `sq`
// elements apart (its last dim contiguous) into shared memory rows W + 1
// floats apart; rows at or past `valid` fill with zeros.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t sq, int row0, int valid) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W, col = e % W, row = row0 + r;
    dst[r * (W + 1) + col] = row < valid ? src[row * sq + col] : 0.f;
  }
}

// The sum over the 16 column threads of a row (lanes that differ in their
// low four bits), in a fixed tree order; every lane gets it.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = kLanes / 2; off; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
constexpr int cb_bytes() {
  return 2 * kTile * (N + 1) * 4;
}

// G tile (qt, jt) of one chunk and group: G[q, j] = C_q . B_j.
template <int N>
__global__ void __launch_bounds__(kThreads) cb_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int BL = N + 1;
  float* cs = smem;
  float* bs = smem + kTile * BL;
  const Params& p = a.p;
  const int nt = p.qp / kTile, pairs = nt * (nt + 1) / 2;
  int idx = static_cast<int>(blockIdx.x);
  int rem = idx % pairs;
  idx /= pairs;
  const int g = idx % p.G, bc = idx / p.G;
  int qt = 0;
  while (rem > qt) rem -= ++qt;
  const int jt = rem;
  load_tile<N>(cs, a.c + bc * p.c_sb + g * p.c_sg, p.c_sq, qt * kTile, p.Q);
  load_tile<N>(bs, a.b + bc * p.b_sb + g * p.b_sg, p.b_sq, jt * kTile, p.Q);
  __syncthreads();
  const int ty = threadIdx.x / kLanes, tx = threadIdx.x % kLanes;
  float acc[4][4] = {};
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + kLanes * i) * BL + n];
#pragma unroll
    for (int k = 0; k < 4; ++k) bv[k] = bs[(tx + kLanes * k) * BL + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(cv[i], bv[k], acc[i][k]);
  }
  float* out = a.gs + (static_cast<int64_t>(bc * p.G + g) * p.qp + qt * kTile) * p.qp +
               jt * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[(ty + kLanes * i) * p.qp + tx + kLanes * k] = acc[i][k];
}

// Shared memory of head_kernel, in floats: the key tile of x, then a region
// that holds Y's q tile, the G tile and the W tile inside the q loop and
// B's key tile and dS after it, then the per-chunk rows.
template <int P, int N>
__host__ __device__ constexpr int head_region() {
  constexpr int in_loop = kTile * (P + 1) + 2 * kTile * kTL;
  constexpr int after = kTile * (N + 1) + P * (N + 1);
  return in_loop > after ? in_loop : after;
}
constexpr int kHeadRows = 5 * kMaxQ + 4 * kTile + 2 * kLanes * kTile;

template <int P, int N>
constexpr int head_bytes() {
  return (kTile * (P + 1) + head_region<P, N>() + kHeadRows) * 4;
}

// Everything of one (chunk, head) but dC and dB, which sum over a group.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2) head_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int XL = P + 1, BL = N + 1, PK = P / kLanes, NK = N / kLanes;
  float* xs = smem;  // x's key tile: 64 x XL
  float* region = xs + kTile * XL;
  float* ys = region;            // Y's q tile: 64 x XL
  float* gt = ys + kTile * XL;   // G tile: 64 x kTL
  float* wt = gt + kTile * kTL;  // W tile: 64 x kTL
  float* bsm = region;           // B's key tile: 64 x BL (after the q loop)
  float* ssm = bsm + kTile * BL; // dS: P x BL
  float* a_s = region + head_region<P, N>();  // dA_cs of the chunk
  float* dt_s = a_s + kMaxQ;                  // dt of the chunk
  float* row_m = dt_s + kMaxQ;                // sum_j M[q, j]
  float* col_m = row_m + kMaxQ;               // sum_q M[q, j]
  float* fe = col_m + kMaxQ;                  // f_j e_j
  float* e_s = fe + kMaxQ;                    // the key tile's e_j
  float* ex_s = e_s + kTile;                  // its exp(s - a_j)
  float* f_s = ex_s + kTile;                  // its f_j
  float* dd_s = f_s + kTile;                  // its sum_q dW G L
  float* red = dd_s + kTile;                  // 2 x 16 x 64 column partials

  const Params& p = a.p;
  const int bc = static_cast<int>(blockIdx.x) / p.H;
  const int h = static_cast<int>(blockIdx.x) % p.H;
  const int g = h / (p.H / p.G);
  const int Q = p.Q, nt = p.qp / kTile;
  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;
  const float* x = a.x + bc * p.x_sb + h * p.x_sh;
  const float* dy = a.dy + bc * p.dy_sb + h * p.dy_sh;
  const float* bm = a.b + bc * p.b_sb + g * p.b_sg;
  const float* ds = a.ds + bc * p.ds_sb + h * p.ds_sh;
  const float* gs = a.gs + static_cast<int64_t>(bc * p.G + g) * p.qp * p.qp;
  float* dgh = a.dgh + static_cast<int64_t>(bc * p.H + h) * p.qp * p.qp;
  float* dbs = a.dbs + static_cast<int64_t>(bc * p.H + h) * p.qp * N;
  const int64_t row_out = static_cast<int64_t>(p.H);  // (BC, Q, H) row stride
  const int64_t out0 = static_cast<int64_t>(bc) * Q * p.H + h;

  for (int t = tid; t < kMaxQ; t += kThreads) {
    const bool in = t < Q;
    a_s[t] = in ? a.da[bc * p.da_sb + t * p.da_sq + h * p.da_sh] : 0.f;
    dt_s[t] = in ? a.dt[bc * p.dt_sb + t * p.dt_sq + h * p.dt_sh] : 0.f;
    row_m[t] = 0.f;
  }
  __syncthreads();
  const float s_last = a_s[Q - 1];

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kTile;
    load_tile<P>(xs, x, p.x_sq, j0, Q);
    float dxa[4][PK] = {};  // dx rows j0 + ty + 16 i, columns tx + 16 k
    float colp[4] = {}, ddp[4] = {};  // columns j0 + tx + 16 k
    for (int qt = jt; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      load_tile<P>(ys, dy, p.dy_sq, q0, Q);
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, col = e % kTile;
        gt[r * kTL + col] = gs[static_cast<int64_t>(q0 + r) * p.qp + j0 + col];
      }
      __syncthreads();
      // dW = Y_q . x_j^T
      float dw[4][4] = {};
#pragma unroll 4
      for (int pp = 0; pp < P; ++pp) {
        float yv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = ys[(ty + kLanes * i) * XL + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = xs[(tx + kLanes * k) * XL + pp];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) dw[i][k] = fmaf(yv[i], xv[k], dw[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = ty + kLanes * i, q = q0 + ql;
        const float aq = a_s[q];
        float rowp = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int jl = tx + kLanes * k, j = j0 + jl;
          // the exponent only on and below the diagonal, inside the chunk
          const float L = expf(j <= q && q < Q ? aq - a_s[j] : -INFINITY);
          const float gl = gt[ql * kTL + jl] * L;
          const float w = gl * dt_s[j];
          const float m = dw[i][k] * w;
          dgh[static_cast<int64_t>(q) * p.qp + j] = dw[i][k] * L * dt_s[j];
          wt[ql * kTL + jl] = w;
          rowp += m;
          colp[k] += m;
          ddp[k] = fmaf(dw[i][k], gl, ddp[k]);
        }
        rowp = row_sum16(rowp);
        if (tx == 0) row_m[q] += rowp;
      }
      __syncthreads();
      // dx_j += W^T . Y_q
#pragma unroll 4
      for (int ql = 0; ql < kTile; ++ql) {
        float wv[4], yv[PK];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = wt[ql * kTL + ty + kLanes * i];
#pragma unroll
        for (int k = 0; k < PK; ++k) yv[k] = ys[ql * XL + tx + kLanes * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < PK; ++k) dxa[i][k] = fmaf(wv[i], yv[k], dxa[i][k]);
      }
      __syncthreads();
    }

    // the key tile's column sums over the 16 row threads, and its state terms
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[ty * kTile + tx + kLanes * k] = colp[k];
      red[(kLanes + ty) * kTile + tx + kLanes * k] = ddp[k];
    }
    load_tile<N>(bsm, bm, p.b_sq, j0, Q);
    for (int e = tid; e < P * N; e += kThreads) {
      const int pp = e / N, n = e % N;
      ssm[pp * BL + n] = ds[pp * p.ds_sp + n];
    }
    if (tid < kTile) {
      const int j = j0 + tid;
      const float ex = j < Q ? expf(s_last - a_s[j]) : 0.f;
      ex_s[tid] = ex;
      e_s[tid] = ex * dt_s[j];
    }
    __syncthreads();
    if (tid < kTile) {
      float sum = 0.f;
      for (int r = 0; r < kLanes; ++r) sum += red[r * kTile + tid];
      col_m[j0 + tid] = sum;
    } else if (tid < 2 * kTile) {
      float sum = 0.f;
      for (int r = 0; r < kLanes; ++r) sum += red[(kLanes + r) * kTile + tid - kTile];
      dd_s[tid - kTile] = sum;
    }
    // u = B_j . dS^T: dx_j += e_j u, f_j = sum_p x_j u
    {
      float u[4][PK] = {};
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float bv[4], sv[PK];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = bsm[(ty + kLanes * i) * BL + n];
#pragma unroll
        for (int k = 0; k < PK; ++k) sv[k] = ssm[(tx + kLanes * k) * BL + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < PK; ++k) u[i][k] = fmaf(bv[i], sv[k], u[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jl = ty + kLanes * i, j = j0 + jl;
        const float e = e_s[jl];
        float fp = 0.f;
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          dxa[i][k] = fmaf(e, u[i][k], dxa[i][k]);
          fp = fmaf(xs[jl * XL + tx + kLanes * k], u[i][k], fp);
        }
        fp = row_sum16(fp);
        if (tx == 0) f_s[jl] = fp;
        if (j < Q) {
          float* out = a.dx + ((static_cast<int64_t>(bc) * Q + j) * p.H + h) * P;
#pragma unroll
          for (int k = 0; k < PK; ++k) out[tx + kLanes * k] = dxa[i][k];
        }
      }
    }
    // v = x_j . dS: this head's part of dB, e_j v, into dbs
    {
      float v[4][NK] = {};
#pragma unroll 2
      for (int pp = 0; pp < P; ++pp) {
        float xv[4], sv[NK];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + kLanes * i) * XL + pp];
#pragma unroll
        for (int k = 0; k < NK; ++k) sv[k] = ssm[pp * BL + tx + kLanes * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < NK; ++k) v[i][k] = fmaf(xv[i], sv[k], v[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jl = ty + kLanes * i, j = j0 + jl;
        if (j < Q) {
          const float e = e_s[jl];
#pragma unroll
          for (int k = 0; k < NK; ++k)
            dbs[static_cast<int64_t>(j) * N + tx + kLanes * k] = e * v[i][k];
        }
      }
    }
    __syncthreads();
    if (tid < kTile && j0 + tid < Q) {
      const int j = j0 + tid;
      a.ddt[out0 + j * row_out] = dd_s[tid] + f_s[tid] * ex_s[tid];
      fe[j] = f_s[tid] * e_s[tid];
    }
    __syncthreads();
  }
  if (tid < Q) {
    float d = row_m[tid] - col_m[tid] - fe[tid];
    if (tid == Q - 1) {
      float total = 0.f;
      for (int j = 0; j < Q; ++j) total += fe[j];
      d += total;
    }
    a.dda[out0 + tid * row_out] = d;
  }
}

template <int N>
constexpr int group_bytes() {
  return (kTile * kTL + kTile * (N + 1)) * 4;
}

// dC (the rows of tile t) or dB (the keys of tile t) of one chunk and
// group, from the group's heads' dG tiles summed in head order.
template <int N>
__global__ void __launch_bounds__(kThreads) group_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int BL = N + 1, NK = N / kLanes;
  float* st = smem;               // the heads' dG tile, summed: 64 x kTL
  float* ms = st + kTile * kTL;   // B's key tile (dC) or C's q tile (dB)
  const Params& p = a.p;
  const int nt = p.qp / kTile;
  int idx = static_cast<int>(blockIdx.x);
  const bool is_db = idx & 1;
  idx >>= 1;
  const int t = idx % nt;
  idx /= nt;
  const int g = idx % p.G, bc = idx / p.G;
  const int rep = p.H / p.G, h0 = g * rep;
  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;
  // dC reads row r of the summed tile, dB its column r
  const int l_stride = is_db ? kTL : 1, r_stride = is_db ? 1 : kTL;
  float acc[4][NK] = {};
  const int first = is_db ? t : 0, last = is_db ? nt : t + 1;
  for (int o = first; o < last; ++o) {
    const int qt = is_db ? o : t, jt = is_db ? t : o;
    float sum[kTile * kTile / kThreads] = {};
    for (int hh = 0; hh < rep; ++hh) {
      const float* src = a.dgh +
                         (static_cast<int64_t>(bc * p.H + h0 + hh) * p.qp + qt * kTile) * p.qp +
                         jt * kTile;
#pragma unroll
      for (int m = 0; m < kTile * kTile / kThreads; ++m) {
        const int e = tid + kThreads * m;
        sum[m] += src[(e / kTile) * p.qp + e % kTile];
      }
    }
#pragma unroll
    for (int m = 0; m < kTile * kTile / kThreads; ++m) {
      const int e = tid + kThreads * m;
      st[(e / kTile) * kTL + e % kTile] = sum[m];
    }
    if (is_db)
      load_tile<N>(ms, a.c + bc * p.c_sb + g * p.c_sg, p.c_sq, qt * kTile, p.Q);
    else
      load_tile<N>(ms, a.b + bc * p.b_sb + g * p.b_sg, p.b_sq, jt * kTile, p.Q);
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kTile; ++l) {
      float sv[4], mv[NK];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = st[l * l_stride + (ty + kLanes * i) * r_stride];
#pragma unroll
      for (int k = 0; k < NK; ++k) mv[k] = ms[l * BL + tx + kLanes * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[i][k] = fmaf(sv[i], mv[k], acc[i][k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t * kTile + ty + kLanes * i;
    if (row >= p.Q) continue;
    if (is_db) {
      for (int hh = 0; hh < rep; ++hh) {
        const float* src = a.dbs + (static_cast<int64_t>(bc * p.H + h0 + hh) * p.qp + row) * N;
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[i][k] += src[tx + kLanes * k];
      }
    }
    float* out = (is_db ? a.db : a.dc) +
                 ((static_cast<int64_t>(bc) * p.Q + row) * p.G + g) * N;
#pragma unroll
    for (int k = 0; k < NK; ++k) out[tx + kLanes * k] = acc[i][k];
  }
}

template <int P, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static PerDevice configured;  // the shared-memory opt-ins, per device
  cudaError_t e = configured.once(a.p.device, [] {
    cudaError_t err = cudaFuncSetAttribute(
        cb_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, cb_bytes<N>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(head_kernel<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 head_bytes<P, N>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(group_kernel<N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 group_bytes<N>());
    return err;
  });
  if (e != cudaSuccess) return e;
  cb_kernel<N><<<a.p.cb_blocks, kThreads, cb_bytes<N>(), stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  head_kernel<P, N><<<a.p.head_blocks, kThreads, head_bytes<P, N>(), stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  group_kernel<N><<<a.p.group_blocks, kThreads, group_bytes<N>(), stream>>>(a);
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
                  offsetof(Params, cb_blocks) == 200,
              "Params must match the wrapper's ctypes structure");

// dx, ddt, ddA_cs, dB and dC of the SSD chunk step from its f32 inputs and
// the gradients dy (of y_diag) and dS (of the states), on `stream`, in three
// launches, without synchronising.  Strides in elements (the last dim of x,
// B, C, dy and dS contiguous); the outputs and the scratch gs, dgh and dbs
// are contiguous, of the sizes in Args.  1 <= Q <= 256, P and N in {16, 32,
// 64, 128}, G dividing H.  Returns a cudaError_t.
extern "C" int ssd_chunk_bwd_launch(const Params* p, const float* x,
                                    const float* dt, const float* da,
                                    const float* b, const float* c,
                                    const float* dy, const float* ds, float* dx,
                                    float* ddt, float* dda, float* db, float* dc,
                                    float* gs, float* dgh, float* dbs,
                                    cudaStream_t stream) {
  if (p->BC <= 0 || p->H <= 0) return cudaSuccess;
  const int nt = (p->Q + ssd_bwd::kTile - 1) / ssd_bwd::kTile;
  if (p->Q < 1 || p->Q > ssd_bwd::kMaxQ || p->device < 0 ||
      p->device >= kMaxDevices || p->G < 1 || p->H % p->G != 0 ||
      p->qp != nt * ssd_bwd::kTile ||
      p->cb_blocks != p->BC * p->G * (nt * (nt + 1) / 2) ||
      p->head_blocks != p->BC * p->H || p->group_blocks != p->BC * p->G * nt * 2) {
    return cudaErrorInvalidValue;
  }
  const ssd_bwd::Args a{x, dt, da, b, c, dy, ds, dx, ddt, dda, db, dc, gs, dgh, dbs, *p};
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
