// Flash attention backward on Hopper (sm_90a): dq, dk, dv of the forward
// in flash_attention.cu from q (B, Tq, H, D), k and v (B, Tk, Kv, D), the
// forward's output o and its per-row log-sum-exp `lse` (f32, (B, H, Tq)),
// and the output's gradient do, for causal or full attention with GQA, an
// optional softcap and sliding window.  Head dims D in {64, 128, 256}
// (square; MLA's (192, 128) is not built).  bf16, f16 and f32.
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
// Four launches a call, all on f32 CUDA-core FMAs out of shared memory
// (a first kernel, right before fast; tensor cores are later work):
//   1. delta_kernel: D = rowsum(do * o), one warp a row.
//   2. dkdv_kernel: one block per (kv tile, batch, query head) keeps its
//      tile's dk and dv in registers and walks the q tiles that see the
//      tile in order; it writes them, in f32, to a per-query-head slot.
//      (A block per kv head that also walked the H / Kv query heads would
//      leave most of the card idle at rep 8: 2 kv heads x 64 tiles.)
//   3. dq_kernel: one block per (q tile, batch, head) keeps dq in
//      registers and walks the kv tiles the q tile sees, in order.
//   4. reduce_kernel: dk, dv = the sum of the H / Kv per-head slots, in
//      head order, rounded to the input type.
// No atomics and no split whose order varies: the same inputs give the
// same bytes, which a training run resumed from a checkpoint relies on.
//
// Tiles: 64 keys x 64 query rows for D 64 and 128, 32 x 32 for D 256
// (shared memory: K, V, Q and do tiles of D + 1 floats a row, the +1 pad
// spreading column walks over the 32 banks; P and dy tiles).  256
// threads; causal and window blocks skip the tiles they cannot see, the
// heaviest blocks first.
//
// What bounds it: 5 products of 2 * D operations per (row, key) pair seen
// (QK^T, dO V^T, P^T dO, dy^T Q, dy K), 7 as run (dq_kernel recomputes QK^T
// and dO V^T), against reading q, k, v, o, do once and writing dq, dk, dv:
// at training shapes the operations.  On CUDA cores at f32 the kernel is
// far above the tensor cores' bound (PERF.md has its times).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "per_device.h"

namespace fa_bwd {

constexpr int kThreads = 256;  // 8 warps; a 16 x 16 grid of threads

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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;      // do, the output's gradient
  const float* lse;   // (B, H, Tq)
  float* delta;       // (B, H, Tq) scratch: rowsum(do * o)
  float* dk_part;     // (B, H, Tk, D) scratch: dk per query head
  float* dv_part;     // (B, H, Tk, D) scratch: dv per query head
  void* dq;           // (B, Tq, H, D), contiguous
  void* dk;           // (B, Tk, Kv, D), contiguous
  void* dv;           // (B, Tk, Kv, D), contiguous
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int64_t g_sb, g_st, g_sh;
  int B, Tq, Tk, H, Kv, D;
  float scale;
  float softcap;  // <= 0: off
  int causal;
  int window;  // <= 0: none
};

__device__ __forceinline__ bool sees(const Args& a, int row, int key) {
  bool live = row < a.Tq && key < a.Tk;
  if (a.causal) live = live && row >= key;
  if (a.window > 0) live = live && row - key < a.window;
  return live;
}

// -- 1. D = rowsum(do * o) -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args a) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.B) * a.Tq * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const int t = static_cast<int>((row / a.H) % a.Tq);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.H) * a.Tq));
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + t * a.o_st + h * a.o_sh;
  const T* g = static_cast<const T*>(a.g) + b * a.g_sb + t * a.g_st + h * a.g_sh;
  float s = 0.f;
  for (int d = lane; d < a.D; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[(static_cast<int64_t>(b) * a.H + h) * a.Tq + t] = s;
}

// -- shared tiles ---------------------------------------------------------------

// Shared memory of the dkdv and dq kernels, in floats: K and V tiles (BK
// rows), Q and do tiles (BQ rows), each D + 1 floats a row; P and dy tiles
// (BQ x (BK + 1)); and the q tile's lse and D (BQ each).
template <int D, int BK, int BQ>
struct Smem {
  static constexpr int RS = D + 1;   // row stride of the K, V, Q, do tiles
  static constexpr int PS = BK + 1;  // row stride of the P and dy tiles
  static constexpr int K = 0;
  static constexpr int V = K + BK * RS;
  static constexpr int Q = V + BK * RS;
  static constexpr int G = Q + BQ * RS;
  static constexpr int P = G + BQ * RS;
  static constexpr int S = P + BQ * PS;
  static constexpr int LSE = S + BQ * PS;
  static constexpr int DL = LSE + BQ;
  static constexpr int FLOATS = DL + BQ;
  static constexpr int BYTES = FLOATS * 4;
};

// rows [r0, r0 + ROWS) of a (tokens, D) slice with token stride `st` into
// a shared tile of row stride RS, as f32; rows at or past `n` read zeros
template <typename T, int D, int ROWS, int RS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t st,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * RS + d] = row < n ? to_f(src[row * st + d]) : 0.f;
  }
}

// S = Q.K^T and dP = do.V^T for one (q tile, kv tile) pair, then P and dy
// into the shared P and dy tiles.  Thread (ty, tx) takes rows ty + 16 i
// and keys tx + 16 j.
template <int D, int BK, int BQ>
__device__ __forceinline__ void scores(const Args& a, float* sm, int q0, int k0) {
  using L = Smem<D, BK, BQ>;
  constexpr int RI = BQ / 16, KJ = BK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* sQ = sm + L::Q;
  const float* sG = sm + L::G;
  const float* sK = sm + L::K;
  const float* sV = sm + L::V;
  float s[RI][KJ], dp[RI][KJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], gv[RI], kv[KJ], vv[KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = sQ[(ty + 16 * i) * L::RS + d];
      gv[i] = sG[(ty + 16 * i) * L::RS + d];
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      kv[j] = sK[(tx + 16 * j) * L::RS + d];
      vv[j] = sV[(tx + 16 * j) * L::RS + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
  const bool capped = a.softcap > 0.f;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const float lse = sm[L::LSE + r];
    const float del = sm[L::DL + r];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = tx + 16 * j;
      float y = s[i][j] * a.scale;
      float t = 0.f;
      if (capped) {
        t = tanhf(y / a.softcap);
        y = a.softcap * t;
      }
      const float p = sees(a, q0 + r, k0 + c) ? expf(y - lse) : 0.f;
      float dy = p * (dp[i][j] - del);
      if (capped) dy *= 1.f - t * t;
      sm[L::P + r * L::PS + c] = p;
      sm[L::S + r * L::PS + c] = dy;
    }
  }
}

// -- 2. dk, dv per (kv tile, batch, query head) ------------------------------------

template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using L = Smem<D, BK, BQ>;
  constexpr int KI = BK / 16, C = D / 16;
  extern __shared__ float sm[];
  const int BH = a.B * a.H;
  const int kt = blockIdx.x / BH;  // small kv tiles first: under a causal
  const int bh = blockIdx.x % BH;  // mask they see the most q tiles
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int k0 = kt * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* g = static_cast<const T*>(a.g) + b * a.g_sb + h * a.g_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Tq;

  load_tile<T, D, BK, L::RS>(sm + L::K, k, a.k_st, k0, a.Tk);
  load_tile<T, D, BK, L::RS>(sm + L::V, v, a.v_st, k0, a.Tk);

  // the q tiles with a row that sees a key of [k0, k0 + BK)
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  const int qt_begin = a.causal ? k0 / BQ : 0;
  int qt_end = n_qt;
  if (a.window > 0) qt_end = min(n_qt, (k0 + BK - 2 + a.window) / BQ + 1);

  float dk[KI][C], dv[KI][C];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous q tile is consumed
    load_tile<T, D, BQ, L::RS>(sm + L::Q, q, a.q_st, q0, a.Tq);
    load_tile<T, D, BQ, L::RS>(sm + L::G, g, a.g_st, q0, a.Tq);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < a.Tq;
      sm[L::LSE + r] = in ? lse[q0 + r] : INFINITY;
      sm[L::DL + r] = in ? delta[q0 + r] : 0.f;
    }
    __syncthreads();
    scores<D, BK, BQ>(a, sm, q0, k0);
    __syncthreads();
    // dv += P^T do, dk += dy^T q: thread (ty, tx) owns keys ty + 16 i and
    // columns tx + 16 c
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pk[KI], sk[KI], gc[C], qc[C];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pk[i] = sm[L::P + r * L::PS + ty + 16 * i];
        sk[i] = sm[L::S + r * L::PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gc[c] = sm[L::G + r * L::RS + tx + 16 * c];
        qc[c] = sm[L::Q + r * L::RS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv[i][c] = fmaf(pk[i], gc[c], dv[i][c]);
          dk[i][c] = fmaf(sk[i], qc[c], dk[i][c]);
        }
    }
  }

  float* dkp = a.dk_part + static_cast<int64_t>(bh) * a.Tk * D;
  float* dvp = a.dv_part + static_cast<int64_t>(bh) * a.Tk * D;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dkp[static_cast<int64_t>(key) * D + tx + 16 * c] = dk[i][c] * a.scale;
      dvp[static_cast<int64_t>(key) * D + tx + 16 * c] = dv[i][c];
    }
  }
}

// -- 3. dq per (q tile, batch, head) -------------------------------------------

template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using L = Smem<D, BK, BQ>;
  constexpr int RI = BQ / 16, C = D / 16;
  extern __shared__ float sm[];
  const int BH = a.B * a.H;
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  // causal: the last q tiles see the most kv tiles, so they run first
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) / BH
                          : static_cast<int>(blockIdx.x) / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* g = static_cast<const T*>(a.g) + b * a.g_sb + h * a.g_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, D, BQ, L::RS>(sm + L::Q, q, a.q_st, q0, a.Tq);
  load_tile<T, D, BQ, L::RS>(sm + L::G, g, a.g_st, q0, a.Tq);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < a.Tq;
    sm[L::LSE + r] = in ? a.lse[static_cast<int64_t>(bh) * a.Tq + q0 + r] : INFINITY;
    sm[L::DL + r] = in ? a.delta[static_cast<int64_t>(bh) * a.Tq + q0 + r] : 0.f;
  }

  // the kv tiles with a key that a row of [q0, q0 + BQ) sees
  const int n_kt = (a.Tk + BK - 1) / BK;
  int kt_end = n_kt;
  if (a.causal) kt_end = min(n_kt, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / BK : 0;

  float dq[RI][C];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous kv tile is consumed
    load_tile<T, D, BK, L::RS>(sm + L::K, k, a.k_st, k0, a.Tk);
    load_tile<T, D, BK, L::RS>(sm + L::V, v, a.v_st, k0, a.Tk);
    __syncthreads();
    scores<D, BK, BQ>(a, sm, q0, k0);
    __syncthreads();
    // dq += dy k: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sr[RI], kc[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) sr[i] = sm[L::S + (ty + 16 * i) * L::PS + j];
#pragma unroll
      for (int c = 0; c < C; ++c) kc[c] = sm[L::K + j * L::RS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) dq[i][c] = fmaf(sr[i], kc[c], dq[i][c]);
    }
  }

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Tq) continue;
    T* orow = out + ((static_cast<int64_t>(b) * a.Tq + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = from_f<T>(dq[i][c] * a.scale);
  }
}

// -- 4. dk, dv = the sum over a kv head's query heads ------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const Args a) {
  const int64_t n = static_cast<int64_t>(a.B) * a.Tk * a.Kv * a.D;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int d = static_cast<int>(idx % a.D);
  const int kvh = static_cast<int>((idx / a.D) % a.Kv);
  const int t = static_cast<int>((idx / (static_cast<int64_t>(a.D) * a.Kv)) % a.Tk);
  const int b = static_cast<int>(idx / (static_cast<int64_t>(a.D) * a.Kv * a.Tk));
  const int rep = a.H / a.Kv;
  float sk = 0.f, sv = 0.f;
  for (int r = 0; r < rep; ++r) {  // in head order: the same sum every call
    const int64_t at =
        ((static_cast<int64_t>(b) * a.H + kvh * rep + r) * a.Tk + t) * a.D + d;
    sk += a.dk_part[at];
    sv += a.dv_part[at];
  }
  static_cast<T*>(a.dk)[idx] = from_f<T>(sk);
  static_cast<T*>(a.dv)[idx] = from_f<T>(sv);
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

template <typename T, int D, int BK, int BQ>
cudaError_t launch_all(const Args& a, int device, cudaStream_t stream) {
  using L = Smem<D, BK, BQ>;
  static PerDevice dkdv_done, dq_done;  // the attributes, per kernel and device
  auto dkdv = dkdv_kernel<T, D, BK, BQ>;
  auto dq = dq_kernel<T, D, BK, BQ>;
  cudaError_t err = configure(dkdv, L::BYTES, device, dkdv_done);
  if (err != cudaSuccess) return err;
  err = configure(dq, L::BYTES, device, dq_done);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  delta_kernel<T><<<blocks(static_cast<int64_t>(BH) * a.Tq * 32), kThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<((a.Tk + BK - 1) / BK) * BH, kThreads, L::BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<((a.Tq + BQ - 1) / BQ) * BH, kThreads, L::BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<T><<<blocks(static_cast<int64_t>(a.B) * a.Tk * a.Kv * a.D), kThreads,
                     0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int device, cudaStream_t stream) {
  switch (a.D) {
    case 64:
      return launch_all<T, 64, 64, 64>(a, device, stream);
    case 128:
      return launch_all<T, 128, 64, 64>(a, device, stream);
    case 256:
      return launch_all<T, 256, 32, 32>(a, device, stream);
    default:
      return cudaErrorInvalidValue;
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
  int32_t B, Tq, Tk, H, Kv, D;
  int32_t causal;
  int32_t window;  // <= 0: none
  float scale;
  float softcap;  // <= 0: off
  int32_t device;
};
static_assert(sizeof(Params) == 168 && offsetof(Params, dtype) == 120 &&
                  offsetof(Params, scale) == 156 && offsetof(Params, device) == 164,
              "Params must match the wrapper's ctypes structure");

// dq (B, Tq, H, D), dk and dv (B, Tk, Kv, D), contiguous in the input type,
// from q, k, v, o, do (p->dtype, the head dim contiguous) and lse (f32, (B,
// H, Tq) contiguous), on `stream`, without synchronising.  `delta` (B, H,
// Tq) and `dk_part`, `dv_part` (B, H, Tk, D) are f32 scratch.  Returns a
// cudaError_t (cudaErrorInvalidValue for an unsupported dtype or D).
extern "C" int flash_attention_bwd_launch(const Params* p, const void* q,
                                          const void* k, const void* v,
                                          const void* o, const void* g,
                                          const float* lse, float* delta,
                                          float* dk_part, float* dv_part, void* dq,
                                          void* dk, void* dv, cudaStream_t stream) {
  if (p->B <= 0 || p->Tq <= 0 || p->Tk <= 0) return cudaSuccess;
  if (p->Kv <= 0 || p->H % p->Kv != 0 || p->device < 0 || p->device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const Args a{q,       k,       v,       o,       g,        lse,        delta,
               dk_part, dv_part, dq,      dk,      dv,       p->q_sb,    p->q_st,
               p->q_sh, p->k_sb, p->k_st, p->k_sh, p->v_sb,  p->v_st,    p->v_sh,
               p->o_sb, p->o_st, p->o_sh, p->g_sb, p->g_st,  p->g_sh,    p->B,
               p->Tq,   p->Tk,   p->H,    p->Kv,   p->D,     p->scale,   p->softcap,
               p->causal, p->window};
  switch (p->dtype) {
    case 0:
      return dispatch<float>(a, p->device, stream);
    case 1:
      return dispatch<__nv_bfloat16>(a, p->device, stream);
    case 2:
      return dispatch<__half>(a, p->device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
