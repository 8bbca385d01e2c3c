// Flash attention forward on Hopper (sm_90a): causal or full attention
// over (B, T, H, dh) queries and (B, T, Kv, dh) keys/values, with GQA,
// optional softcap and sliding window, and an f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, pallas_call at line 138).  The TPU kernel runs a
// (B*H, nq, nk) grid whose innermost kv axis is sequential, carrying the
// softmax state in VMEM scratch from one grid step to the next, and needs
// GQA expanded upstream (a jnp.repeat copy of K/V).  Here:
//
//   * one block owns one (batch, head, q tile) and loops over the kv tiles
//     itself, so the running max / sum / accumulator stay in registers and
//     shared memory for the whole row of tiles (blocks run in no order);
//   * q, k and v are read in place through their strides; query head h
//     reads kv head h / (H / Kv), so no repeated copy of K/V is made;
//   * causal blocks skip the kv tiles above the diagonal (and, with a
//     window, the tiles below it), and the heaviest q tiles start first;
//   * the ragged edge (T not a multiple of the tile) is masked in-kernel:
//     keys at or past Tk never count, rows past Tq are never written.
//
// Arithmetic: q.k in f32 (inputs widened on load), times `scale`, then
// softcap * tanh(s / softcap), then the mask; p = exp(s - m) in f32 and
// p.v in f32; the output is acc / max(l, 1e-30), rounded to the input
// type.
//
// What bounds it: 4 * Tq * Tk * dh * H operations (half of it when causal)
// against reading q, k, v and writing o once: at the prefill's shapes the
// operations bound it.  This first version does them with CUDA-core FMAs
// from shared memory, not with wgmma/TMA, so it sits far from the
// tensor-core peak; ROADMAP.md queue C carries the tensor-core version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockK = 32;    // keys per tile: one per lane in the softmax
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

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

// Shared memory, in floats: Q tile (BQ x (DH+1)), K tile (BK x (DH+1)),
// V tile (BK x DH), scores/probabilities (BQ x (BK+1)), and the per-row
// rescale factor (BQ).  The +1 pads make the column walks of the score
// product hit 32 distinct banks.
template <int DH, int BQ>
constexpr int smem_floats() {
  return BQ * (DH + 1) + kBlockK * (DH + 1) + kBlockK * DH +
         BQ * (kBlockK + 1) + BQ;
}

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Args a) {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static_assert(BQ % 16 == 0, "q tile must be a multiple of 16");
  constexpr int RPT = BQ / 16;      // score rows per thread
  constexpr int ROWS_W = BQ / 4;    // softmax / output rows per warp
  constexpr int COLS = DH / 32;     // output columns per lane
  constexpr int QS = DH + 1;        // padded row strides
  constexpr int KS = DH + 1;
  constexpr int SS = kBlockK + 1;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + kBlockK * KS;
  float* sS = sV + kBlockK * DH;
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

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    sQ[r * QS + d] = row < a.Tq ? to_f32(q[row * a.q_st + d]) : 0.f;
  }

  // kv range this q tile can see
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

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
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile's K/V/S fully consumed
    for (int i = tid; i < kBlockK * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      const int key = k0 + j;
      const bool in = key < a.Tk;
      sK[j * KS + d] = in ? to_f32(k[key * a.k_st + d]) : 0.f;
      sV[j * DH + d] = in ? to_f32(v[key * a.v_st + d]) : 0.f;
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
    for (int j = 0; j < kBlockK; ++j) {
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
        o[row * a.o_st + lane + 32 * cc] = from_f32<T>(acc[r][cc] / l);
      }
    }
  }
}

template <typename T, int DH, int BQ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_floats<DH, BQ>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, DH, BQ>;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const Args& a, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64, 64>(a, stream);
    case 128:
      return launch<T, 128, 64>(a, stream);
    case 256:
      return launch<T, 256, 32>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// o[b, t, h, :] = attention of q[b, t, h, :] over k/v[b, :, h / (H/Kv), :]
// on `stream`, without synchronising.  dtype: 0 float32, 1 bfloat16,
// 2 float16 (q, k, v and o alike); strides in elements, the head dim
// contiguous.  softcap <= 0 and window <= 0 switch those off.  Returns a
// cudaError_t (cudaErrorInvalidValue for an unsupported dtype or dh).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
    int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
    int64_t o_st, int64_t o_sh, int B, int Tq, int Tk, int H, int Kv, int dh,
    float scale, float softcap, int causal, int window, cudaStream_t stream) {
  if (B <= 0 || Tq <= 0) return cudaSuccess;
  if (Tk <= 0 || Kv <= 0 || H % Kv != 0) return cudaErrorInvalidValue;
  Args a{q,    k,    v,    o,    q_sb, q_st, q_sh, k_sb,  k_st,    k_sh,
         v_sb, v_st, v_sh, o_sb, o_st, o_sh, B,    Tq,    Tk,      H,
         Kv,   scale, softcap, causal, window};
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, a, stream);
    case 1:
      return dispatch_dh<__nv_bfloat16>(dh, a, stream);
    case 2:
      return dispatch_dh<__half>(dh, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
