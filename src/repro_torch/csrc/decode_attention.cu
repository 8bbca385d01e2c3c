// Flash-decode on Hopper (sm_90a): one query token per sequence against a
// (B, S, Kv, dh) KV cache with per-row valid lengths, optional softcap,
// and an f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_fwd, pallas_call at line 127).  The TPU kernel runs a
// (B*Kv, S / s_block) grid whose sequence axis is sequential, carrying the
// softmax state in VMEM from panel to panel, over a cache its wrapper
// first transposes to (B*Kv, S, dh).  Here:
//
//   * the cache is read in place through its strides: no transposed copy;
//   * at serving shapes B*Kv is 2 per conversation, so one block per row
//     would leave 130 of 132 SMs idle.  The sequence is split instead:
//     split kernel: block (split, b*Kv + kv head) runs the online softmax
//     of the `rep` query heads of that kv head over its slice of the
//     cache and writes an unnormalised partial (max, sum, accumulator);
//     combine kernel: one block per (b, head) rescales the partials to a
//     common max and sums them in split order.  No float atomics: a step
//     gives the same bytes every time;
//   * slices past lengths[b] do no work; lengths[b] == 0 gives zeros, as
//     the TPU kernel does (its accumulator stays 0 over max(l, 1e-30)).
//
// What bounds it: it reads q and the first lengths[b] cache rows of K and
// V once and writes the output once, with 4 * rep * dh operations per
// cached token and kv head: the memory rate is the bound.  At serving
// shapes (a few MB per call) launch latency dominates instead.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockS = 32;    // cache rows per tile: one per lane
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
  const void* q;  // (B, H, dh)
  const void* k;  // (B, S, Kv, dh)
  const void* v;
  const int32_t* lengths;  // (B,)
  void* o;                 // (B, H, dh)
  float* part_o;           // (n_splits, B*H, dh)
  float* part_m;           // (n_splits, B*H)
  float* part_l;
  int64_t q_sb, q_sh;  // element strides
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh;
  int B, S, H, Kv, split_len;
  float scale;
  float softcap;  // <= 0: off
};

// Shared memory, in floats: q (rep x DH), K tile (BS x (DH+1)), V tile
// (BS x DH), scores (rep x (BS+1)), accumulator (rep x DH), and per head
// the running max, the running sum and the tile's rescale factor.  The +1
// pad makes the score product's column walk hit 32 distinct banks.
template <int DH>
int split_smem_bytes(int rep) {
  return static_cast<int>(sizeof(float)) *
         (2 * rep * DH + kBlockS * (DH + 1) + kBlockS * DH +
          rep * (kBlockS + 1) + 3 * rep);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const Args a) {
  constexpr int KS = DH + 1;
  constexpr int SS = kBlockS + 1;
  const int rep = a.H / a.Kv;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + rep * DH;
  float* sV = sK + kBlockS * KS;
  float* sS = sV + kBlockS * DH;
  float* sAcc = sS + rep * SS;
  float* sM = sAcc + rep * DH;
  float* sL = sM + rep;
  float* sC = sL + rep;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int row = blockIdx.y;  // b * Kv + kv head
  const int b = row / a.Kv;
  const int kvh = row % a.Kv;
  const int h0 = kvh * rep;  // first query head of this kv head
  const int len = min(a.lengths[b], a.S);
  const int s_begin = split * a.split_len;
  const int s_end = min(len, s_begin + a.split_len);
  const int64_t part_row = static_cast<int64_t>(split) * a.B * a.H +
                           static_cast<int64_t>(b) * a.H + h0;

  if (s_begin >= s_end) {  // nothing cached here: an empty partial
    for (int i = tid; i < rep * DH; i += kThreads) {
      a.part_o[(part_row + i / DH) * DH + i % DH] = 0.f;
    }
    for (int r = tid; r < rep; r += kThreads) {
      a.part_m[part_row + r] = kMask;
      a.part_l[part_row + r] = 0.f;
    }
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h0 * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  for (int i = tid; i < rep * DH; i += kThreads) {
    sQ[i] = to_f32(q[(i / DH) * a.q_sh + i % DH]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    sM[r] = kMask;
    sL[r] = 0.f;
  }

  for (int s0 = s_begin; s0 < s_end; s0 += kBlockS) {
    __syncthreads();  // previous tile consumed; init visible
    for (int i = tid; i < kBlockS * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      const int pos = s0 + j;
      const bool in = pos < s_end;
      sK[j * KS + d] = in ? to_f32(k[pos * a.k_ss + d]) : 0.f;
      sV[j * DH + d] = in ? to_f32(v[pos * a.v_ss + d]) : 0.f;
    }
    __syncthreads();
    // scores: pair (head r, row j); a warp shares r, lanes walk j
    for (int p = tid; p < rep * kBlockS; p += kThreads) {
      const int r = p / kBlockS, j = p % kBlockS;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) acc = fmaf(sQ[r * DH + d], sK[j * KS + d], acc);
      float x = acc * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      sS[r * SS + j] = s0 + j < s_end ? x : kMask;
    }
    __syncthreads();
    // online softmax per head: warp w takes heads w, w + 4, ...
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float x = sS[r * SS + lane];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = x == kMask ? 0.f : expf(x - m_new);
      sS[r * SS + lane] = p;
      const float l_tile = warp_sum(p);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sM[r] = m_new;
        sL[r] = sL[r] * corr + l_tile;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      float acc = sAcc[i] * sC[r];
#pragma unroll 8
      for (int j = 0; j < kBlockS; ++j) acc = fmaf(sS[r * SS + j], sV[j * DH + d], acc);
      sAcc[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * DH; i += kThreads) {
    a.part_o[(part_row + i / DH) * DH + i % DH] = sAcc[i];
  }
  for (int r = tid; r < rep; r += kThreads) {
    a.part_m[part_row + r] = sM[r];
    a.part_l[part_row + r] = sL[r];
  }
}

// One block per (b, head), one thread per head-dim column: rescale every
// split's partial to the common max and sum them in split order.
template <typename T>
__global__ void decode_combine_kernel(const Args a, int n_splits, int dh) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int64_t stride = static_cast<int64_t>(a.B) * a.H;
  float m = kMask;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, a.part_m[s * stride + bh]);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(a.part_m[s * stride + bh] - m);
      l = fmaf(a.part_l[s * stride + bh], w, l);
      acc = fmaf(a.part_o[(s * stride + bh) * dh + d], w, acc);
    }
    static_cast<T*>(a.o)[b * a.o_sb + h * a.o_sh + d] =
        from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

int g_sms = 0;  // SM count of the current device, read once

template <typename T, int DH>
cudaError_t launch(Args a, int n_splits, cudaStream_t stream) {
  const int rep = a.H / a.Kv;
  const int smem = split_smem_bytes<DH>(rep);
  auto kernel = decode_split_kernel<T, DH>;
  static int configured = 0;  // largest dynamic shared memory set so far
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  kernel<<<dim3(n_splits, a.B * a.Kv), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int combine_threads = DH < 128 ? DH : 128;
  decode_combine_kernel<T><<<a.B * a.H, combine_threads, 0, stream>>>(
      a, n_splits, DH);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const Args& a, int n_splits,
                        cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(a, n_splits, stream);
    case 128:
      return launch<T, 128>(a, n_splits, stream);
    case 256:
      return launch<T, 256>(a, n_splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// How many splits of the sequence the launcher uses for a (B, S, Kv) call,
// and the scratch it needs: n_splits * B * H * (dh + 2) floats.  Enough
// blocks for two waves over the card's SMs, each split a whole number of
// 32-row tiles.  Returns -1 if the device cannot be queried.
extern "C" int decode_attention_splits(int B, int S, int Kv, int* split_len) {
  if (g_sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess) {
      return -1;
    }
  }
  const int rows = B * Kv;
  const int tiles = (S + kBlockS - 1) / kBlockS;
  int want = (2 * g_sms + rows - 1) / rows;
  if (want < 1) want = 1;
  if (want > tiles) want = tiles;
  const int per = (tiles + want - 1) / want;  // tiles per split
  *split_len = per * kBlockS;
  return (tiles + per - 1) / per;
}

// o[b, h, :] = attention of q[b, h, :] over the first lengths[b] rows of
// k/v[b, :, h / (H/Kv), :], on `stream`, without synchronising.  dtype: 0
// float32, 1 bfloat16, 2 float16 (q, k, v and o alike); strides in
// elements, the head dim contiguous.  part_* is the caller's f32 scratch
// for n_splits x split_len (from decode_attention_splits).  softcap <= 0
// switches it off.  Returns a cudaError_t.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const int32_t* lengths, void* o, float* part_o, float* part_m,
    float* part_l, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_sh, int B, int S, int H, int Kv, int dh, int n_splits,
    int split_len, float scale, float softcap, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (S <= 0 || Kv <= 0 || H % Kv != 0 || n_splits <= 0 || split_len <= 0 ||
      split_len % kBlockS != 0) {
    return cudaErrorInvalidValue;
  }
  Args a{q,    k,    v,    lengths, o,    part_o, part_m,    part_l,
         q_sb, q_sh, k_sb, k_ss,    k_sh, v_sb,   v_ss,      v_sh,
         o_sb, o_sh, B,    S,       H,    Kv,     split_len, scale,
         softcap};
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, a, n_splits, stream);
    case 1:
      return dispatch_dh<__nv_bfloat16>(dh, a, n_splits, stream);
    case 2:
      return dispatch_dh<__half>(dh, a, n_splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
