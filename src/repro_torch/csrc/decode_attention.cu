// Flash-decode on Hopper (sm_90a): one query token per sequence against a
// (B, S, Kv, dh) KV cache with per-row valid lengths, optional softcap,
// and an f32 online softmax.  One launch per call.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_fwd, pallas_call at line 127).  The TPU kernel runs a
// (B*Kv, S / s_block) grid whose sequence axis is sequential, carrying the
// softmax state in VMEM from panel to panel, over a cache its wrapper
// first transposes to (B*Kv, S, dh).  Here the cache is read in place
// through its strides, and:
//
//   * the sequence is split, because at serving shapes B*Kv is 2 per
//     conversation: block (split, row) of a thread-block cluster takes
//     one slice of the cache for the query heads of one kv head (a row
//     is (b, kv head, group of at most 16 query heads)).  The splits of a
//     row are one cluster (at most 16 blocks), and after the slices are
//     done every block combines a share of the output from all the
//     cluster's partials through distributed shared memory, in split
//     order.  No scratch in device memory, no second launch and no float
//     atomics: the same inputs give the same bytes;
//   * bf16 / f16 (`decode_mma_kernel`): each of the 4 warps takes 16-row
//     chunks of its block's slice in turn and keeps an online softmax of
//     its own.  Its chunks stream through a private ring of STAGES
//     cp.async stages (16-byte loads, rows swizzled by 16-byte chunk so
//     that ldmatrix meets no bank conflict), so no __syncthreads runs in
//     the loop.  Both products are tensor-core mma.sync m16n8k16 with f32
//     accumulators, with the query heads as the n = 8 side: S^T = K.Q^T
//     (K from ldmatrix as operand A, Q held in registers as operand B)
//     and O^T = V^T.P^T (V from ldmatrix.trans as A; P, the exponentiated
//     S^T rounded to the input type, moved into the B layout with
//     movmatrix.trans).  A group of fewer than 8 heads is padded, one of
//     9-16 takes two n tiles, and more heads take more rows.  Each K/V row
//     of a slice is read from memory once per kv head (and head group);
//   * f32 (`decode_f32_kernel`): CUDA-core FMAs from shared memory, one
//     32-row tile at a time (TF32 would not hold the f32 tolerance);
//   * lengths[b] is read on the device: a block whose slice lies past it
//     loads and computes nothing and leaves an empty partial, and
//     lengths[b] == 0 gives zeros, as the TPU kernel does (its
//     accumulator stays 0 over max(l, 1e-30)).
//
// Arithmetic: q.k in f32, times `scale`, then softcap * tanh(s / softcap),
// then the length mask; p = exp(s - m) in f32 (rounded to the input type
// before p.v on the tensor-core route, whose row sum adds up the rounded
// p); o = acc / max(l, 1e-30), rounded to the input type.
//
// What bounds it: it reads q and the first lengths[b] cache rows of K and
// V once and writes the output once, with 4 * rep * dh operations per
// cached token and kv head: the memory rate.  At serving shapes (about a
// megabyte per call) the latency of one launch and a few dependent
// memory round trips is what it takes instead.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "per_device.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // cache rows per warp step (mma's m side)
constexpr int kF32BlockS = 32;  // cache rows per tile of the f32 kernel
constexpr int kMaxSplits = 16;  // the largest (non-portable) cluster
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;  // (B, H, dh)
  const void* k;  // (B, S, Kv, dh)
  const void* v;
  const int32_t* lengths;  // (B,)
  void* o;                 // (B, H, dh)
  float* lse;              // (B, H) log-sum-exp, or null
  int64_t q_sb, q_sh;      // element strides
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh;
  int S, H, Kv, split_len, heads, groups;  // heads: per row (block)
  float scale;
  float softcap;  // <= 0: off
};

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

// What a row's block covers: batch b, kv head, first query head, heads.
struct Row {
  int b, kvh, h0, nh, len, s_begin, s_end;
};

__device__ __forceinline__ Row row_of(const Args& a) {
  Row r;
  const int rep = a.H / a.Kv;
  const int g = blockIdx.y % a.groups;
  const int bk = blockIdx.y / a.groups;
  r.b = bk / a.Kv;
  r.kvh = bk % a.Kv;
  r.h0 = r.kvh * rep + g * a.heads;
  r.nh = min(a.heads, rep - g * a.heads);
  r.len = min(max(a.lengths[r.b], 0), a.S);
  r.s_begin = blockIdx.x * a.split_len;
  r.s_end = min(r.len, r.s_begin + a.split_len);
  return r;
}

// -- the cluster combine ---------------------------------------------------------
//
// Each block leaves its partial at the start of its shared memory:
// m[HB], l[HB] and the unnormalised accumulator acc[HB][DH], in f32 (an
// empty slice: m = kMask, l = 0, acc = 0).  After a cluster barrier,
// block `rank` of n combines outputs e = rank * kThreads + tid, step
// n * kThreads, reading every block's partial in split order, and writes
// them; a second barrier keeps every block's shared memory alive until
// the others have read it.  With `a.lse`, the block that writes a head's
// element 0 also writes the head's log-sum-exp, m + log(l) in natural log
// (kMask for a head that saw no live row: lengths[b] == 0).
template <typename T, int DH>
__device__ void cluster_combine(const Args& a, const Row& r, float* part,
                                int hb) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  T* out = static_cast<T*>(a.o) + r.b * a.o_sb + r.h0 * a.o_sh;
  for (int e = rank * kThreads + threadIdx.x; e < r.nh * DH;
       e += n * kThreads) {
    const int h = e / DH, d = e % DH;
    float m = kMask;
    for (int s = 0; s < n; ++s) m = fmaxf(m, *cluster.map_shared_rank(part + h, s));
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n; ++s) {
      const float* p = cluster.map_shared_rank(part, s);
      const float w = expf(p[h] - m);
      l = fmaf(p[hb + h], w, l);
      acc = fmaf(p[2 * hb + h * DH + d], w, acc);
    }
    out[h * a.o_sh + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
    if (a.lse != nullptr && d == 0) {
      a.lse[r.b * a.H + r.h0 + h] = l > 0.f ? m + logf(l) : kMask;
    }
  }
  cluster.sync();
}

// -- the tensor-core route (bf16 / f16) -----------------------------------------

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ static __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi,
                                                  float* rlo, float* rhi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    *rlo = __low2float(p);
    *rhi = __high2float(p);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

template <>
struct Mma<__half> {
  __device__ static __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi,
                                                  float* rlo, float* rhi) {
    const __half2 p = __floats2half2_rn(lo, hi);
    *rlo = __low2float(p);
    *rhi = __high2float(p);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

// Shared memory of the tensor-core kernel: the block's partial (m, l, acc
// for HB = 8 NT heads), then per warp a ring of STAGES chunks of K and V
// (16 rows of DH each), which after the loop holds the warps' partials.
template <int DH, int NT>
struct MmaLayout {
  static constexpr int STAGES = DH == 256 ? 2 : 3;
  static constexpr int CHUNK_BYTES = kChunk * DH * 2;  // one K or V chunk
  static constexpr int WARP_BYTES = STAGES * 2 * CHUNK_BYTES;
  static constexpr int PART_BYTES = 4 * (2 * 8 * NT + 8 * NT * DH);
  static constexpr int SMEM = PART_BYTES + kWarps * WARP_BYTES;
};

// Byte offset of 16-byte chunk c of row r in a chunk buffer: chunks are
// XOR-swizzled by the row's low 3 bits, so the 8 row addresses of one
// ldmatrix fall in 8 different bank groups.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH * 2 + ((c ^ (r & 7)) << 4);
}

template <typename T, int DH, int NT>
__global__ void __launch_bounds__(kThreads) decode_mma_kernel(const Args a) {
  using L = MmaLayout<DH, NT>;
  constexpr int HB = 8 * NT;    // query heads of a block, padded
  constexpr int KS = DH / 16;   // k steps of S^T, m tiles of O^T
  constexpr int CPR = DH / 8;   // 16-byte chunks per cache row
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* rings = smem + L::PART_BYTES;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Row r = row_of(a);
  const int n_chunks =
      r.s_end > r.s_begin ? (r.s_end - r.s_begin + kChunk - 1) / kChunk : 0;
  const int mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;

  float m[NT][2], l[NT][2], o[KS][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[nt][j] = kMask;
      l[nt][j] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mt][nt][j] = 0.f;
  }
  unsigned char* ring = rings + warp * L::WARP_BYTES;

  if (mine > 0) {
    // Q as the B operand, held for the whole slice: b0 = Q[g][16 ks + 2t..],
    // b1 = Q[g][16 ks + 8 + 2t..] of head nt * 8 + g (0 past the group)
    const T* qb = static_cast<const T*>(a.q) + r.b * a.q_sb + r.h0 * a.q_sh;
    uint32_t qf[KS][NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int h = nt * 8 + g;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (h < r.nh) {
          const uint32_t* p =
              reinterpret_cast<const uint32_t*>(qb + h * a.q_sh + ks * 16 + 2 * t);
          qf[ks][nt][0] = p[0];
          qf[ks][nt][1] = p[4];
        } else {
          qf[ks][nt][0] = qf[ks][nt][1] = 0u;
        }
      }
    }
    const T* kb = static_cast<const T*>(a.k) + r.b * a.k_sb + r.kvh * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + r.b * a.v_sb + r.kvh * a.v_sh;
    // chunk i of this warp (rows from s_begin + (warp + 4 i) * 16) into
    // stage i % STAGES; rows at or past s_end fill with zeros
    auto issue = [&](int i) {
      const int row0 = r.s_begin + (warp + i * kWarps) * kChunk;
      const uint32_t sk = smem_addr(ring + (i % L::STAGES) * 2 * L::CHUNK_BYTES);
      const uint32_t sv = sk + L::CHUNK_BYTES;
#pragma unroll
      for (int idx = lane; idx < kChunk * CPR; idx += 32) {
        const int rr = idx / CPR, c = idx % CPR;
        const bool in = row0 + rr < r.s_end;
        const int64_t pos = in ? row0 + rr : r.s_begin;
        cp_async16(sk + swz<DH>(rr, c), kb + pos * a.k_ss + c * 8, in ? 16 : 0);
        cp_async16(sv + swz<DH>(rr, c), vb + pos * a.v_ss + c * 8, in ? 16 : 0);
      }
    };
#pragma unroll
    for (int i = 0; i < L::STAGES - 1; ++i) {
      if (i < mine) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      if (i + L::STAGES - 1 < mine) issue(i + L::STAGES - 1);
      cp_async_commit();
      cp_async_wait<L::STAGES - 1>();
      __syncwarp();
      const uint32_t sk = smem_addr(ring + (i % L::STAGES) * 2 * L::CHUNK_BYTES);
      const uint32_t sv = sk + L::CHUNK_BYTES;
      // S^T = K.Q^T: rows g and g + 8 of the chunk, heads 2t and 2t + 1
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4];
        ldmatrix_x4(ka, sk + swz<DH>((lane & 7) + ((lane >> 3) & 1) * 8,
                                     2 * ks + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          Mma<T>::run(s[nt], ka, qf[ks][nt][0], qf[ks][nt][1]);
      }
      const int row0 = r.s_begin + (warp + i * kWarps) * kChunk;
      const bool in0 = row0 + g < r.s_end, in1 = row0 + g + 8 < r.s_end;
      if (a.softcap > 0.f) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[nt][j] = a.softcap * tanhf(s[nt][j] * a.scale / a.softcap);
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[nt][j] *= a.scale;
      }
      uint32_t pb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (!in0) s[nt][0] = s[nt][1] = kMask;
        if (!in1) s[nt][2] = s[nt][3] = kMask;
        float c[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = fmaxf(s[nt][j], s[nt][j + 2]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mn = fmaxf(m[nt][j], mx);  // > kMask: row0 is live
          c[j] = exp2f((m[nt][j] - mn) * kLog2e);
          m[nt][j] = mn;
        }
        const float p0 = in0 ? exp2f((s[nt][0] - m[nt][0]) * kLog2e) : 0.f;
        const float p1 = in0 ? exp2f((s[nt][1] - m[nt][1]) * kLog2e) : 0.f;
        const float p2 = in1 ? exp2f((s[nt][2] - m[nt][0]) * kLog2e) : 0.f;
        const float p3 = in1 ? exp2f((s[nt][3] - m[nt][1]) * kLog2e) : 0.f;
        float r0, r1, r2, r3;  // p rounded to T
        const uint32_t lo = Mma<T>::pack(p0, p1, &r0, &r1);
        const uint32_t hi = Mma<T>::pack(p2, p3, &r2, &r3);
        l[nt][0] = fmaf(l[nt][0], c[0], r0 + r2);
        l[nt][1] = fmaf(l[nt][1], c[1], r1 + r3);
        // P^T as the B operand: rows (keys) g, cols (heads) 2t.. become
        // rows (heads) g, cols (keys) 2t..
        pb[nt][0] = movmatrix_trans(lo);
        pb[nt][1] = movmatrix_trans(hi);
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          o[mt][nt][0] *= c[0];
          o[mt][nt][1] *= c[1];
          o[mt][nt][2] *= c[0];
          o[mt][nt][3] *= c[1];
        }
      }
      // O^T += V^T.P^T: V^T's 16 x 16 tiles through ldmatrix.trans
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        uint32_t va[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(va, sv + swz<DH>((lane & 7) + (mi >> 1) * 8,
                                           2 * mt + (mi & 1)));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          Mma<T>::run(o[mt][nt], va, pb[nt][0], pb[nt][1]);
      }
      __syncwarp();  // the stage is consumed before it is loaded again
    }
    cp_async_wait<0>();
    __syncwarp();
  }

  // this warp's partial into its own ring: m[HB], l[HB], acc[HB][DH]
  float* wp = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float x = l[nt][j];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) {
        wp[nt * 8 + 2 * t + j] = m[nt][j];
        wp[HB + nt * 8 + 2 * t + j] = x;
      }
    }
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* acc = wp + 2 * HB + (nt * 8 + 2 * t) * DH + mt * 16 + g;
      acc[0] = o[mt][nt][0];
      acc[DH] = o[mt][nt][1];
      acc[8] = o[mt][nt][2];
      acc[DH + 8] = o[mt][nt][3];
    }
  __syncthreads();
  // the block's partial: the 4 warps' in warp order
  for (int e = threadIdx.x; e < HB * (DH + 1); e += kThreads) {
    const bool head = e < HB;  // e < HB: m and l of head e
    const int h = head ? e : (e - HB) / DH;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mx = fmaxf(mx, reinterpret_cast<const float*>(rings + w * L::WARP_BYTES)[h]);
    }
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* p = reinterpret_cast<const float*>(rings + w * L::WARP_BYTES);
      const float x = head ? p[HB + h] : p[2 * HB + e - HB];
      sum = fmaf(x, expf(p[h] - mx), sum);
    }
    if (head) {
      part[h] = mx;
      part[HB + h] = sum;
    } else {
      part[2 * HB + e - HB] = sum;
    }
  }
  cluster_combine<T, DH>(a, r, part, HB);
}

// -- the f32 route: CUDA-core FMAs ------------------------------------------------

// Shared memory, in floats: the block's partial (m, l, acc for all rep
// heads), then q (rep x DH), the K tile (32 x (DH+1)), the V tile
// (32 x DH), scores (rep x 33) and the tile's rescale factors (rep).  The
// +1 pads make the score product's column walk hit 32 distinct banks.
template <int DH>
int f32_smem_bytes(int rep) {
  return static_cast<int>(sizeof(float)) *
         (2 * rep + 2 * rep * DH + kF32BlockS * (DH + 1) + kF32BlockS * DH +
          rep * (kF32BlockS + 1) + rep);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) decode_f32_kernel(const Args a) {
  constexpr int KS = DH + 1;
  constexpr int SS = kF32BlockS + 1;
  const int rep = a.heads;  // one group: every head of the kv head
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  float* sM = part;
  float* sL = sM + rep;
  float* sAcc = sL + rep;
  float* sQ = sAcc + rep * DH;
  float* sK = sQ + rep * DH;
  float* sV = sK + kF32BlockS * KS;
  float* sS = sV + kF32BlockS * DH;
  float* sC = sS + rep * SS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Row r = row_of(a);
  for (int i = tid; i < rep * DH; i += kThreads) sAcc[i] = 0.f;
  for (int h = tid; h < rep; h += kThreads) {
    sM[h] = kMask;
    sL[h] = 0.f;
  }
  if (r.s_begin < r.s_end) {
    const float* q = static_cast<const float*>(a.q) + r.b * a.q_sb + r.h0 * a.q_sh;
    const float* k = static_cast<const float*>(a.k) + r.b * a.k_sb + r.kvh * a.k_sh;
    const float* v = static_cast<const float*>(a.v) + r.b * a.v_sb + r.kvh * a.v_sh;
    for (int i = tid; i < rep * DH; i += kThreads) sQ[i] = q[(i / DH) * a.q_sh + i % DH];
    for (int s0 = r.s_begin; s0 < r.s_end; s0 += kF32BlockS) {
      __syncthreads();  // previous tile consumed; init visible
      for (int i = tid; i < kF32BlockS * DH; i += kThreads) {
        const int j = i / DH, d = i % DH;
        const int pos = s0 + j;
        const bool in = pos < r.s_end;
        sK[j * KS + d] = in ? k[pos * a.k_ss + d] : 0.f;
        sV[j * DH + d] = in ? v[pos * a.v_ss + d] : 0.f;
      }
      __syncthreads();
      // scores: pair (head h, row j); a warp shares h, lanes walk j
      for (int p = tid; p < rep * kF32BlockS; p += kThreads) {
        const int h = p / kF32BlockS, j = p % kF32BlockS;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) acc = fmaf(sQ[h * DH + d], sK[j * KS + d], acc);
        float x = acc * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        sS[h * SS + j] = s0 + j < r.s_end ? x : kMask;
      }
      __syncthreads();
      // online softmax per head: warp w takes heads w, w + 4, ...
      for (int h = warp; h < rep; h += kWarps) {
        const float x = sS[h * SS + lane];
        const float m_old = sM[h];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float p = x == kMask ? 0.f : expf(x - m_new);
        sS[h * SS + lane] = p;
        const float l_tile = warp_sum(p);
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          sC[h] = corr;
          sM[h] = m_new;
          sL[h] = sL[h] * corr + l_tile;
        }
      }
      __syncthreads();
      for (int i = tid; i < rep * DH; i += kThreads) {
        const int h = i / DH, d = i % DH;
        float acc = sAcc[i] * sC[h];
#pragma unroll 8
        for (int j = 0; j < kF32BlockS; ++j) acc = fmaf(sS[h * SS + j], sV[j * DH + d], acc);
        sAcc[i] = acc;
      }
    }
  }
  __syncthreads();
  cluster_combine<float, DH>(a, r, part, rep);
}

// -- host side -------------------------------------------------------------------

// Opt the kernel in, once per device, to `smem_optin` bytes of dynamic
// shared memory and to clusters of up to 16 blocks; then launch the grid
// (n_splits, rows) as clusters of n_splits blocks.
template <typename Kernel>
cudaError_t launch_clusters(Kernel kernel, PerDevice& configured, int device,
                            int smem_optin, int smem, const Args& a,
                            int n_splits, int rows, cudaStream_t stream) {
  const cudaError_t err = configured.once(device, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    return e;
  });
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_splits, rows, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, a);
}

template <typename T, int DH, int NT>
cudaError_t mma_launch(const Args& a, int device, int n_splits, int rows,
                       cudaStream_t stream) {
  static PerDevice configured;  // the attributes, per device
  constexpr int smem = MmaLayout<DH, NT>::SMEM;
  return launch_clusters(decode_mma_kernel<T, DH, NT>, configured, device,
                         smem, smem, a, n_splits, rows, stream);
}

template <typename T, int DH>
cudaError_t mma_heads(int heads, const Args& a, int device, int n_splits,
                      int rows, cudaStream_t stream) {
  switch (heads) {
    case 8:
      return mma_launch<T, DH, 1>(a, device, n_splits, rows, stream);
    case 16:
      return mma_launch<T, DH, 2>(a, device, n_splits, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t mma_dispatch(int dh, int heads, const Args& a, int device,
                         int n_splits, int rows, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return mma_heads<T, 64>(heads, a, device, n_splits, rows, stream);
    case 128:
      return mma_heads<T, 128>(heads, a, device, n_splits, rows, stream);
    case 256:
      return mma_heads<T, 256>(heads, a, device, n_splits, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DH>
cudaError_t f32_launch(const Args& a, int device, int n_splits, int rows,
                       cudaStream_t stream) {
  static PerDevice configured;
  return launch_clusters(decode_f32_kernel<DH>, configured, device, kMaxSmem,
                         f32_smem_bytes<DH>(a.heads), a, n_splits, rows,
                         stream);
}

cudaError_t f32_dispatch(int dh, const Args& a, int device, int n_splits,
                         int rows, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return f32_launch<64>(a, device, n_splits, rows, stream);
    case 128:
      return f32_launch<128>(a, device, n_splits, rows, stream);
    case 256:
      return f32_launch<256>(a, device, n_splits, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One call's sizes, strides, plan and options, built once per call
// signature by the wrapper (its ctypes structure `_Params` has this
// layout), so that a launch passes seven arguments.
struct Params {
  int64_t q_sb, q_sh;  // element strides
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh;
  int32_t dtype;     // 0 float32 (CUDA cores), 1 bfloat16, 2 float16
  int32_t device;    // CUDA device index: the attributes are set per device
  int32_t B, S, H, Kv, dh;
  int32_t n_splits;   // blocks of a cluster, 1..16
  int32_t split_len;  // cache rows per split
  int32_t heads;      // query heads per block: 8 or 16 (mma), rep (f32)
  int32_t groups;     // head groups per kv head
  float scale;
  float softcap;  // <= 0: off
  int32_t pad_;
};

static_assert(sizeof(Params) == 136 && offsetof(Params, dtype) == 80 &&
                  offsetof(Params, scale) == 124,
              "Params must match the wrapper's ctypes structure");

// o[b, h, :] = attention of q[b, h, :] over the first lengths[b] rows of
// k/v[b, :, h / (H/Kv), :], on `stream`, in one launch, without
// synchronising or allocating.  `lse`, when not null, receives each
// (b, h)'s f32 log-sum-exp of its scores at lse[b * H + h] (kMask where
// lengths[b] == 0): what a caller needs to combine partial attentions
// over blocks of one sequence.  q, k, v and o of p->dtype, the head dim
// contiguous (bf16/f16: 16-byte aligned bases and strides).  Returns a
// cudaError_t (cudaErrorInvalidValue for a plan or type the kernel does
// not take).
extern "C" int decode_attention_launch(const Params* p, const void* q,
                                       const void* k, const void* v,
                                       const int32_t* lengths, void* o,
                                       float* lse, cudaStream_t stream) {
  if (p->B <= 0 || p->H <= 0) return cudaSuccess;
  const int rows = p->B * p->Kv * p->groups;
  if (p->S <= 0 || p->Kv <= 0 || p->H % p->Kv != 0 || p->n_splits < 1 ||
      p->n_splits > kMaxSplits || p->split_len < 1 || p->groups < 1 ||
      p->heads < 1 || p->device < 0 || p->device >= kMaxDevices ||
      rows > 65535 ||
      static_cast<int64_t>(p->n_splits) * p->split_len < p->S) {
    return cudaErrorInvalidValue;
  }
  const Args a{q,       k,       v,       lengths,      o,       lse,
               p->q_sb, p->q_sh, p->k_sb, p->k_ss,      p->k_sh,
               p->v_sb, p->v_ss, p->v_sh, p->o_sb,      p->o_sh,
               p->S,    p->H,    p->Kv,   p->split_len, p->heads,
               p->groups, p->scale, p->softcap};
  switch (p->dtype) {
    case 0:
      if (p->groups != 1 || p->heads != p->H / p->Kv) return cudaErrorInvalidValue;
      return f32_dispatch(p->dh, a, p->device, p->n_splits, rows, stream);
    case 1:
      return mma_dispatch<__nv_bfloat16>(p->dh, p->heads, a, p->device,
                                         p->n_splits, rows, stream);
    case 2:
      return mma_dispatch<__half>(p->dh, p->heads, a, p->device, p->n_splits,
                                  rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
