// 3xTF32 building blocks of the f32 kernels that run on the tensor cores:
// the SSD forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu) and the
// flash attention's f32 routes (flash_attention.cu, flash_attention_bwd.cu).
// The hi/lo split of an f32 operand, mma.sync m16n8k8 on TF32, a warp's
// 3xTF32 products from shared tiles (ldmatrix) and from accumulators, ex2,
// and cp.async copies.
//
// 3xTF32: each f32 operand x is split into its TF32 high part and the
// TF32 cut of the rest (x = hi + lo + what 3xTF32 drops), and lo.hi +
// hi.lo + hi.hi are summed in f32 (lo.lo is dropped): close to f32
// accuracy on the tensor cores.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

// 4 bytes global -> shared; `bytes` 0 fills zeros without reading.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// d += A.B for one m16n8k8 TF32 tile: a the A fragment (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); b0, b1 the B elements (k t, n g), (k t+4, n g);
// g = lane / 4, t = lane % 4.  d holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// A tile of shared memory whose rows run along k: element (r, k) at
// p[r * s + k], every row 16-byte aligned (s a multiple of 4, = 4 mod 8 so
// that ldmatrix's eight rows fall on distinct banks).
struct KRows {
  const float* p;
  int s;
};

// The same, each row r scaled by e[r & 8 ? 1 : 0] (a warp's two rows g and
// g + 8 of one m16 tile, for MI = 1).
struct KRowsScaled {
  const float* p;
  int s;
  float e[2];
};

// Four 8 x 4 f32 matrices (8 x 8 as b16) from shared memory: lane i gives
// the address of row i % 8 of matrix i / 8, and receives element (lane / 4,
// lane % 4) of each matrix.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1, const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(row)));
}

// The raw f32 A fragments of rows [16 i, 16 i + 16) and columns [k, k +
// 8): elements (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each.
template <int MI>
__device__ __forceinline__ void frag_a(const KRows& a, int k, uint32_t (&x)[MI][4]) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int i = 0; i < MI; ++i)
    ldsm4(x[i], a.p + (16 * i + 8 * (q & 1) + r) * a.s + k + 4 * (q >> 1));
}
template <int MI>
__device__ __forceinline__ void frag_a(const KRowsScaled& a, int k,
                                       uint32_t (&x)[MI][4]) {
  static_assert(MI == 1, "one m16 tile: rows g and g + 8");
  frag_a<1>(KRows{a.p, a.s}, k, x);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    x[0][u] = __float_as_uint(__uint_as_float(x[0][u]) * a.e[u & 1]);
}
template <int MI, typename F>
__device__ __forceinline__ void frag_a(F f, int k, uint32_t (&x)[MI][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    x[i][0] = __float_as_uint(f(16 * i + g, k + t));
    x[i][1] = __float_as_uint(f(16 * i + g + 8, k + t));
    x[i][2] = __float_as_uint(f(16 * i + g, k + t + 4));
    x[i][3] = __float_as_uint(f(16 * i + g + 8, k + t + 4));
  }
}

// The raw f32 B fragments of n tiles j: elements (k + t, 8 j + g) and (k +
// t + 4, 8 j + g), from a tile whose rows are n (KRows) or through f(k, n).
template <int NJ>
__device__ __forceinline__ void frag_b(const KRows& b, int k, uint32_t (&x)[NJ][2]) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j + 1 < NJ; j += 2) {
    uint32_t v[4];
    ldsm4(v, b.p + (8 * (j + (q >> 1)) + r) * b.s + k + 4 * (q & 1));
    x[j][0] = v[0];
    x[j][1] = v[1];
    x[j + 1][0] = v[2];
    x[j + 1][1] = v[3];
  }
  if (NJ & 1)
    ldsm2(x[NJ - 1][0], x[NJ - 1][1],
          b.p + (8 * (NJ - 1) + r) * b.s + k + 4 * (q & 1));
}
template <int NJ, typename F>
__device__ __forceinline__ void frag_b(F f, int k, uint32_t (&x)[NJ][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    x[j][0] = __float_as_uint(f(k + t, 8 * j + g));
    x[j][1] = __float_as_uint(f(k + t + 4, 8 * j + g));
  }
}

// v = hi + lo: hi cut to TF32 in place, lo the rest, left uncut (the
// tensor cores read a TF32 operand's top 19 bits).
__device__ __forceinline__ void split_raw(uint32_t& v, uint32_t& lo) {
  const uint32_t hi = v & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
  v = hi;
}

// acc += A.B for this warp's (16 MI) x (8 NJ) corner of a product, over k
// in [0, K) (a multiple of 8), in 3xTF32.  a and b are KRows tiles (read by
// ldmatrix) or functions a(m, k), b(k, n) of one element, m and n counted
// from the warp's corner.  acc[i][j] holds rows 16 i + g (+ 8 for elements
// 2, 3) and columns 8 j + 2 t (+ 1 for elements 1, 3), g = lane / 4, t =
// lane % 4.  hi.hi goes onto acc and lo.hi + hi.lo into an accumulator of
// their own, two chains of products that do not wait for each other; acc
// takes the second at the end.  One fixed order of every sum.  UNROLL
// k-steps are unrolled (1 where registers are short).
template <int MI, int NJ, int K, int UNROLL = 2, typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&acc)[MI][NJ][4], const FA& a, const FB& b) {
  float cross[MI][NJ][4];
  zero(cross);
#pragma unroll (UNROLL)
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
    frag_a<MI>(a, k, ah);
    frag_b<NJ>(b, k, bh);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) split_raw(ah[i][u], al[i][u]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) split_raw(bh[j][u], bl[j][u]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma_tf32(cross[i][j], al[i], bh[j][0], bh[j][1]);
        mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        mma_tf32(cross[i][j], ah[i], bl[j][0], bl[j][1]);
      }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += cross[i][j][e];
}

// Rows [r0, r0 + ROWS) of a (rows x W) f32 slice whose rows lie `st`
// elements apart (the last dim contiguous) into shared rows `ld` floats
// apart, by cp.async over NT threads: 16 bytes a copy when `vec` (the base
// and `st` 16-byte aligned, and `ld` a multiple of 4), else 4.  Rows at or
// past `n` fill with zeros.  The caller commits and waits.
template <int W, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(float* dst, int ld, const float* src,
                                                int64_t st, int r0, int n, bool vec) {
  if (vec) {
    constexpr int C = W / 4;
    for (int i = threadIdx.x; i < ROWS * C; i += NT) {
      const int r = i / C, c = 4 * (i % C), row = r0 + r;
      const bool in = row < n;
      cp_async16(smem_addr(dst + r * ld + c), src + (in ? row : 0) * st + c, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += NT) {
      const int r = i / W, c = i % W, row = r0 + r;
      const bool in = row < n;
      cp_async4(smem_addr(dst + r * ld + c), src + (in ? row : 0) * st + c, in ? 4 : 0);
    }
  }
}

// An m16n8 accumulator as the raw f32 A fragment of one k-step of 8, in
// key order: its elements (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t +
// 1) stand in A's places (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), so
// that k position t is the accumulator's column 2t and t + 4 its column
// 2t + 1.  The B operand of the product reads its rows in the same order
// (mma3_pairs); a product sums over k, so the order changes nothing.
__device__ __forceinline__ void acc_as_a(const float (&d)[4], uint32_t (&a)[4]) {
  a[0] = __float_as_uint(d[0]);
  a[1] = __float_as_uint(d[2]);
  a[2] = __float_as_uint(d[1]);
  a[3] = __float_as_uint(d[3]);
}

// acc[j] += A.B over one k-step of 8 in 3xTF32: `a` a raw f32 A fragment
// in key order (acc_as_a), B eight rows of a shared tile from `b` (row k0),
// `s` floats apart, columns 8 j + g: b0 from row 2t, b1 from row 2t + 1.
// With s = 4 mod 32 a read's 32 lanes hit 32 banks (8 t + g, and 8 t + 4 +
// g).  lo.hi and hi.lo go onto acc first, then hi.hi: one fixed order.
template <int NJ>
__device__ __forceinline__ void mma3_pairs(float (&acc)[NJ][4], const uint32_t (&a)[4],
                                           const float* b, int s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ah[u] = a[u];
    split_raw(ah[u], al[u]);
  }
  const float* r0 = b + 2 * t * s + g;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t bh0 = __float_as_uint(r0[8 * j]), bh1 = __float_as_uint(r0[s + 8 * j]);
    uint32_t bl0, bl1;
    split_raw(bh0, bl0);
    split_raw(bh1, bl1);
    mma_tf32(acc[j], al, bh0, bh1);
    mma_tf32(acc[j], ah, bl0, bl1);
    mma_tf32(acc[j], ah, bh0, bh1);
  }
}


}  // namespace
