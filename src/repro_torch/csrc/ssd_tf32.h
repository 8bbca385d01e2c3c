// 3xTF32 building blocks of the SSD kernels, shared by the forward
// (ssd_scan.cu) and backward (ssd_scan_bwd.cu): the hi/lo split of an f32
// operand, mma.sync m16n8k8 on TF32, ex2, and cp.async copies.
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

}  // namespace
