// Per-bucket key counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bucket_histogram.py
// (bucket_histogram, pallas_call at line 79), which sums a one-hot
// (block, n_buckets) f32 panel on the MXU because the TPU has no
// scatter-add.  Hopper has atomics in shared memory, so no panel is built:
//
//   * a grid-stride loop reads the keys with 16-byte loads;
//   * each block counts 0 <= key < n_buckets into its own histogram in
//     dynamic shared memory (negative keys are padding, keys >= n_buckets
//     are dropped: one unsigned compare rejects both);
//   * at the end each block adds its non-zero bins to the output with
//     global atomics.
//
// Where n_buckets * 4 bytes exceeds the shared memory a block may opt into
// (227 KB on the H100, about 58K buckets), the same kernel counts straight
// into the output with global atomics (kShared = false).
//
// What bounds it: each key is read once and each count written once,
// 4 * N + 4 * n_buckets bytes, with one compare and one add per key, so the
// card's memory rate is the bound.  Known contention: with few buckets (the
// engine's 4 partitions) every thread of a block hits the same few
// shared-memory words; per-warp sub-histograms are not done yet.
//
// Counts are int32 and exact: the caller refuses N >= 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    bucket_histogram_kernel(const int32_t* __restrict__ keys, int64_t n,
                            int32_t n_buckets, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  int32_t* bins = kShared ? hist : out;
  if (kShared) {
    for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  const uint32_t nb = static_cast<uint32_t>(n_buckets);
  auto count = [&](int32_t k) {
    if (static_cast<uint32_t>(k) < nb) atomicAdd(&bins[k], 1);
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  // Scalar head up to the first 16-byte boundary, 16-byte body, scalar tail.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(keys);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) >> 2);
  if (head > n) head = n;
  for (int64_t i = first; i < head; i += stride) count(keys[i]);
  const int64_t n_vec = (n - head) >> 2;
  const int4* vec = reinterpret_cast<const int4*>(keys + head);
  for (int64_t i = first; i < n_vec; i += stride) {
    const int4 v = vec[i];
    count(v.x);
    count(v.y);
    count(v.z);
    count(v.w);
  }
  for (int64_t i = head + (n_vec << 2) + first; i < n; i += stride) {
    count(keys[i]);
  }

  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
      const int32_t c = hist[b];
      if (c != 0) atomicAdd(&out[b], c);
    }
  }
}

template <bool kShared>
cudaError_t launch(const int32_t* keys, int64_t n, int32_t n_buckets,
                   int32_t* out, size_t smem, int sms, cudaStream_t stream) {
  auto kernel = bucket_histogram_kernel<kShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  // Enough blocks to fill the card, and no more than the keys need (every
  // extra block pays its own flush).
  const int64_t need = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  int64_t grid = static_cast<int64_t>(sms) * per_sm;
  if (grid > need) grid = need;
  if (grid < 1) grid = 1;
  bucket_histogram_kernel<kShared>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
          keys, n, n_buckets, out);
  return cudaGetLastError();
}

}  // namespace

// Adds the counts of keys[0:n) into out[0:n_buckets) (zeroed by the caller)
// on `stream`, without synchronising.  Returns a cudaError_t.
extern "C" int bucket_histogram_launch(const int32_t* keys, int64_t n,
                                       int32_t n_buckets, int32_t* out,
                                       cudaStream_t stream) {
  if (n <= 0 || n_buckets <= 0) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(n_buckets) * sizeof(int32_t);
  if (smem <= static_cast<size_t>(smem_optin)) {
    return launch<true>(keys, n, n_buckets, out, smem, sms, stream);
  }
  return launch<false>(keys, n, n_buckets, out, 0, sms, stream);
}

extern "C" const char* bucket_histogram_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
