// Per-bucket key counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bucket_histogram.py
// (bucket_histogram, pallas_call at line 79), which sums a one-hot
// (block, n_buckets) f32 panel on the MXU because the TPU has no
// scatter-add.  Hopper counts in registers and shared memory instead.
//
// What bounds it: each key is read once and each count written once,
// 4 * N + 4 * n_buckets bytes, with one compare and one add per key, so
// the card's memory rate is the bound; at the shuffle's shapes (about 10^5
// keys, 4 buckets) the launch is.  What the design does about it:
//
//   * reading: a grid-stride walk over 16-byte streaming loads, kUnroll of
//     them issued per thread before it counts (by Little's law the card
//     needs about 2 MB in flight; 1024 threads x 64 bytes on each of 132
//     SMs is 8 MB);
//   * counting, by route (the wrapper's _plan picks it from n_buckets):
//       regs    (n_buckets <= 16): each thread counts in registers, four
//               8-bit fields a word (templated on 4, 8 or 16 buckets): a
//               shift and an add a word per key, no atomics; a warp sums
//               them with __reduce_add_sync and one lane per bucket adds
//               the warp's total to shared memory;
//       smem    (<= 58,112, the 227 KB a block may opt into): replicated
//               sub-histograms in shared memory, as many as fit up to one
//               per warp, each warp adding to its own; folded at the end;
//       global  (above): every key is a global atomic on the output;
//   * merging: up to a crossover in N (the wrapper's CROSSOVER, measured)
//     the whole call is one cluster of at most 16 blocks that folds its
//     blocks' counts through distributed shared memory and stores the
//     output with plain stores: one launch, no memset, no global atomics.
//     Above it a grid of clusters fills the card; each cluster folds the
//     same way and adds its non-zero counts to an output zeroed on the
//     stream (a memset and a launch).  The global route is always a memset
//     and a launch.
//
// Negative keys are padding and keys >= n_buckets are dropped: one unsigned
// compare rejects both.  Counts are int32 and exact: the caller refuses
// N >= 2^31.  The host side takes its plan from the caller and queries
// nothing per call: bucket_histogram_configure reads the device's
// attributes and sets the kernels' once per device.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread
constexpr int kMaxCluster = 16;

enum Route : int32_t { kRegs = 0, kSmem = 1, kGlobal = 2 };

struct Args {
  const int32_t* keys;
  int64_t n;
  int32_t* out;
  uint32_t nb;      // n_buckets
  int32_t copies;   // smem: sub-histograms per block
};

// Calls count(key) on every key of keys[0:n) this thread owns in a
// grid-stride walk: a scalar head up to the first 16-byte boundary (at
// most 3 keys, fewer than the stride), then batches of kUnroll 16-byte
// loads, all issued before any key is counted (the last batch predicated,
// its missing loads read as padding), then a scalar tail.  batch() runs
// after each batch.
template <typename Count, typename Batch>
__device__ __forceinline__ void for_each_key(const int32_t* __restrict__ keys,
                                             int64_t n, int64_t first,
                                             int64_t stride, Count& count,
                                             Batch& batch) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(keys);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) >> 2);
  if (head > n) head = n;
  if (first < head) count(__ldcs(keys + first));
  const int64_t n_vec = (n - head) >> 2;
  const int4* vec = reinterpret_cast<const int4*>(keys + head);
  auto count4 = [&](const int4& v) {
    count(v.x);
    count(v.y);
    count(v.z);
    count(v.w);
  };
  int64_t i = first;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(v[u]);
    batch();
  }
  if (i < n_vec) {  // fewer than kUnroll loads left
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = i + u * stride < n_vec ? __ldcs(vec + i + u * stride)
                                    : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(v[u]);
    batch();
  }
  const int64_t tail = head + (n_vec << 2) + first;
  if (tail < n) count(__ldcs(keys + tail));
}

__device__ __forceinline__ int64_t first_key() {
  return static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
}
__device__ __forceinline__ int64_t key_stride() {
  return static_cast<int64_t>(gridDim.x) * kThreads;
}

// 1 << s, and 0 for s >= 32 (PTX clamps the shift; C++ would not).
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// A thread's counts of NB buckets in registers: four 8-bit fields a word,
// one shift and one add a word per key (no compare per bucket), emptied
// into 32-bit totals every kFlush batches, before a field can overflow
// (kFlush * kUnroll * 4 keys plus a head and a tail key < 256).
template <int NB>
struct RegCounts {
  static constexpr int kWords = NB / 4;
  static constexpr int kFlush = 8;
  uint32_t packed[kWords];
  int32_t total[NB];
  int batches;

  __device__ RegCounts() : batches(0) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) packed[j] = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) total[b] = 0;
  }
  // Keys in [nb, NB) land in fields the fold never reads; negative keys
  // and keys >= NB (clamped to NB) in none.
  __device__ __forceinline__ void add(int32_t k) {
    const uint32_t v = min(static_cast<uint32_t>(k), static_cast<uint32_t>(NB)) << 3;
#pragma unroll
    for (int j = 0; j < kWords; ++j) packed[j] += shl(1u, v - 32u * j);
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
#pragma unroll
      for (int f = 0; f < 4; ++f) total[4 * j + f] += (packed[j] >> (8 * f)) & 0xffu;
      packed[j] = 0;
    }
    batches = 0;
  }
  __device__ __forceinline__ void batch() {
    if (++batches == kFlush) flush();
  }
};

// The cluster barrier in two halves: arrive (release) as soon as a
// block's shared memory is ready for its peers, wait (acquire) only when
// it needs theirs, so the key loads in between hide the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// Stores (one cluster: the whole output, into an uninitialised buffer) or
// adds if non-zero (a grid of clusters, into a zeroed one) one bucket's count.
template <bool kSingle>
__device__ __forceinline__ void put(int32_t* __restrict__ out, uint32_t b,
                                    int32_t s) {
  if (kSingle) {
    out[b] = s;
  } else if (s != 0) {
    atomicAdd(out + b, s);
  }
}

template <int NB, bool kSingle>
__global__ void __launch_bounds__(kThreads, 1) hist_regs(Args a) {
  extern __shared__ int32_t hist[];  // NB words: the block's counts
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x < NB) hist[threadIdx.x] = 0;
  __syncthreads();
  cluster_arrive();  // the leader's counts are zero: peers may add (below)
  RegCounts<NB> c;
  auto count = [&](int32_t k) { c.add(k); };
  auto batch = [&] { c.batch(); };
  for_each_key(a.keys, a.n, first_key(), key_stride(), count, batch);
  c.flush();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int32_t s = __reduce_add_sync(0xffffffffu, c.total[b]);
    if (lane == b && s != 0) atomicAdd(hist + b, s);
  }
  __syncthreads();
  cluster_wait();
  // Every block but the leader adds its counts into the leader's through
  // distributed shared memory; one barrier later the leader writes them.
  const bool leader = cluster.block_rank() == 0;
  if (!leader && threadIdx.x < a.nb && hist[threadIdx.x] != 0) {
    atomicAdd(cluster.map_shared_rank(hist + threadIdx.x, 0), hist[threadIdx.x]);
  }
  cluster_arrive();
  cluster_wait();
  if (leader && threadIdx.x < a.nb) put<kSingle>(a.out, threadIdx.x, hist[threadIdx.x]);
}

template <bool kSingle>
__global__ void __launch_bounds__(kThreads, 1) hist_smem(Args a) {
  extern __shared__ int32_t hist[];  // copies x nb words
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t nb = a.nb;
  const uint32_t words = static_cast<uint32_t>(a.copies) * nb;
  for (uint32_t i = threadIdx.x; i < words; i += kThreads) hist[i] = 0;
  __syncthreads();
  int32_t* mine = hist + (threadIdx.x >> 5) % a.copies * nb;
  auto count = [&](int32_t k) {
    const uint32_t u = static_cast<uint32_t>(k);
    if (u < nb) atomicAdd(mine + u, 1);
  };
  auto batch = [] {};
  for_each_key(a.keys, a.n, first_key(), key_stride(), count, batch);
  __syncthreads();
  if (a.copies > 1) {
    for (uint32_t b = threadIdx.x; b < nb; b += kThreads) {
      int32_t s = hist[b];
      for (int c = 1; c < a.copies; ++c) s += hist[c * nb + b];
      hist[b] = s;
    }
  }
  // Fold the cluster's blocks: thread t of block r sums buckets
  // r * kThreads + t + k * C * kThreads over the C blocks through
  // distributed shared memory, spreading the fold over the cluster.
  cluster.sync();
  const uint32_t blocks = cluster.num_blocks();
  for (uint32_t b = cluster.block_rank() * kThreads + threadIdx.x; b < nb;
       b += blocks * kThreads) {
    int32_t s = 0;
#pragma unroll
    for (uint32_t r = 0; r < kMaxCluster; ++r) {
      if (r < blocks) s += *cluster.map_shared_rank(hist + b, r);
    }
    put<kSingle>(a.out, b, s);
  }
  cluster.sync();  // no block leaves while another still reads its counts
}

__global__ void __launch_bounds__(kThreads) hist_global(Args a) {
  const uint32_t nb = a.nb;
  int32_t* __restrict__ out = a.out;
  auto count = [&](int32_t k) {
    const uint32_t u = static_cast<uint32_t>(k);
    if (u < nb) atomicAdd(out + u, 1);
  };
  auto batch = [] {};
  for_each_key(a.keys, a.n, first_key(), key_stride(), count, batch);
}

// Every kernel, for the once-per-device attributes.
const void* const kKernels[] = {
    reinterpret_cast<const void*>(hist_regs<4, true>),
    reinterpret_cast<const void*>(hist_regs<4, false>),
    reinterpret_cast<const void*>(hist_regs<8, true>),
    reinterpret_cast<const void*>(hist_regs<8, false>),
    reinterpret_cast<const void*>(hist_regs<16, true>),
    reinterpret_cast<const void*>(hist_regs<16, false>),
    reinterpret_cast<const void*>(hist_smem<true>),
    reinterpret_cast<const void*>(hist_smem<false>),
    reinterpret_cast<const void*>(hist_global),
};

}  // namespace

// One call's plan, made by the wrapper (its ctypes structure `_Plan` has
// this layout).
struct Plan {
  int32_t route;      // Route
  int32_t width;      // regs: the template's bucket count, 4, 8 or 16
  int32_t single;     // 1: one cluster stores the whole output
  int32_t grid;       // blocks, a multiple of cluster
  int32_t cluster;    // blocks per cluster, 1..16
  int32_t smem;       // dynamic shared bytes per block
  int32_t copies;     // smem: sub-histograms per block
};

static_assert(sizeof(Plan) == 28, "Plan must match the wrapper's ctypes structure");

namespace {

// The kernel of a plan, or nullptr for a plan the kernels do not take.
const void* kernel_of(const Plan& p) {
  const bool single = p.single != 0;
  switch (p.route) {
    case kRegs:
      switch (p.width) {
        case 4:
          return single ? kKernels[0] : kKernels[1];
        case 8:
          return single ? kKernels[2] : kKernels[3];
        case 16:
          return single ? kKernels[4] : kKernels[5];
        default:
          return nullptr;
      }
    case kSmem:
      return single ? kKernels[6] : kKernels[7];
    case kGlobal:
      return single ? nullptr : kKernels[8];
    default:
      return nullptr;
  }
}

bool plan_ok(const Plan& p, int64_t n_buckets) {
  if (p.grid < 1 || p.cluster < 1 || p.cluster > kMaxCluster ||
      p.grid % p.cluster != 0 || p.smem < 0 || n_buckets < 1) {
    return false;
  }
  if (p.single && p.grid != p.cluster) return false;
  switch (p.route) {
    case kRegs:
      return n_buckets <= p.width &&
             p.smem >= p.width * static_cast<int32_t>(sizeof(int32_t));
    case kSmem:
      return p.copies >= 1 &&
             static_cast<int64_t>(p.smem) >=
                 p.copies * n_buckets * static_cast<int64_t>(sizeof(int32_t));
    case kGlobal:
      return p.cluster == 1;
    default:
      return false;
  }
}

cudaLaunchConfig_t config_of(const Plan& p, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(p.grid), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(p.smem);
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

// Reads the current device's SM count and shared-memory opt-in, and opts
// every kernel in to that much dynamic shared memory and to clusters of
// up to 16 blocks.  Once per device, with the device current.
extern "C" int bucket_histogram_configure(int* sms, int* smem_optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  for (const void* kernel : kKernels) {
    if (err != cudaSuccess) break;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_optin);
    if (err == cudaSuccess && kernel != kKernels[8]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
  }
  return err;
}

// out[0:n_buckets) = counts of keys[0:n) on `stream`, without
// synchronising or allocating: one launch for a single-cluster plan, a
// memset and a launch otherwise.  Returns a cudaError_t
// (cudaErrorInvalidValue for a plan the kernels do not take).
extern "C" int bucket_histogram_launch(const Plan* p, const int32_t* keys,
                                       int64_t n, int32_t n_buckets,
                                       int32_t* out, cudaStream_t stream) {
  const void* kernel = kernel_of(*p);
  if (kernel == nullptr || n < 0 || !plan_ok(*p, n_buckets)) {
    return cudaErrorInvalidValue;
  }
  if (!p->single) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_buckets) * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  Args a{keys, n, out, static_cast<uint32_t>(n_buckets), p->copies};
  void* args[] = {&a};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = config_of(*p, stream, attr);
  return cudaLaunchKernelExC(&config, kernel, args);
}

extern "C" const char* bucket_histogram_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
