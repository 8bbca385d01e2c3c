// One-time setup per device of a kernel launched from many host threads,
// shared by the port's CUDA sources (each builds into its own library).
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kMaxDevices = 64;  // device ordinals a launch may name

// A kernel's one-time setup (its attributes), once per device, from any
// number of host threads: the first caller on a device runs it under the
// lock and publishes success with a release store; later callers read
// one acquire flag.  A failure is not published, so the next call retries.
class PerDevice {
 public:
  template <typename Setup>
  cudaError_t once(int device, Setup&& setup) {
    if (done_[device].load(std::memory_order_acquire)) return cudaSuccess;
    std::lock_guard<std::mutex> hold(mu_);
    if (done_[device].load(std::memory_order_relaxed)) return cudaSuccess;
    const cudaError_t err = setup();
    if (err == cudaSuccess) done_[device].store(true, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<bool> done_[kMaxDevices] = {};
  std::mutex mu_;
};

}  // namespace
