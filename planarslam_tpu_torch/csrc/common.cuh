// Shared helpers for the planarslam_tpu_torch CUDA kernels.
//
// Every kernel has a plain C entry point that launches on the caller's
// stream and returns cudaGetLastError(); the Python wrapper raises on a
// non-zero return. Kernels allocate nothing: outputs come from torch.empty.
#pragma once

#include <climits>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

#define PSL_API extern "C" __attribute__((visibility("default")))

// Return codes of the entry points' own, above every cudaError_t; each has
// its message in psl_error_string.
// K28 (noise_alpha): a frame has more strided samples than its cluster's
// shared memory holds, kPslAlphaMaxSamples (8 blocks of 52736).
constexpr int kPslErrAlphaSamples = 100001;
constexpr int kPslAlphaMaxSamples = 421888;
// K13 (plane_assign_refit): a frame has more logical blocks of subsampled
// pixels than its flag words hold (kAssignMaxParts in plane_segment.cu).
constexpr int kPslErrAssignParts = 100002;

// Cards an entry point caches a per-card value for (a shared-memory
// opt-in, a residency count).
constexpr int kPslDevices = 64;

// The current card's slot of a per-card cache of kPslDevices values, or
// nullptr past them (the caller then recomputes the value every call).
template <typename T>
inline T* psl_device_slot(T (&cache)[kPslDevices]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kPslDevices) {
    return nullptr;
  }
  return &cache[dev];
}

// Sets kernel fn's dynamic shared memory limit to `bytes` on the current
// card where it was set lower there before (each kernel and card once for
// the largest size asked): the opt-in a launch above 48 KB, static shared
// memory included, needs. 0 or the CUDA error.
inline int psl_opt_in_smem(const void* fn, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> opted;
  const std::lock_guard<std::mutex> hold(mu);
  size_t& done = opted[{dev, fn}];
  if (bytes <= done) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  done = bytes;
  return 0;
}

__device__ __forceinline__ int psl_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
