// The dynamic shared-memory limit of a kernel, raised once and never lowered.
//
// A kernel that takes more than 48 KB of dynamic shared memory must first
// raise its limit (cudaFuncSetAttribute). Host threads launch one kernel at
// different sizes (the mapper's local BA and the loop closer's global BA;
// the tracking thread and the loop detector's pose optimization): a thread
// that set a smaller limit between another's setting and its launch would
// make that launch fail. reserve_smem raises `kernel`'s limit on the current
// device to at least `bytes` under a lock and never lowers it.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace svt {

inline cudaError_t reserve_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> limit;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t& cur = limit[{dev, kernel}];
  if (bytes <= cur) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) cur = bytes;
  return e;
}

}  // namespace svt
