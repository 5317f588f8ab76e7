// Shared launch helpers for the hand-written Hopper kernels.
//
// Every kernel here is a grid-stride loop over a 1-D column: the grid is
// capped at a few waves of blocks per SM and each thread walks the column
// with the grid's stride, so neighbouring threads touch neighbouring
// addresses (coalesced) at every step.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hs {

constexpr int kThreads = 256;

// Blocks for `work` items: enough to fill the card (16 blocks of 256
// threads per SM), never more than the work needs.
inline int grid_for(long long work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  long long want = (work + kThreads - 1) / kThreads;
  long long cap = 16LL * sms;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  return static_cast<int>(want);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

}  // namespace hs
