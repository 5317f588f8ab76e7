// Shared elementwise-mask skeleton for compare_mask.cu and range_mask.cu.
//
// A predicate over a 4-byte column (int32, uint32 or float32) writes one
// bool byte per row. With the column 16-byte aligned and the output 4-byte
// aligned, each thread loads four rows in one 16-byte load and stores
// their four bools in one 4-byte store; the ragged tail (and unaligned
// inputs) take the one-row loop.
#pragma once

#include "hs_common.cuh"

namespace hs {

enum DType { kInt32 = 0, kUInt32 = 1, kFloat32 = 2 };

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t b) {
  return static_cast<int32_t>(b);
}
template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) {
  return b;
}
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}

// Host side of the same reinterpretation, for the literals.
template <typename T>
inline T host_from_bits(uint32_t b) {
  T v;
  static_assert(sizeof(T) == 4, "4-byte lanes only");
  __builtin_memcpy(&v, &b, 4);
  return v;
}

// out[i] = pred(x[i]) for i < n.
template <typename T, typename Pred>
__global__ void mask_kernel(const T* __restrict__ x, long long n, Pred pred,
                            int vec, uint8_t* __restrict__ out) {
  long long tail = 0;
  if (vec) {
    const long long quads = n / 4;
    const uint4* q = reinterpret_cast<const uint4*>(x);
    uchar4* o = reinterpret_cast<uchar4*>(out);
    for (long long i = thread_index(); i < quads; i += grid_stride()) {
      const uint4 w = __ldg(q + i);
      o[i] = make_uchar4(pred(from_bits<T>(w.x)), pred(from_bits<T>(w.y)),
                         pred(from_bits<T>(w.z)), pred(from_bits<T>(w.w)));
    }
    tail = quads * 4;
  }
  for (long long i = tail + thread_index(); i < n; i += grid_stride())
    out[i] = pred(__ldg(x + i));
}

template <typename T, typename Pred>
inline int launch_mask(const void* x, long long n, Pred pred, void* out,
                       void* stream) {
  const int vec = aligned(x, 16) && aligned(out, 4);
  const long long work = vec ? (n + 3) / 4 : n;
  mask_kernel<T, Pred><<<grid_for(work), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, pred, vec, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hs
