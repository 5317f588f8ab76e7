// Shared elementwise-mask skeleton for compare_mask.cu and range_mask.cu.
//
// A predicate over a 4-byte column (int32, uint32 or float32) writes one
// bool byte per row. The work is bytes (4 read and 1 written per row), so
// the design keeps many bytes in flight and moves them in wide accesses:
//   - with the column and the output 16-byte aligned, a thread takes 16
//     rows per step: four 16-byte loads, all issued before the first row is
//     tested, and one 16-byte store of the 16 bools;
//   - the grid is one wave (as many blocks as the SMs hold at once, fewer
//     when the column is short), walking the column with a grid stride, so
//     no block waits for a second wave to be scheduled;
//   - the ragged tail (and an unaligned column or output) takes the one-row
//     loop.
#pragma once

#include "hs_common.cuh"

namespace hs {

enum DType { kInt32 = 0, kUInt32 = 1, kFloat32 = 2 };

constexpr int kMaskThreads = 256;
constexpr int kMaskRows = 16;  // rows per thread per step

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

// The predicate of four rows as four bool bytes, the first row lowest.
template <typename T, typename Pred>
__device__ __forceinline__ uint32_t pack4(const uint4& w, const Pred& pred) {
  return static_cast<uint32_t>(pred(from_bits<T>(w.x))) |
         (static_cast<uint32_t>(pred(from_bits<T>(w.y))) << 8) |
         (static_cast<uint32_t>(pred(from_bits<T>(w.z))) << 16) |
         (static_cast<uint32_t>(pred(from_bits<T>(w.w))) << 24);
}

// out[i] = pred(x[i]) for i < n.
template <typename T, typename Pred>
__global__ void __launch_bounds__(kMaskThreads)
mask_kernel(const T* __restrict__ x, long long n, Pred pred, int vec,
            uint8_t* __restrict__ out) {
  long long tail = 0;
  if (vec) {
    const long long units = n / kMaskRows;
    const uint4* q = reinterpret_cast<const uint4*>(x);
    uint4* o = reinterpret_cast<uint4*>(out);
    for (long long i = thread_index(); i < units; i += grid_stride()) {
      const uint4 a = __ldg(q + 4 * i);
      const uint4 b = __ldg(q + 4 * i + 1);
      const uint4 c = __ldg(q + 4 * i + 2);
      const uint4 d = __ldg(q + 4 * i + 3);
      o[i] = make_uint4(pack4<T>(a, pred), pack4<T>(b, pred), pack4<T>(c, pred),
                        pack4<T>(d, pred));
    }
    tail = units * kMaskRows;
  }
  for (long long i = tail + thread_index(); i < n; i += grid_stride())
    out[i] = pred(__ldg(x + i));
}

// out[i] = pred(x[i]) for the n rows of x, in one launch.
template <typename T, typename Pred>
inline int launch_mask(const void* x, long long n, Pred pred, void* out, void* stream) {
  static const int per_sm = resident_blocks(mask_kernel<T, Pred>, kMaskThreads);
  const int vec = aligned(x, 16) && aligned(out, 16);
  const long long units = vec ? (n + kMaskRows - 1) / kMaskRows : n;
  mask_kernel<T, Pred><<<one_wave(units, kMaskThreads, per_sm), kMaskThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, pred, vec, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hs
