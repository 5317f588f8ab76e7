// range_mask: lo <(=) x <(=) hi over a 4-byte column, one bool per row --
// the BETWEEN hot path.
//
// Replaces: hyperspace_tpu/ops/pallas_kernels.py fused_range_mask
// (pallas_call at :237; body _range_kernel :218-224). Both bounds arrive
// already cast to the column's dtype, passed as their 32-bit patterns;
// the inclusive/exclusive flags are template parameters.
//
// What bounds it on the card: bytes (4 read + 1 written per row). One pass
// replaces two compare passes and an AND, which would move the column
// twice and two intermediate masks. Rows move sixteen at a time per
// thread, four 16-byte loads and one 16-byte store, over a one-wave grid
// (mask_common.cuh).
#include "mask_common.cuh"

template <typename T, bool LO_INCL, bool HI_INCL>
struct RangePred {
  T lo, hi;
  __device__ __forceinline__ uint8_t operator()(T x) const {
    const bool above = LO_INCL ? (x >= lo) : (x > lo);
    const bool below = HI_INCL ? (x <= hi) : (x < hi);
    return above && below;
  }
};

template <typename T>
static int dispatch_flags(const void* x, long long n, uint32_t lo_bits,
                          uint32_t hi_bits, int lo_incl, int hi_incl,
                          void* out, void* stream) {
  const T lo = hs::host_from_bits<T>(lo_bits);
  const T hi = hs::host_from_bits<T>(hi_bits);
  if (lo_incl && hi_incl)
    return hs::launch_mask<T>(x, n, RangePred<T, true, true>{lo, hi}, out, stream);
  if (lo_incl)
    return hs::launch_mask<T>(x, n, RangePred<T, true, false>{lo, hi}, out, stream);
  if (hi_incl)
    return hs::launch_mask<T>(x, n, RangePred<T, false, true>{lo, hi}, out, stream);
  return hs::launch_mask<T>(x, n, RangePred<T, false, false>{lo, hi}, out, stream);
}

// dtype: 0 int32, 1 uint32, 2 float32. Returns cudaGetLastError().
extern "C" int hs_range_mask(const void* x, int dtype, long long n,
                             unsigned int lo_bits, unsigned int hi_bits,
                             int lo_incl, int hi_incl, void* out,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case hs::kInt32:
      return dispatch_flags<int32_t>(x, n, lo_bits, hi_bits, lo_incl, hi_incl, out, stream);
    case hs::kUInt32:
      return dispatch_flags<uint32_t>(x, n, lo_bits, hi_bits, lo_incl, hi_incl, out, stream);
    case hs::kFloat32:
      return dispatch_flags<float>(x, n, lo_bits, hi_bits, lo_incl, hi_incl, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
