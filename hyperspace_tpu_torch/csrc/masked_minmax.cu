// masked_minmax: (min, max) over the valid rows of an int32 or float32
// column, the MinMax sketch's per-file reduction.
//
// Replaces: hyperspace_tpu/ops/pallas_kernels.py masked_minmax
// (pallas_call at :334 without a mask, :349 with one; bodies
// _minmax_nomask_kernel :278-301 and _minmax_kernel :258-275).
// Semantics, as the JAX kernel computes them:
//   - the reduction starts from the sentinels (dtype max for the min, dtype
//     min for the max; FLT_MAX and -FLT_MAX for float32, not +-inf), so an
//     input with no valid row returns (max, min);
//   - -0.0 orders below +0.0: the min of {0.0, -0.0} is -0.0, the max +0.0;
//   - one valid NaN makes both results NaN (0x7FC00000); an invalid NaN is
//     ignored.
//
// What bounds it on the card: bytes (4 read per row, plus 1 with a mask);
// a few integer operations per row are nothing to the ALUs. The TPU kernel
// carried one scalar along a sequential grid. Here blocks run in parallel
// in no order, so:
//   - each thread walks the column with a grid-stride loop, four rows per
//     16-byte load (and four mask bytes per 4-byte load) where aligned, one
//     row at a time otherwise and on the ragged tail;
//   - a row becomes an order-preserving unsigned 32-bit key (int32: flip
//     the sign bit; float32: flip the sign bit of a positive, every bit of
//     a negative), so min and max are integer operations, exact in any
//     order, and -0.0 sorts below +0.0; NaN sets a flag instead;
//   - warp shuffles, then shared memory, reduce the block to one key pair;
//   - one atomicMax per block on the complement of the least key and on
//     the greatest key, one atomicOr on the NaN flag; the last block to
//     finish (a counter after a fence) decodes the keys into the output.
// The wrapper passes 4 words of scratch; they are zeroed on the launch's
// stream before the kernel, so the call needs no host synchronisation.
// No mask is streamed for a column without nulls: the wrapper passes null.
#include "hs_common.cuh"

namespace {

constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kCanonicalNaN = 0x7FC00000u;

enum DType { kInt32 = 0, kFloat32 = 2 };  // the wrapper's dtype codes

struct IntKey {
  static constexpr uint32_t kMinSentinel = 0x80000000u;  // INT32_MIN
  static constexpr uint32_t kMaxSentinel = 0x7FFFFFFFu;  // INT32_MAX
  __device__ __forceinline__ static bool is_nan(uint32_t) { return false; }
  __device__ __forceinline__ static uint32_t key(uint32_t b) { return b ^ kSign; }
  __device__ __forceinline__ static uint32_t bits(uint32_t k) { return k ^ kSign; }
};

struct FloatKey {
  static constexpr uint32_t kMinSentinel = 0xFF7FFFFFu;  // -FLT_MAX
  static constexpr uint32_t kMaxSentinel = 0x7F7FFFFFu;  // FLT_MAX
  __device__ __forceinline__ static bool is_nan(uint32_t b) {
    return (b & 0x7FFFFFFFu) > 0x7F800000u;
  }
  __device__ __forceinline__ static uint32_t key(uint32_t b) {
    return (b & kSign) ? ~b : (b | kSign);
  }
  __device__ __forceinline__ static uint32_t bits(uint32_t k) {
    return (k & kSign) ? (k ^ kSign) : ~k;
  }
};

struct Acc {
  uint32_t lo = 0xFFFFFFFFu;  // least key seen
  uint32_t hi = 0u;           // greatest key seen
  uint32_t nan = 0u;          // a valid NaN was seen
};

template <typename K>
__device__ __forceinline__ void take(Acc& a, uint32_t b, bool valid) {
  if (!valid) return;
  if (K::is_nan(b)) {
    a.nan = 1u;
    return;
  }
  const uint32_t k = K::key(b);
  a.lo = min(a.lo, k);
  a.hi = max(a.hi, k);
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
  a.lo = __reduce_min_sync(0xFFFFFFFFu, a.lo);
  a.hi = __reduce_max_sync(0xFFFFFFFFu, a.hi);
  a.nan = __reduce_or_sync(0xFFFFFFFFu, a.nan);
}

// scratch[0]: complement of the least key (atomicMax; 0 = nothing yet)
// scratch[1]: greatest key (atomicMax; 0 = nothing yet)
// scratch[2]: NaN flag (atomicOr)
// scratch[3]: blocks finished
template <typename K>
__global__ void masked_minmax_kernel(const uint32_t* __restrict__ x,
                                     const uint8_t* __restrict__ valid,
                                     long long n, int vec,
                                     uint32_t* __restrict__ scratch,
                                     uint32_t* __restrict__ out) {
  Acc a;
  long long tail = 0;
  if (vec) {
    const long long quads = n / 4;
    const uint4* q = reinterpret_cast<const uint4*>(x);
    if (valid != nullptr) {
      const uchar4* v = reinterpret_cast<const uchar4*>(valid);
      for (long long i = hs::thread_index(); i < quads; i += hs::grid_stride()) {
        const uint4 w = __ldg(q + i);
        const uchar4 m = __ldg(v + i);
        take<K>(a, w.x, m.x);
        take<K>(a, w.y, m.y);
        take<K>(a, w.z, m.z);
        take<K>(a, w.w, m.w);
      }
    } else {
      for (long long i = hs::thread_index(); i < quads; i += hs::grid_stride()) {
        const uint4 w = __ldg(q + i);
        take<K>(a, w.x, true);
        take<K>(a, w.y, true);
        take<K>(a, w.z, true);
        take<K>(a, w.w, true);
      }
    }
    tail = quads * 4;
  }
  for (long long i = tail + hs::thread_index(); i < n; i += hs::grid_stride())
    take<K>(a, __ldg(x + i), valid == nullptr || __ldg(valid + i) != 0);

  warp_reduce(a);
  __shared__ uint32_t s_lo[32], s_hi[32], s_nan[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = a.lo;
    s_hi[warp] = a.hi;
    s_nan[warp] = a.nan;
  }
  __syncthreads();
  if (warp != 0) return;
  const int warps = (blockDim.x + 31) >> 5;
  Acc b;
  if (lane < warps) {
    b.lo = s_lo[lane];
    b.hi = s_hi[lane];
    b.nan = s_nan[lane];
  }
  warp_reduce(b);
  if (lane != 0) return;
  atomicMax(scratch + 0, ~b.lo);
  atomicMax(scratch + 1, b.hi);
  if (b.nan) atomicOr(scratch + 2, 1u);
  __threadfence();
  if (atomicAdd(scratch + 3, 1u) != gridDim.x - 1) return;
  // The last block: every other block fenced its atomics before counting.
  const uint32_t lo = min(~atomicOr(scratch + 0, 0u), K::key(K::kMaxSentinel));
  const uint32_t hi = max(atomicOr(scratch + 1, 0u), K::key(K::kMinSentinel));
  const bool nan = atomicOr(scratch + 2, 0u) != 0u;
  out[0] = nan ? kCanonicalNaN : K::bits(lo);
  out[1] = nan ? kCanonicalNaN : K::bits(hi);
}

template <typename K>
int launch(const void* x, const void* valid, long long n, void* scratch,
           void* out, cudaStream_t stream) {
  const int vec = hs::aligned(x, 16) && (valid == nullptr || hs::aligned(valid, 4));
  const long long work = vec ? (n + 3) / 4 : n;
  masked_minmax_kernel<K><<<hs::grid_for(work), hs::kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint8_t*>(valid), n,
      vec, static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 2 float32. valid: bool[n] or null (every row valid).
// scratch: 4 words, zeroed here on the stream. out: the column's dtype[2],
// (min, max). Returns the first CUDA error, or 0.
extern "C" int hs_masked_minmax(const void* x, const void* valid, int dtype,
                                long long n, void* scratch, void* out,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, 4 * sizeof(uint32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  switch (dtype) {
    case kInt32: return launch<IntKey>(x, valid, n, scratch, out, s);
    case kFloat32: return launch<FloatKey>(x, valid, n, scratch, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
