// masked_minmax: (min, max) over the valid rows of an int32 or float32
// column, the MinMax sketch's per-file reduction.
//
// Replaces: hyperspace_tpu/ops/pallas_kernels.py masked_minmax
// (pallas_call at :334 without a mask, :349 with one; bodies
// _minmax_nomask_kernel :278-301 and _minmax_kernel :258-275).
// Semantics, as the JAX kernel computes them:
//   - the sentinels (dtype max for the min, dtype min for the max; FLT_MAX
//     and -FLT_MAX for float32, not +-inf) enter the reduction exactly when
//     some lane is invalid: a row whose mask is False, or a lane past the
//     column. The Pallas kernel pads the column to a multiple of 32,768
//     lanes; the wrapper passes `pad` for a column whose length is not one
//     (and the MinMax sketch for the JAX package's length classes). So
//     [+inf] * 3 gives (FLT_MAX, +inf), [+inf] * 32768 gives (+inf, +inf),
//     and no valid row gives (max, min);
//   - -0.0 orders below +0.0: the min of {0.0, -0.0} is -0.0, the max +0.0;
//   - a valid NaN makes both results NaN, its bits passed on unchanged
//     (sign, payload, a signalling NaN unquieted); where the valid NaNs
//     carry more than one bit pattern the min is the pattern smallest as an
//     unsigned integer and the max the largest (the Pallas kernel's choice
//     there follows the order of its reduction tree). An invalid NaN is
//     ignored.
//
// What bounds it on the card: bytes (4 read per row, plus 1 with a mask);
// a few integer operations per row are nothing to the ALUs. At one orders
// file (937,500 rows, 3.75 MB) the bound is about a microsecond, less than
// a launch, so the design cuts what is around the pass as much as the pass:
//   - one launch per call and nothing else on the stream: the scratch words
//     live in a buffer kept per stream by the wrapper, zeroed once when it
//     is made; the last block reads them, writes the result and puts them
//     back to zero, so the next launch on that stream finds them ready
//     (launches on one stream run in order, so no call sees another's);
//   - one wave of blocks of 512 threads, at most 2 per SM and no more than
//     the column needs, each thread with four 16-byte loads in flight (and
//     four 4-byte mask loads), issued before the first row is reduced;
//     unaligned columns and the ragged tail take a one-row loop;
//   - a row becomes an order-preserving unsigned 32-bit key (int32: flip
//     the sign bit; float32: flip the sign bit of a positive, every bit of
//     a negative), so min and max are integer operations, exact in any
//     order; a NaN goes to two pattern words instead;
//   - warp reductions (__reduce_*_sync), then shared memory, reduce the
//     block to one set of words; one atomic per word per block (about a
//     hundred blocks at one orders file, 264 at most) and a counter after
//     a fence elect the last block.
// The output also carries whether any row was valid, so the sketch needs
// no reduction of its own over the mask. No mask is streamed for a column
// without nulls: the wrapper passes null.
#include "hs_common.cuh"

namespace {

constexpr uint32_t kSign = 0x80000000u;
constexpr int kThreadsPerBlock = 512;
constexpr int kBlocksPerSM = 2;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

constexpr uint32_t kAnyValid = 1u;
constexpr uint32_t kAnyInvalid = 2u;

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

// One thread's (then one warp's, one block's) part of the reduction. Every
// field but `lo` starts at 0, the value the scratch words hold between
// launches.
struct Acc {
  uint32_t lo = 0xFFFFFFFFu;  // least key
  uint32_t hi = 0u;           // greatest key
  uint32_t nan_lo = 0u;       // complement of the least NaN pattern
  uint32_t nan_hi = 0u;       // greatest NaN pattern (0: no NaN; no NaN is 0)
  uint32_t flags = 0u;        // kAnyValid | kAnyInvalid
};

template <typename K>
__device__ __forceinline__ void take(Acc& a, uint32_t b, bool valid) {
  if (!valid) {
    a.flags |= kAnyInvalid;
    return;
  }
  a.flags |= kAnyValid;
  if (K::is_nan(b)) {
    a.nan_lo = max(a.nan_lo, ~b);
    a.nan_hi = max(a.nan_hi, b);
    return;
  }
  const uint32_t k = K::key(b);
  a.lo = min(a.lo, k);
  a.hi = max(a.hi, k);
}

template <typename K>
__device__ __forceinline__ void take4(Acc& a, const uint4& w, uchar4 m) {
  take<K>(a, w.x, m.x != 0);
  take<K>(a, w.y, m.y != 0);
  take<K>(a, w.z, m.z != 0);
  take<K>(a, w.w, m.w != 0);
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
  a.lo = __reduce_min_sync(0xFFFFFFFFu, a.lo);
  a.hi = __reduce_max_sync(0xFFFFFFFFu, a.hi);
  a.nan_lo = __reduce_max_sync(0xFFFFFFFFu, a.nan_lo);
  a.nan_hi = __reduce_max_sync(0xFFFFFFFFu, a.nan_hi);
  a.flags = __reduce_or_sync(0xFFFFFFFFu, a.flags);
}

// Scratch words, all 0 between launches:
//   [0] complement of the least key      (atomicMax)
//   [1] greatest key                     (atomicMax)
//   [2] complement of the least NaN bits (atomicMax)
//   [3] greatest NaN bits                (atomicMax)
//   [4] kAnyValid | kAnyInvalid          (atomicOr)
//   [5] blocks finished                  (atomicAdd)
// out: [min bits, max bits, any row valid (0/1), 0].
template <typename K>
__global__ void __launch_bounds__(kThreadsPerBlock)
masked_minmax_kernel(const uint32_t* __restrict__ x, const uint8_t* __restrict__ valid,
                     long long n, int vec, int pad, uint32_t* __restrict__ scratch,
                     uint32_t* __restrict__ out) {
  Acc a;
  long long tail = 0;
  if (vec) {
    const long long quads = n / 4;
    const uint4* q = reinterpret_cast<const uint4*>(x);
    const uchar4* v = reinterpret_cast<const uchar4*>(valid);
    const long long step = static_cast<long long>(gridDim.x) * blockDim.x * kUnroll;
    for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x * kUnroll +
                          threadIdx.x;
         base < quads; base += step) {
      uint4 w[kUnroll];
      uchar4 m[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = base + static_cast<long long>(j) * blockDim.x;
        if (i < quads) {
          w[j] = __ldg(q + i);
          m[j] = valid != nullptr ? __ldg(v + i) : make_uchar4(1, 1, 1, 1);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (base + static_cast<long long>(j) * blockDim.x < quads) take4<K>(a, w[j], m[j]);
    }
    tail = quads * 4;
  }
  for (long long i = tail + hs::thread_index(); i < n; i += hs::grid_stride())
    take<K>(a, __ldg(x + i), valid == nullptr || __ldg(valid + i) != 0);

  warp_reduce(a);
  __shared__ uint32_t s[5][kThreadsPerBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s[0][warp] = a.lo;
    s[1][warp] = a.hi;
    s[2][warp] = a.nan_lo;
    s[3][warp] = a.nan_hi;
    s[4][warp] = a.flags;
  }
  __syncthreads();
  if (warp != 0) return;
  Acc b;
  if (lane < static_cast<int>((blockDim.x + 31) >> 5)) {
    b.lo = s[0][lane];
    b.hi = s[1][lane];
    b.nan_lo = s[2][lane];
    b.nan_hi = s[3][lane];
    b.flags = s[4][lane];
  }
  warp_reduce(b);
  if (lane != 0) return;
  if (~b.lo) atomicMax(scratch + 0, ~b.lo);
  if (b.hi) atomicMax(scratch + 1, b.hi);
  if (b.nan_hi) {
    atomicMax(scratch + 2, b.nan_lo);
    atomicMax(scratch + 3, b.nan_hi);
  }
  if (b.flags) atomicOr(scratch + 4, b.flags);
  __threadfence();
  if (atomicAdd(scratch + 5, 1u) != gridDim.x - 1) return;
  // The last block: every other block fenced its atomics before counting.
  // Read each word and put it back to 0 for the next launch on the stream.
  __threadfence();
  uint32_t lo = ~atomicExch(scratch + 0, 0u);
  uint32_t hi = atomicExch(scratch + 1, 0u);
  const uint32_t nan_lo = ~atomicExch(scratch + 2, 0u);
  const uint32_t nan_hi = atomicExch(scratch + 3, 0u);
  const uint32_t flags = atomicExch(scratch + 4, 0u) | (pad ? kAnyInvalid : 0u);
  atomicExch(scratch + 5, 0u);
  if (flags & kAnyInvalid) {
    lo = min(lo, K::key(K::kMaxSentinel));
    hi = max(hi, K::key(K::kMinSentinel));
  }
  out[0] = nan_hi ? nan_lo : K::bits(lo);
  out[1] = nan_hi ? nan_hi : K::bits(hi);
  out[2] = (flags & kAnyValid) ? 1u : 0u;
  out[3] = 0u;
}

template <typename K>
int launch(const void* x, const void* valid, long long n, int pad, void* scratch,
           void* out, cudaStream_t stream) {
  const int vec = hs::aligned(x, 16) && (valid == nullptr || hs::aligned(valid, 4));
  const long long units = vec ? (n / 4 + kUnroll - 1) / kUnroll : n;
  const int blocks = hs::one_wave(units, kThreadsPerBlock, kBlocksPerSM);
  masked_minmax_kernel<K><<<blocks, kThreadsPerBlock, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint8_t*>(valid), n, vec, pad,
      static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 2 float32. valid: bool[n] or null (every row valid).
// pad: nonzero when the sentinels enter whatever the mask holds. out: 4
// words, (min bits, max bits, any row valid, 0). scratch: 6 words of
// `stream`'s own buffer, 0 on entry and left 0. Returns the first CUDA
// error, or 0.
extern "C" int hs_masked_minmax(const void* x, const void* valid, int dtype,
                                long long n, int pad, void* out, void* scratch,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kInt32: return launch<IntKey>(x, valid, n, pad, scratch, out, s);
    case kFloat32: return launch<FloatKey>(x, valid, n, pad, scratch, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
