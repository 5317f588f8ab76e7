// hash_bucket: combined murmur3-finalizer hash of up to 8 pre-folded u32
// columns and its bucket id, in one pass.
//
// Replaces: hyperspace_tpu/ops/pallas_kernels.py fused_hash_bucket
// (pallas_call at :146; body _hash_bucket_kernel :118-126, _fmix32
// :109-115). Same arithmetic: fmix32 each column, boost-combine
//   h ^= hc + 0x9E3779B9 + (h << 6) + (h >> 2)
// in wrapping uint32, bucket = h % num_buckets.
//
// What bounds it on the card: bytes. Per row it reads 4 bytes per column
// and writes 4 bytes of bucket id (plus 4 of hash when asked); the ~12
// integer operations per column are far below the card's integer rate.
// Design: one thread per row in a grid-stride loop, so each warp reads
// 128 contiguous bytes of every column per step; the column count is a
// template parameter, so the per-column loop unrolls and the pointers stay
// in registers. Columns are separate inputs, never stacked into a copy.
// The hash output is optional: the index build needs only bucket ids, and
// skipping the hash store saves a third of the traffic.
#include "hs_common.cuh"

#define HS_MAX_HASH_COLS 8

struct HashCols {
  const uint32_t* col[HS_MAX_HASH_COLS];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <int NCOLS>
__global__ void hash_bucket_kernel(HashCols cols, long long n,
                                   uint32_t num_buckets,
                                   uint32_t* __restrict__ hash_out,
                                   int32_t* __restrict__ bid_out) {
  for (long long i = hs::thread_index(); i < n; i += hs::grid_stride()) {
    uint32_t h = fmix32(__ldg(cols.col[0] + i));
#pragma unroll
    for (int c = 1; c < NCOLS; ++c) {
      const uint32_t hc = fmix32(__ldg(cols.col[c] + i));
      h ^= hc + 0x9E3779B9u + (h << 6) + (h >> 2);
    }
    if (hash_out != nullptr) hash_out[i] = h;
    bid_out[i] = static_cast<int32_t>(h % num_buckets);
  }
}

template <int NCOLS>
static void launch(const HashCols& cols, long long n, uint32_t num_buckets,
                   uint32_t* hash_out, int32_t* bid_out, cudaStream_t stream) {
  hash_bucket_kernel<NCOLS><<<hs::grid_for(n), hs::kThreads, 0, stream>>>(
      cols, n, num_buckets, hash_out, bid_out);
}

// cols: host array of `ncols` device pointers to u32 words (n each).
// hash_out may be null. Returns cudaGetLastError() after the launch.
extern "C" int hs_hash_bucket(const void* const* cols, int ncols, long long n,
                              unsigned int num_buckets, void* hash_out,
                              void* bid_out, void* stream) {
  if (ncols < 1 || ncols > HS_MAX_HASH_COLS || num_buckets == 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HashCols hc;
  for (int c = 0; c < HS_MAX_HASH_COLS; ++c)
    hc.col[c] = c < ncols ? static_cast<const uint32_t*>(cols[c]) : nullptr;
  uint32_t* h = static_cast<uint32_t*>(hash_out);
  int32_t* b = static_cast<int32_t*>(bid_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: launch<1>(hc, n, num_buckets, h, b, s); break;
    case 2: launch<2>(hc, n, num_buckets, h, b, s); break;
    case 3: launch<3>(hc, n, num_buckets, h, b, s); break;
    case 4: launch<4>(hc, n, num_buckets, h, b, s); break;
    case 5: launch<5>(hc, n, num_buckets, h, b, s); break;
    case 6: launch<6>(hc, n, num_buckets, h, b, s); break;
    case 7: launch<7>(hc, n, num_buckets, h, b, s); break;
    default: launch<8>(hc, n, num_buckets, h, b, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
