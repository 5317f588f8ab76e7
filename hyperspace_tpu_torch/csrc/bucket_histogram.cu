// bucket_histogram: int32 row count for each bucket id.
//
// Replaces: hyperspace_tpu/ops/pallas_kernels.py bucket_histogram
// (pallas_call at :402; body _hist_kernel :369-391). Ids outside
// [0, num_buckets) -- the -1 pad lanes there -- count nowhere.
//
// What bounds it on the card: bytes (4 per row read; the output is
// num_buckets ints). The TPU kernel carried one accumulator across a
// sequential grid; here blocks run in parallel in no order, so each block
// counts into a private histogram in shared memory and adds it into the
// global one with one integer atomicAdd per bucket at the end. Integer
// atomics make the count exact whatever the order. Rows are read four at a
// time (16-byte loads) when the column is 16-byte aligned. When the
// histogram does not fit the 48 KiB of shared memory a block gets without
// opting in (more than 12288 buckets), the same kernel counts with global
// atomics instead; the wrapper has one path.
#include "hs_common.cuh"

constexpr int kSmemBuckets = 48 * 1024 / 4;

__device__ __forceinline__ void count_one(int32_t b, int num_buckets,
                                          int32_t* hist) {
  if (static_cast<uint32_t>(b) < static_cast<uint32_t>(num_buckets))
    atomicAdd(hist + b, 1);
}

__global__ void bucket_histogram_kernel(const int32_t* __restrict__ bids,
                                        long long n, int num_buckets,
                                        int use_smem, int vec,
                                        int32_t* __restrict__ counts) {
  extern __shared__ int32_t local[];
  int32_t* hist = use_smem ? local : counts;
  if (use_smem) {
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) local[b] = 0;
    __syncthreads();
  }
  long long tail = 0;
  if (vec) {
    const long long quads = n / 4;
    const int4* q = reinterpret_cast<const int4*>(bids);
    for (long long i = hs::thread_index(); i < quads; i += hs::grid_stride()) {
      const int4 v = __ldg(q + i);
      count_one(v.x, num_buckets, hist);
      count_one(v.y, num_buckets, hist);
      count_one(v.z, num_buckets, hist);
      count_one(v.w, num_buckets, hist);
    }
    tail = quads * 4;
  }
  for (long long i = tail + hs::thread_index(); i < n; i += hs::grid_stride())
    count_one(__ldg(bids + i), num_buckets, hist);
  if (use_smem) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x)
      if (local[b] != 0) atomicAdd(counts + b, local[b]);
  }
}

// counts must hold num_buckets zeros on entry. Returns cudaGetLastError().
extern "C" int hs_bucket_histogram(const void* bids, long long n,
                                   int num_buckets, void* counts,
                                   void* stream) {
  if (num_buckets <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int use_smem = num_buckets <= kSmemBuckets;
  const int vec = hs::aligned(bids, 16);
  const size_t smem = use_smem ? static_cast<size_t>(num_buckets) * 4 : 0;
  const long long work = vec ? (n + 3) / 4 : n;
  bucket_histogram_kernel<<<hs::grid_for(work), hs::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bids), n, num_buckets, use_smem, vec,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
