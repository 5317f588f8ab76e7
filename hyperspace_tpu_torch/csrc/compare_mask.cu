// compare_mask: x <op> literal over a 4-byte column, one bool per row.
//
// Replaces: hyperspace_tpu/ops/pallas_kernels.py fused_compare_mask
// (pallas_call at :201; body _compare_kernel :173-188). The literal
// arrives already cast to the column's dtype (as the JAX kernel's
// jnp.array([[value]], dtype=x.dtype) does), passed as its 32-bit pattern.
// Float comparisons are IEEE: NaN compares false, except under !=.
//
// What bounds it on the card: bytes (4 read + 1 written per row); one
// comparison per row is nothing to the ALUs. Design: the op is a template
// parameter (no per-row branch) and rows move four at a time, 16-byte
// loads and 4-byte stores (mask_common.cuh).
#include "mask_common.cuh"

enum Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

template <typename T, int OP>
struct ComparePred {
  T v;
  __device__ __forceinline__ uint8_t operator()(T x) const {
    if (OP == kEq) return x == v;
    if (OP == kNe) return x != v;
    if (OP == kLt) return x < v;
    if (OP == kLe) return x <= v;
    if (OP == kGt) return x > v;
    return x >= v;
  }
};

template <typename T>
static int dispatch_op(const void* x, long long n, uint32_t lit_bits, int op,
                       void* out, void* stream) {
  const T v = hs::host_from_bits<T>(lit_bits);
  switch (op) {
    case kEq: return hs::launch_mask<T>(x, n, ComparePred<T, kEq>{v}, out, stream);
    case kNe: return hs::launch_mask<T>(x, n, ComparePred<T, kNe>{v}, out, stream);
    case kLt: return hs::launch_mask<T>(x, n, ComparePred<T, kLt>{v}, out, stream);
    case kLe: return hs::launch_mask<T>(x, n, ComparePred<T, kLe>{v}, out, stream);
    case kGt: return hs::launch_mask<T>(x, n, ComparePred<T, kGt>{v}, out, stream);
    case kGe: return hs::launch_mask<T>(x, n, ComparePred<T, kGe>{v}, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 int32, 1 uint32, 2 float32. op: 0 ==, 1 !=, 2 <, 3 <=, 4 >, 5 >=.
// Returns cudaGetLastError() after the launch.
extern "C" int hs_compare_mask(const void* x, int dtype, long long n,
                               unsigned int lit_bits, int op, void* out,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case hs::kInt32: return dispatch_op<int32_t>(x, n, lit_bits, op, out, stream);
    case hs::kUInt32: return dispatch_op<uint32_t>(x, n, lit_bits, op, out, stream);
    case hs::kFloat32: return dispatch_op<float>(x, n, lit_bits, op, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
