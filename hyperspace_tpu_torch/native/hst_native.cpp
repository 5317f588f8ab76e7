// Native host-side loops: the sketch probes of scan planning and the avro
// block decoder (counterpart of hyperspace_tpu/native/hst_native.cpp, the
// same entry points and argument types).
//
// Scan planning probes per-file sketches (MinMax ranges, bloom bitsets) for
// every candidate file of a query: a host-side loop at lake scale
// (thousands of files x predicates), independent of the device. This C++
// is built with g++ and loaded via ctypes
// (hyperspace_tpu_torch/native/__init__.py), with semantics mirroring the
// numpy implementations there bit for bit:
//
// - bloom bitsets are np.packbits layout (MSB-first within each byte);
// - probe positions are precomputed by the caller with the same wrapping
//   uint32 double-hashing as ops/sketches.py (device/host mirrored);
// - comparison ops are encoded 0..4 = between/lt/le/gt/ge.

#include <cstdint>

extern "C" {

// Probe n_filters equal-size packed bitsets for one literal whose k bit
// positions are precomputed. valid[i]==0 means "no sketch for this file"
// (missing bitset) -> keep (out=1).
void hst_bloom_probe_many(const uint8_t* bits, int64_t stride_bytes,
                          int64_t n_filters, const uint8_t* valid,
                          const int32_t* positions, int32_t n_pos,
                          uint8_t* out) {
  for (int64_t f = 0; f < n_filters; ++f) {
    if (!valid[f]) {
      out[f] = 1;
      continue;
    }
    const uint8_t* b = bits + f * stride_bytes;
    uint8_t keep = 1;
    for (int32_t i = 0; i < n_pos; ++i) {
      const int32_t p = positions[i];
      if (!((b[p >> 3] >> (7 - (p & 7))) & 1)) {
        keep = 0;
        break;
      }
    }
    out[f] = keep;
  }
}

// op: 0 = equality probe (lo <= v <= hi), 1 = '<' (lo < v),
//     2 = '<=' (lo <= v), 3 = '>' (hi > v), 4 = '>=' (hi >= v).
// has[i]==0 -> all-null file stats: keep (out=1), matching the Python path.
#define MINMAX_PRUNE_IMPL(T)                                          \
  for (int64_t i = 0; i < n; ++i) {                                   \
    if (!has[i]) {                                                    \
      out[i] = 1;                                                     \
      continue;                                                       \
    }                                                                 \
    const T l = lo[i];                                                \
    const T h = hi[i];                                                \
    uint8_t keep = 1;                                                 \
    switch (op) {                                                     \
      case 0: keep = (l <= value) && (value <= h); break;             \
      case 1: keep = l < value; break;                                \
      case 2: keep = l <= value; break;                               \
      case 3: keep = h > value; break;                                \
      case 4: keep = h >= value; break;                               \
      default: keep = 1; break;                                       \
    }                                                                 \
    out[i] = keep;                                                    \
  }

void hst_minmax_prune_f64(const double* lo, const double* hi,
                          const uint8_t* has, int64_t n, double value,
                          int32_t op, uint8_t* out) {
  MINMAX_PRUNE_IMPL(double)
}

void hst_minmax_prune_i64(const int64_t* lo, const int64_t* hi,
                          const uint8_t* has, int64_t n, int64_t value,
                          int32_t op, uint8_t* out) {
  MINMAX_PRUNE_IMPL(int64_t)
}

// ---------------------------------------------------------------------------
// Avro block decoder (the data-loader hot loop for the avro source).
//
// Decodes one object-container-file block -- `count` rows of a flat record
// whose per-field plan is (prim, null_branch) -- into columnar buffers, the
// loop util/avro.py's plain decoder runs per row in Python. Semantics
// mirror the plain decoder bit for bit; the tests cross-check the two.
//
// prim codes: 0=boolean 1=int 2=long 3=float 4=double 5=string 6=bytes
// 7=null. null_branch is the union index of "null" (-1 = non-nullable).
//
// Outputs per field (caller-allocated; irrelevant pointers null):
//   ivals[f] : int64[count]  for prims 0-2
//   dvals[f] : double[count] for prims 3-4
//   offs[f]  : int32[count+1], sdata[f] : uint8[<= buf_len] for prims 5-6
//   valids[f]: uint8[count]
// Returns bytes consumed, or -1 truncated, -2 bad union branch,
// -3 varint too long, -4 unknown prim.
// ---------------------------------------------------------------------------

static inline int read_varint(const uint8_t* buf, int64_t len, int64_t* pos,
                              int64_t* out) {
  uint64_t acc = 0;
  int shift = 0;
  while (true) {
    if (*pos >= len) return -1;
    const uint8_t b = buf[(*pos)++];
    // Guard BEFORE shifting: a shift >= 64 is UB (would silently wrap on
    // x86 and feed a corrupted length into the memcpy bounds check).
    if (shift >= 64) return -3;
    acc |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
  return 0;
}

int64_t hst_avro_decode_block(const uint8_t* buf, int64_t buf_len,
                              int64_t count, int32_t n_fields,
                              const int32_t* plans, int64_t** ivals,
                              double** dvals, int32_t** offs,
                              uint8_t** sdata, int64_t* sdata_len,
                              uint8_t** valids) {
  int64_t pos = 0;
  for (int32_t f = 0; f < n_fields; ++f) {
    if (offs[f]) offs[f][0] = 0;
    if (sdata_len) sdata_len[f] = 0;
  }
  for (int64_t r = 0; r < count; ++r) {
    for (int32_t f = 0; f < n_fields; ++f) {
      const int32_t prim = plans[2 * f];
      const int32_t null_branch = plans[2 * f + 1];
      uint8_t is_valid = 1;
      if (null_branch >= 0) {
        int64_t branch;
        const int rc = read_varint(buf, buf_len, &pos, &branch);
        if (rc) return rc;
        if (branch < 0 || branch > 1) return -2;
        if (branch == null_branch) is_valid = 0;
      }
      valids[f][r] = is_valid;
      if (offs[f]) offs[f][r + 1] = offs[f][r];  // default: empty slot
      if (!is_valid) {
        if (ivals[f]) ivals[f][r] = 0;
        if (dvals[f]) dvals[f][r] = 0.0;
        continue;
      }
      switch (prim) {
        case 0: {  // boolean
          if (pos >= buf_len) return -1;
          ivals[f][r] = buf[pos++] != 0;
          break;
        }
        case 1:
        case 2: {  // int / long (shared zigzag varint encoding)
          int64_t v;
          const int rc = read_varint(buf, buf_len, &pos, &v);
          if (rc) return rc;
          ivals[f][r] = v;
          break;
        }
        case 3: {  // float (4-byte LE)
          if (pos + 4 > buf_len) return -1;
          float v;
          __builtin_memcpy(&v, buf + pos, 4);
          pos += 4;
          dvals[f][r] = static_cast<double>(v);
          break;
        }
        case 4: {  // double (8-byte LE)
          if (pos + 8 > buf_len) return -1;
          double v;
          __builtin_memcpy(&v, buf + pos, 8);
          pos += 8;
          dvals[f][r] = v;
          break;
        }
        case 5:
        case 6: {  // string / bytes: length + raw bytes
          int64_t n;
          const int rc = read_varint(buf, buf_len, &pos, &n);
          if (rc) return rc;
          // `pos + n` would overflow signed int64 for huge corrupt
          // lengths (UB) — compare against the remaining bytes instead.
          if (n < 0 || n > buf_len - pos) return -1;
          const int64_t at = sdata_len[f];
          __builtin_memcpy(sdata[f] + at, buf + pos, n);
          sdata_len[f] = at + n;
          offs[f][r + 1] = static_cast<int32_t>(at + n);
          pos += n;
          break;
        }
        case 7:  // null type: zero bytes
          break;
        default:
          return -4;
      }
    }
  }
  return pos;
}

}  // extern "C"
