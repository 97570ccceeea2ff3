// K3 — 64-bit mix of group-by key columns; K3b — its 32-bit sibling for
// join probes.
//
// Replaces siddhi_tpu/ops/groupby.py `hash_columns`. The wrapper turns each
// key column into int64 words exactly as the JAX function does (float32 ->
// int32 bits sign-extended, float64 -> int64 bits, integers widened) and
// stacks them [k, n]; this kernel folds them per lane with
//   h = (h ^ x) * 0x100000001B3;  h ^= h >> 29
// in uint64, starting from 0xCBF29CE484222325. Bit for bit with JAX.
//
// Bound on the H100: bytes. Each lane reads 8k bytes and writes 8; the
// multiply-xor chain is a handful of integer operations per word, far below
// the card's integer rate. Design: one thread per lane, column-major words
// so neighbouring threads read neighbouring addresses (coalesced).

// K3b replaces siddhi_tpu/ops/groupby.py `hash_columns32` together with
// the remap and mask of siddhi_tpu/ops/join.py `_hash_exprs` and
// `probe_equi`: per lane, in u32,
//   h = (h ^ x) * 0x01000193;  h ^= h >> 15
// over each column's 32-bit words from 0x811C9DC5 (8-byte columns low word
// first, floats by their bits, bools as 0/1), then optionally
// 0xFFFFFFFF -> 0xFFFFFFFE and, where a validity mask is given, 0xFFFFFFFF
// on invalid lanes. Bit for bit with JAX.
//
// Bound on the H100: bytes (4 or 8 bytes a column and 4 out per lane; the
// mix is a few integer operations a word). Design: one thread per lane;
// the column pointers and kinds ride in the parameter block, MAX_COLS32 a
// launch; a wider key starts the next launch from the running hash.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_COLS32 = 32;

// kind: 0 = 4-byte value, 1 = 8-byte value, 2 = bool (one byte).
struct HashCols {
  const void* ptr[MAX_COLS32];
  int kind[MAX_COLS32];
  int n;
};

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t x) {
  h = (h ^ x) * 0x01000193u;
  return h ^ (h >> 15);
}

__global__ void k3b_hash32_kernel(HashCols cols, long long n,
                                  const uint32_t* h_in,
                                  const uint8_t* __restrict__ valid,
                                  int remap, uint32_t* out) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t h = h_in != nullptr ? h_in[i] : 0x811C9DC5u;
  for (int c = 0; c < cols.n; ++c) {
    const int kind = cols.kind[c];
    if (kind == 1) {
      const unsigned long long v =
          static_cast<const unsigned long long*>(cols.ptr[c])[i];
      h = mix32(h, static_cast<uint32_t>(v));
      h = mix32(h, static_cast<uint32_t>(v >> 32));
    } else if (kind == 2) {
      h = mix32(h, static_cast<const uint8_t*>(cols.ptr[c])[i] != 0);
    } else {
      h = mix32(h, static_cast<const uint32_t*>(cols.ptr[c])[i]);
    }
  }
  if (remap && h == 0xFFFFFFFFu) h = 0xFFFFFFFEu;
  if (valid != nullptr && !valid[i]) h = 0xFFFFFFFFu;
  out[i] = h;
}

__global__ void k3_hash_kernel(const int64_t* __restrict__ words, int k,
                               long long n, int64_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  unsigned long long h = 0xCBF29CE484222325ull;
  for (int c = 0; c < k; ++c) {
    const unsigned long long x =
        static_cast<unsigned long long>(words[c * n + i]);
    h = (h ^ x) * 0x100000001B3ull;
    h ^= h >> 29;
  }
  out[i] = static_cast<int64_t>(h);
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// words: int64[k, n] row-major; out: int64[n].
SIDDHI_API int k3_hash_columns(const int64_t* words, int k, long long n,
                               int64_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  k3_hash_kernel<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(words, k, n,
                                                                out);
  return siddhi_launch_status();
}

SIDDHI_API int k3b_max_cols() { return MAX_COLS32; }

// ptrs/kinds: host arrays of ncols <= MAX_COLS32 column pointers; h_in:
// the running hash of earlier columns or null; valid: bool[n] or null;
// remap: apply the 0xFFFFFFFF -> 0xFFFFFFFE remap; out: u32[n] (may be
// h_in).
SIDDHI_API int k3b_hash_columns32(const void* const* ptrs, const int* kinds,
                                  int ncols, long long n,
                                  const uint32_t* h_in, const uint8_t* valid,
                                  int remap, uint32_t* out,
                                  cudaStream_t stream) {
  if (ncols < 0 || ncols > MAX_COLS32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  HashCols cols;
  cols.n = ncols;
  for (int c = 0; c < ncols; ++c) {
    cols.ptr[c] = ptrs[c];
    cols.kind[c] = kinds[c];
  }
  k3b_hash32_kernel<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(
      cols, n, h_in, valid, remap, out);
  return siddhi_launch_status();
}
