// K2b — the packed FIFO ring of the sliding windows.
//
// Replaces siddhi_tpu/ops/windows.py `_pack_rows` + the gather of
// `compact_packed`, `_fetch_rel_packed`, `_append_packed` and
// `_gather_chunk_packed`. A window row is W 32-bit words in a word-major
// [W, L] matrix: each column in layout order (bool and 4-byte types one
// word, 8-byte types two words, low word first), then the int64 timestamp
// as two words. Four entry points, each a pure word copy or gather, so each
// is bit-exact against its plain version:
//   k2b_pack_compact  comp[:, j] = words of row order[j] (K1's order), read
//                     straight from the typed columns;
//   k2b_fetch         the E rows at overall indices base_idx + [0, E):
//                     ring[:, (base_idx + e) % C] for e < rel0, else batch
//                     row e - rel0 (zero past the batch, as the JAX padding
//                     gives it), rel0 = appended0 - base_idx;
//   k2b_append        ring[:, (appended0 + p) % C] = comp[:, p] for
//                     p < n_valid (B <= C, so one wrap at most); a launch of
//                     its own after the fetch, whose range it can overlap;
//   k2b_gather        one permutation gather of payload words, emit
//                     timestamp, valid and type into typed output columns.
// The scalars (base_idx, appended0, n_valid) stay on the device: the
// kernels read them, so a step never waits for the host.
//
// Bound on the H100: bytes. Each entry point reads and writes each word
// once (W = 6 for TradeStream: 24 bytes a row; 3.1 MB per 131072 rows).
// Design: one thread per row, looping over the W words, so stores along a
// word row coalesce; the column pointers and kinds travel in the kernel's
// parameter block (no device array, no host copy per step). A launch takes
// at most MAX_COLS columns starting at word row `word0`; the wrappers cover
// a wider layout with one launch per chunk of columns.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_COLS = 32;

// kind: 0 = 4-byte value, 1 = 8-byte value, 2 = bool (one byte).
struct Cols {
  const void* ptr[MAX_COLS];
  void* out[MAX_COLS];
  int kind[MAX_COLS];
  int n;
};

__device__ __forceinline__ long long floor_mod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void pack_compact(Cols cols, int word0,
                             const int32_t* __restrict__ order, int B,
                             uint32_t* __restrict__ comp) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= B) return;
  const int src = order[j];
  int w = word0;
  for (int c = 0; c < cols.n; ++c) {
    const int kind = cols.kind[c];
    if (kind == 1) {
      const unsigned long long v =
          static_cast<const unsigned long long*>(cols.ptr[c])[src];
      comp[static_cast<long long>(w) * B + j] = static_cast<uint32_t>(v);
      comp[static_cast<long long>(w + 1) * B + j] =
          static_cast<uint32_t>(v >> 32);
      w += 2;
    } else if (kind == 2) {
      comp[static_cast<long long>(w) * B + j] =
          static_cast<const uint8_t*>(cols.ptr[c])[src] != 0;
      w += 1;
    } else {
      comp[static_cast<long long>(w) * B + j] =
          static_cast<const uint32_t*>(cols.ptr[c])[src];
      w += 1;
    }
  }
}

__global__ void fetch(const uint32_t* __restrict__ ring, int C,
                      const uint32_t* __restrict__ comp, int B, int W, int E,
                      const int64_t* __restrict__ base_idx,
                      const int64_t* __restrict__ appended0,
                      uint32_t* __restrict__ out) {
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  const long long bi = base_idx[0];
  const int rel0 = static_cast<int>(appended0[0] - bi);
  if (e >= rel0) {
    // padded = [E zeros | comp (B) | zeros]; slice origin clip(E - rel0)
    long long start = static_cast<long long>(E) - rel0;
    start = start < 0 ? 0 : (start > E ? E : start);
    const long long p = start + e - E;
    const bool in = p >= 0 && p < B;
    for (int w = 0; w < W; ++w)
      out[static_cast<long long>(w) * E + e] =
          in ? comp[static_cast<long long>(w) * B + p] : 0u;
  } else {
    long long r = floor_mod(bi, C) + e;
    if (r >= C) r -= C;
    for (int w = 0; w < W; ++w)
      out[static_cast<long long>(w) * E + e] =
          ring[static_cast<long long>(w) * C + r];
  }
}

__global__ void append(uint32_t* __restrict__ ring, int C,
                       const uint32_t* __restrict__ comp, int B, int W,
                       const int64_t* __restrict__ appended0,
                       const int32_t* __restrict__ n_valid) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= B || p >= n_valid[0]) return;
  long long r = floor_mod(appended0[0], C) + p;
  if (r >= C) r -= C;
  for (int w = 0; w < W; ++w)
    ring[static_cast<long long>(w) * C + r] =
        comp[static_cast<long long>(w) * B + p];
}

// Payload words past the columns (the stored timestamp) are not read: the
// chunk carries the emit timestamp instead, written with valid and type by
// the launch that has `meta` set.
__global__ void gather(Cols cols, int word0, int meta,
                       const int32_t* __restrict__ order, int width,
                       const uint32_t* __restrict__ payload,
                       int L, const int64_t* __restrict__ emit_ts,
                       const uint8_t* __restrict__ valid,
                       const int8_t* __restrict__ types,
                       int64_t* __restrict__ ts_out,
                       uint8_t* __restrict__ valid_out,
                       int8_t* __restrict__ types_out) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= width) return;
  const int src = order[j];
  int w = word0;
  for (int c = 0; c < cols.n; ++c) {
    const int kind = cols.kind[c];
    const uint32_t lo = payload[static_cast<long long>(w) * L + src];
    if (kind == 1) {
      const uint32_t hi = payload[static_cast<long long>(w + 1) * L + src];
      static_cast<unsigned long long*>(cols.out[c])[j] =
          (static_cast<unsigned long long>(hi) << 32) | lo;
      w += 2;
    } else if (kind == 2) {
      static_cast<uint8_t*>(cols.out[c])[j] = lo != 0;
      w += 1;
    } else {
      static_cast<uint32_t*>(cols.out[c])[j] = lo;
      w += 1;
    }
  }
  if (!meta) return;
  ts_out[j] = emit_ts[src];
  valid_out[j] = valid[src];
  types_out[j] = types[src];
}

int fill_cols(Cols* cols, const void* const* ptrs, void* const* outs,
              const int* kinds, int n) {
  if (n < 0 || n > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  cols->n = n;
  for (int c = 0; c < n; ++c) {
    cols->ptr[c] = ptrs != nullptr ? ptrs[c] : nullptr;
    cols->out[c] = outs != nullptr ? outs[c] : nullptr;
    cols->kind[c] = kinds[c];
  }
  return 0;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k2b_max_cols() { return MAX_COLS; }

// ptrs/kinds: host arrays of ncols <= MAX_COLS column pointers (the
// timestamp, where this chunk holds it, last as an 8-byte column), packed
// from word row word0 on; order: int32[B]; comp: [W, B] words.
SIDDHI_API int k2b_pack_compact(const void* const* ptrs, const int* kinds,
                                int ncols, int word0, const int32_t* order,
                                int B, uint32_t* comp, cudaStream_t stream) {
  Cols cols;
  int rc = fill_cols(&cols, ptrs, nullptr, kinds, ncols);
  if (rc || B <= 0) return rc;
  pack_compact<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(cols, word0,
                                                               order, B, comp);
  return siddhi_launch_status();
}

// ring: [W, C]; comp: [W, B]; out: [W, E]; base_idx, appended0: int64[1].
SIDDHI_API int k2b_fetch(const uint32_t* ring, int C, const uint32_t* comp,
                         int B, int W, int E, const int64_t* base_idx,
                         const int64_t* appended0, uint32_t* out,
                         cudaStream_t stream) {
  if (E <= 0) return 0;
  fetch<<<siddhi_blocks(E, BLOCK), BLOCK, 0, stream>>>(
      ring, C, comp, B, W, E, base_idx, appended0, out);
  return siddhi_launch_status();
}

// ring: [W, C] updated in place; comp: [W, B] with B <= C; appended0:
// int64[1]; n_valid: int32[1].
SIDDHI_API int k2b_append(uint32_t* ring, int C, const uint32_t* comp, int B,
                          int W, const int64_t* appended0,
                          const int32_t* n_valid, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > C) return static_cast<int>(cudaErrorInvalidValue);
  append<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(ring, C, comp, B, W,
                                                         appended0, n_valid);
  return siddhi_launch_status();
}

// outs/kinds: host arrays of ncols <= MAX_COLS typed output columns
// [width], read from word row word0 on; order: int32[width]; payload:
// [W, L] words; emit_ts int64[L], valid uint8[L], types int8[L] in;
// ts_out, valid_out, types_out [width] out, written when meta is set.
SIDDHI_API int k2b_gather(void* const* outs, const int* kinds, int ncols,
                          int word0, int meta, const int32_t* order,
                          int width,
                          const uint32_t* payload, int L,
                          const int64_t* emit_ts, const uint8_t* valid,
                          const int8_t* types, int64_t* ts_out,
                          uint8_t* valid_out, int8_t* types_out,
                          cudaStream_t stream) {
  Cols cols;
  int rc = fill_cols(&cols, nullptr, outs, kinds, ncols);
  if (rc || width <= 0) return rc;
  gather<<<siddhi_blocks(width, BLOCK), BLOCK, 0, stream>>>(
      cols, word0, meta, order, width, payload, L, emit_ts, valid, types, ts_out,
      valid_out, types_out);
  return siddhi_launch_status();
}
