// The pattern step's index of a batch: built by k11_match_index
// (k11_pattern.cu) and probed by K11a's pattern mode (k11_pattern.cu), K11c
// and K11d (k11c_absent.cu). Each source is its own library, so each
// carries its own copy of these definitions.
//
// The index orders the batch's lanes by (lane_ok first, the equality
// arrival columns, lane) and holds, at each sorted position, the lane, its
// lane_ok, arr_seq, ts and the columns as int64. A run of equal tuples
// holds its lanes in lane order, so arr_seq increases along it (valid lanes
// carry strictly increasing seqs; lane_ok lanes are valid). An entry's
// candidates are one contiguous run: the positions from the first one not
// below (captured tuple, last_seq) to the end of its tuple's run.
#pragma once

#include "common.cuh"

namespace {

constexpr int MAX_EQ = 4;

struct EqCols {
  const void* arr[MAX_EQ];  // arrival columns [B]
  const void* ent[MAX_EQ];  // captured columns [P]
  int size[MAX_EQ];         // element size: 1 (bool), 4 or 8
  int n;
};

// Struct of arrays in one buffer of index_bytes(B, n).
struct Index {
  int64_t* seq;   // [B] arr_seq at each sorted position
  int64_t* ts;    // [B]
  int64_t* key;   // [n][B] equality arrival columns as int64
  int32_t* lane;  // [B] the lane at each sorted position
  uint8_t* ok;    // [B] lane_ok
};

__host__ __device__ inline long long index_bytes(long long B, int n) {
  return B * (16 + 8LL * n) + 4 * B + B;
}

__host__ __device__ inline Index index_at(const void* buf, int B, int n) {
  Index x;
  int64_t* w = static_cast<int64_t*>(const_cast<void*>(buf));
  x.seq = w;
  x.ts = w + B;
  x.key = w + 2LL * B;
  x.lane = reinterpret_cast<int32_t*>(w + (2LL + n) * B);
  x.ok = reinterpret_cast<uint8_t*>(x.lane + B);
  return x;
}

__device__ __forceinline__ long long load_as_i64(const void* p, int size,
                                                 long long i) {
  if (size == 8) return static_cast<const long long*>(p)[i];
  if (size == 4) return static_cast<const int*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

// ts - start_ts as the JAX step computes it: int64, wrapping
__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

// Entry p's captured tuple (zeros past eq.n).
__device__ __forceinline__ void load_entry(const EqCols& eq, long long p,
                                           long long* ev) {
#pragma unroll
  for (int k = 0; k < MAX_EQ; ++k)
    ev[k] = k < eq.n ? load_as_i64(eq.ent[k], eq.size[k], p) : 0;
}

// The first position of [lo, hi) whose (tuple, arr_seq) is not below
// (ev, ls); positions that are not lane_ok lie above every tuple. With ls
// = INT64_MAX it is the end of ev's run.
__device__ __forceinline__ int first_not_below(const Index& x, int B, int n,
                                               const long long* ev,
                                               long long ls, int lo,
                                               int hi) {
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    bool below = x.ok[m] != 0;
    if (below) {
      int k = 0;
      for (; k < n; ++k) {
        const long long kv = x.key[k * static_cast<long long>(B) + m];
        if (kv != ev[k]) {
          below = kv < ev[k];
          break;
        }
      }
      if (k == n) below = x.seq[m] <= ls;
    }
    if (below)
      lo = m + 1;
    else
      hi = m;
  }
  return lo;
}

// Position m (< B) holds a lane_ok lane of tuple ev.
__device__ __forceinline__ bool in_run(const Index& x, int B, int n,
                                       const long long* ev, int m) {
  if (!x.ok[m]) return false;
  for (int k = 0; k < n; ++k)
    if (x.key[k * static_cast<long long>(B) + m] != ev[k]) return false;
  return true;
}

}  // namespace
