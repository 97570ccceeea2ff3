// K13f — bucket scatter: one launch writes every column of one duration
// store of an incremental aggregation.
//
// Replaces the scatters of siddhi_tpu/core/aggregation.py:
//   _make_ingest (:650-665): bucket_ts, each group column and alive are
//     scatter-set at widx; each component is scatter-added, -minned or
//     -maxed there (many lanes hit one slot);
//   _make_evict (:682-699) and _restore_fn (:473-488): every column is
//     scatter-set into a fresh store or into the restored slots.
// XLA compiles each of those into one scatter per array; here a thread a
// lane reads its slot widx[i] once and writes every column.
//
// widx: int32[n]; a lane whose slot is outside [0, K) (the drop slot K,
// or a lane K4 could not place) writes nothing. The column table rides in
// the kernel's parameter block (MAX_COLS entries of destination, source,
// element kind and op), so one source serves any store layout.
//
// Ops:
//   SET: a plain store. Every lane of one slot writes the same bucket and
//     group values, because the slot is keyed by their 64-bit hash; the
//     only exception is a hash collision between two (bucket, group)
//     keys, where the JAX scatter is unordered too.
//   SET_TRUE: stores 1 (alive); no source.
//   ADD: atomicAdd on float32, float64, int32, and int64 as unsigned long
//     long (two's complement: int64 sums wrap as XLA's do). Float sums
//     land in an order that changes from run to run (XLA on the CPU adds
//     in lane order); int sums are exact.
//   MIN / MAX: integers by atomicMin / atomicMax; floats by a
//     compare-and-swap loop on the bits, ordered as XLA's scatter min/max
//     orders them on the CPU: NaN wins (stored as the canonical quiet NaN),
//     -0.0 < +0.0, so the result does not depend on the lanes' order.
//
// Bound on the H100: bytes. Each lane's widx is read once, each distinct
// source once for a kept lane, each touched slot's add/min/max columns
// read and written once and its set columns written once; there is no
// arithmetic to speak of. At low contention (app AE's `sec` store: B =
// 131,072 lanes into ~125,000 slots of 2^20) the writes are scattered
// 4- and 8-byte words, so the kernel runs at sector, not byte, granularity;
// at high contention (~13 lanes a slot) atomics on one address serialise.
// A simple kernel first: no warp aggregation or sorted runs.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_COLS = 48;

enum Kind { F32 = 0, F64 = 1, I32 = 2, I64 = 3, U8 = 4 };
enum Op { SET = 0, SET_TRUE = 1, ADD = 2, MIN = 3, MAX = 4 };

struct Cols {
  void* dst[MAX_COLS];        // the store's columns [K]
  const void* src[MAX_COLS];  // the lanes' values [n] (null for SET_TRUE)
  int kind[MAX_COLS];
  int op[MAX_COLS];
  int n;
};

// Order keys: a total order of the float's bits with -0.0 < +0.0.
__device__ __forceinline__ int f32_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ long long f64_key(double v) {
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

// true where `v` should replace `old` under min (is_min) or max.
__device__ __forceinline__ bool f32_wins(float v, float old, bool is_min) {
  if (old != old) return false;  // a NaN stays
  if (v != v) return true;
  const int kv = f32_key(v), ko = f32_key(old);
  return is_min ? kv < ko : kv > ko;
}
__device__ __forceinline__ bool f64_wins(double v, double old, bool is_min) {
  if (old != old) return false;
  if (v != v) return true;
  const long long kv = f64_key(v), ko = f64_key(old);
  return is_min ? kv < ko : kv > ko;
}

__device__ __forceinline__ void f32_extreme(float* p, float v, bool is_min) {
  if (v != v) v = __int_as_float(0x7fc00000);
  int* pi = reinterpret_cast<int*>(p);
  int old = *pi;
  while (f32_wins(v, __int_as_float(old), is_min)) {
    const int prev = atomicCAS(pi, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}

__device__ __forceinline__ void f64_extreme(double* p, double v,
                                            bool is_min) {
  if (v != v) v = __longlong_as_double(0x7ff8000000000000LL);
  unsigned long long* pi = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *pi;
  while (f64_wins(v, __longlong_as_double(static_cast<long long>(old)),
                  is_min)) {
    const unsigned long long prev = atomicCAS(
        pi, old, static_cast<unsigned long long>(__double_as_longlong(v)));
    if (prev == old) break;
    old = prev;
  }
}

__device__ __forceinline__ void write_col(const Cols& c, int j, long long i,
                                          int w) {
  void* d = c.dst[j];
  const void* s = c.src[j];
  const int op = c.op[j];
  switch (c.kind[j]) {
    case F32: {
      float* p = static_cast<float*>(d) + w;
      const float v = static_cast<const float*>(s)[i];
      if (op == SET) *p = v;
      else if (op == ADD) atomicAdd(p, v);
      else f32_extreme(p, v, op == MIN);
      break;
    }
    case F64: {
      double* p = static_cast<double*>(d) + w;
      const double v = static_cast<const double*>(s)[i];
      if (op == SET) *p = v;
      else if (op == ADD) atomicAdd(p, v);
      else f64_extreme(p, v, op == MIN);
      break;
    }
    case I32: {
      int* p = static_cast<int*>(d) + w;
      const int v = static_cast<const int*>(s)[i];
      if (op == SET) *p = v;
      else if (op == ADD) atomicAdd(p, v);
      else if (op == MIN) atomicMin(p, v);
      else atomicMax(p, v);
      break;
    }
    case I64: {
      long long* p = static_cast<long long*>(d) + w;
      const long long v = static_cast<const long long*>(s)[i];
      if (op == SET) *p = v;
      else if (op == ADD)
        atomicAdd(reinterpret_cast<unsigned long long*>(p),
                  static_cast<unsigned long long>(v));
      else if (op == MIN) atomicMin(p, v);
      else atomicMax(p, v);
      break;
    }
    default: {  // U8: bool columns, set only
      unsigned char* p = static_cast<unsigned char*>(d) + w;
      *p = op == SET_TRUE ? 1 : static_cast<const unsigned char*>(s)[i];
      break;
    }
  }
}

__global__ void k13f_scatter(const int* __restrict__ widx, long long n,
                             int K, Cols cols) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int w = widx[i];
  if (w < 0 || w >= K) return;
  for (int j = 0; j < cols.n; ++j) write_col(cols, j, i, w);
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// k13f_bucket_scatter: for every lane i with 0 <= widx[i] < K, column c's
// destination slot widx[i] takes source value i under op[c]. dst/src/kind/
// op: n_cols host entries (device pointers; src null for SET_TRUE). U8
// columns take SET or SET_TRUE only.
SIDDHI_API int k13f_bucket_scatter(const int* widx, long long n, int K,
                                   void* const* dst, const void* const* src,
                                   const int* kind, const int* op,
                                   int n_cols, cudaStream_t stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || n < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (kind[c] < F32 || kind[c] > U8 || op[c] < SET || op[c] > MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    if (kind[c] == U8 && op[c] != SET && op[c] != SET_TRUE)
      return static_cast<int>(cudaErrorInvalidValue);
    if (kind[c] != U8 && op[c] == SET_TRUE)
      return static_cast<int>(cudaErrorInvalidValue);
    if (op[c] != SET_TRUE && src[c] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.dst[c] = dst[c];
    cols.src[c] = src[c];
    cols.kind[c] = kind[c];
    cols.op[c] = op[c];
  }
  if (n == 0 || n_cols == 0) return 0;
  k13f_scatter<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(widx, n, K,
                                                               cols);
  return siddhi_launch_status();
}
