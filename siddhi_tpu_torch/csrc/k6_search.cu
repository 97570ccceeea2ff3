// K6 — binary search of sorted keys (searchsorted as int32).
//
// Replaces siddhi_tpu/ops/search.py `searchsorted32`: for each query v the
// position where it would insert into sorted a[N], `side` left (elements
// < v) or right (elements <= v). The JAX function is a fixed descending
// walk over the bits of N: pos starts at 0 and, for step = 2^(bits-1) down
// to 1, moves to cand = pos + step where cand <= N and a[cand - 1] < v (or
// <= v). This kernel runs that same walk with the same compares, so it
// agrees bit for bit on every input, NaN and -0.0 included (a NaN query
// compares false everywhere and lands at 0; a NaN in `a` stops no walk past
// it), and where `a` is not sorted.
//
// Callers: the time windows' expiry trigger (a deadline a candidate into
// the batch's timestamps), the batch windows' bucket triggers, the session
// window, the expression windows, the cron table, the frequent windows'
// slot keys, the table index probe, the sort-merge join probe, and K7's
// merge plain version.
//
// Bound on the H100: bytes (a read once, each query read once, each
// position written once: 131,072 int64 queries into 131,072 keys move 2.6
// MB, ~0.8 us at 3.35 TB/s). The walk itself is latency: bits dependent
// loads a query. The first LEVELS steps of every walk probe only 2^LEVELS
// - 1 positions of `a`, the same for every query, so each block stages
// them in shared memory; the rest come through L1/L2. A thread walks ITEMS
// queries at once (independent loads in flight), neighbouring threads
// neighbouring queries (their walks share most probes). One plain launch,
// no workspace, no scratch.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int LEVELS = 8;  // steps served from shared memory

template <typename T, bool RIGHT>
__global__ void __launch_bounds__(BLOCK)
    k6_search(const T* __restrict__ a, int n, const T* __restrict__ v,
              long long nq, int32_t* __restrict__ out) {
  __shared__ T top[1 << LEVELS];
  const int bits = n > 0 ? 32 - __clz(n) : 0;  // N's bit length
  const int tl = bits < LEVELS ? bits : LEVELS;
  const int sh = bits - tl;
  // during the first tl steps cand is a multiple of 2^sh: top[cand >> sh]
  // holds a[min(cand, N) - 1]
  for (int m = threadIdx.x + 1; m < (1 << tl); m += BLOCK) {
    const long long c = static_cast<long long>(m) << sh;
    top[m] = a[(c < n ? c : n) - 1];
  }
  __syncthreads();
  const long long first =
      static_cast<long long>(blockIdx.x) * BLOCK * ITEMS + threadIdx.x;
  T q[ITEMS];
  int pos[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = first + static_cast<long long>(k) * BLOCK;
    q[k] = i < nq ? v[i] : T(0);
    pos[k] = 0;
  }
  for (int t = 0; t < bits; ++t) {
    const int step = 1 << (bits - 1 - t);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int cand = pos[k] + step;
      const T probe = t < tl ? top[cand >> sh] : a[(cand < n ? cand : n) - 1];
      const bool ok = RIGHT ? probe <= q[k] : probe < q[k];
      if (cand <= n && ok) pos[k] = cand;
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = first + static_cast<long long>(k) * BLOCK;
    if (i < nq) out[i] = pos[k];
  }
}

template <typename T>
int launch(int right, const void* a, int n, const void* v, long long nq,
           int32_t* out, cudaStream_t stream) {
  const long long per = static_cast<long long>(BLOCK) * ITEMS;
  const long long blocks = (nq + per - 1) / per;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const T* ta = static_cast<const T*>(a);
  const T* tv = static_cast<const T*>(v);
  if (right)
    k6_search<T, true><<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(
        ta, n, tv, nq, out);
  else
    k6_search<T, false><<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(
        ta, n, tv, nq, out);
  return siddhi_launch_status();
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Queries a block walks.
SIDDHI_API int k6_block_queries() { return BLOCK * ITEMS; }

// dtype: 0 = int32, 1 = int64, 2 = float32, 3 = float64, 4 = uint8 (bool).
// a: sorted [n] (n may be 0: every position is 0); v: [nq] of the same
// type; out: int32[nq]. right: 0 = side left, 1 = side right.
SIDDHI_API int k6_searchsorted(int dtype, int right, const void* a, int n,
                               const void* v, long long nq, int32_t* out,
                               cudaStream_t stream) {
  if (nq <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<int>(right, a, n, v, nq, out, stream);
    case 1:
      return launch<long long>(right, a, n, v, nq, out, stream);
    case 2:
      return launch<float>(right, a, n, v, nq, out, stream);
    case 3:
      return launch<double>(right, a, n, v, nq, out, stream);
    case 4:
      return launch<uint8_t>(right, a, n, v, nq, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
