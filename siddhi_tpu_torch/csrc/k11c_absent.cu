// K11c, K11d, K11e — the pattern step's absent, every-group and sticky
// reductions and the every-group release.
//
// Replaces three parts of siddhi_tpu/core/pattern_runtime.py:
//   K11c  the [B, P] kill masks of absent positions: `not X for t` and
//         its sticky re-arm (:871-882, :903-917), the timed `not X for t
//         and Y` kill (:937-941) and the untimed `not X and Y` first kill
//         seq (:1088-1094); as k11c_absent_scan.
//   K11d  `jnp.sum(q, dtype=int64)` over the [B, P] match mask: the
//         sticky `every` truncation count (:1318-1331) and the mid
//         every-group leftover count (:1368-1380); as k11d_match_count.
//   K11e  `_advance`'s mid every-group completion (:1440-1446):
//         leg_done.at[o, 0].set(False) and last_seq.at[o].max(seq), with
//         drop semantics for completions without an origin; as
//         k11e_release_origin.
// All three are bit for bit with the JAX functions.
//
// absent_scan: one thread per pending entry, 256 a block, as K11a's
// pattern mode (csrc/k11_pattern.cu). The block stages the batch's
// arr_seq, ts, lane_ok and equality columns in shared-memory tiles of 512
// lanes and every live thread walks them in lane order. A lane qualifies
// when lane_ok (valid and the conjuncts over the arrival alone), arr_seq >
// last_seq, every equality arrival == captured and, where the caller has
// conjuncts left, its [B, T] mask tile. Valid lanes carry strictly
// increasing arrival seqs, so the first qualifying lane holds the smallest
// seq. Each qualifying lane sets `before` (ts < deadline) or `after`; a
// thread stops once all three outputs are decided (both flags set, or the
// first hit when there is no deadline), and the block stops loading tiles
// once every thread has stopped (__syncthreads_or). A dead entry does no
// work and reads first = BIGSEQ, before = after = 0.
//
// match_count: the same walk with K11a's `within` test and no early exit:
// every live thread counts its qualifying lanes, a warp-shuffle block sum
// adds them, and one atomicAdd a block accumulates into the 64-bit total
// (the caller zeroes it; launches over residual tiles add to it).
//
// release_origin: one thread per completion; a valid completion with an
// origin slot o in [0, P) stores 0 into leg_done[o][0] and atomicMax-es
// its seq into last_seq[o]. Completions sharing an origin write the same
// byte and reduce the seq with the atomic, so the order does not matter.
//
// Bound on the H100: bytes for all three. absent_scan and match_count read
// 25 bytes a lane plus 4-8 per equality and 17 bytes an entry plus its
// captured columns; absent_scan writes 10 bytes an entry, match_count 8
// bytes. Their work is the lanes each live entry walks: all B for an entry
// that never meets both sides of its deadline (absent_scan) and for every
// live entry (match_count), which at config 4's width (B = 32768, P =
// 131072) is far above that byte bound — a hash of the batch's equality
// keys would cut the walk, in a later PR. release_origin reads 13 bytes a
// completion and writes 9 bytes an origin.

#include "common.cuh"

namespace {

constexpr int MAX_EQ = 4;
constexpr int BLOCK = 256;
constexpr int LTILE = 512;
constexpr long long BIGSEQ = 1LL << 62;

struct EqCols {
  const void* arr[MAX_EQ];  // arrival columns [B]
  const void* ent[MAX_EQ];  // captured columns [P]
  int size[MAX_EQ];         // element size: 1 (bool), 4 or 8
  int n;
};

struct Tile {
  long long seq[LTILE];
  long long ts[LTILE];
  long long eq[MAX_EQ][LTILE];
  uint8_t ok[LTILE];
};

__device__ __forceinline__ long long load_as_i64(const void* p, int size,
                                                 long long i) {
  if (size == 8) return static_cast<const long long*>(p)[i];
  if (size == 4) return static_cast<const int*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

// Lanes [base, base + n) of the batch into the shared tile (all threads).
__device__ __forceinline__ void load_tile(Tile& s, const int64_t* arr_seq,
                                          const int64_t* ts,
                                          const uint8_t* lane_ok,
                                          const EqCols& eq, int base,
                                          int n) {
  for (int t = threadIdx.x; t < n; t += BLOCK) {
    const int b = base + t;
    s.seq[t] = arr_seq[b];
    s.ts[t] = ts[b];
    s.ok[t] = lane_ok[b];
    for (int k = 0; k < eq.n; ++k)
      s.eq[k][t] = load_as_i64(eq.arr[k], eq.size[k], b);
  }
}

// Entry p's captured equality values.
__device__ __forceinline__ void load_entry(const EqCols& eq, long long p,
                                           long long* ev) {
#pragma unroll
  for (int k = 0; k < MAX_EQ; ++k)
    ev[k] = k < eq.n ? load_as_i64(eq.ent[k], eq.size[k], p) : 0;
}

__device__ __forceinline__ bool eq_hold(const Tile& s, const EqCols& eq,
                                        const long long* ev, int t) {
  for (int k = 0; k < eq.n; ++k)
    if (s.eq[k][t] != ev[k]) return false;
  return true;
}

__global__ void absent_scan_kernel(
    const int64_t* __restrict__ arr_seq, const int64_t* __restrict__ ts,
    const uint8_t* __restrict__ lane_ok, int B, EqCols eq,
    const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ deadline, int p0, int np,
    const uint8_t* __restrict__ resid, int64_t* __restrict__ first,
    uint8_t* __restrict__ before, uint8_t* __restrict__ after) {
  __shared__ Tile s;
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  const long long p = static_cast<long long>(p0) + j;
  const bool live = j < np && pend_valid[p];
  long long ls = 0, dl = 0x7fffffffffffffffLL;
  long long ev[MAX_EQ];
  load_entry(eq, live ? p : 0, ev);
  if (live) {
    ls = last_seq[p];
    if (deadline != nullptr) dl = deadline[p];
  }
  long long fs = BIGSEQ;
  bool bf = false, af = false, done = !live;
  for (int base = 0; base < B; base += LTILE) {
    // also the barrier between reading one tile and loading the next
    if (!__syncthreads_or(!done)) break;
    const int n = min(LTILE, B - base);
    load_tile(s, arr_seq, ts, lane_ok, eq, base, n);
    __syncthreads();
    if (done) continue;
    for (int t = 0; t < n; ++t) {
      if (!s.ok[t] || s.seq[t] <= ls || !eq_hold(s, eq, ev, t)) continue;
      if (resid != nullptr &&
          !resid[static_cast<long long>(base + t) * np + j])
        continue;
      if (fs == BIGSEQ) fs = s.seq[t];
      if (s.ts[t] < dl) {
        bf = true;
      } else {
        af = true;
      }
      if (bf && (af || deadline == nullptr)) {
        done = true;
        break;
      }
    }
  }
  if (j < np) {
    first[p] = fs;
    before[p] = bf;
    after[p] = af;
  }
}

__global__ void match_count_kernel(
    const int64_t* __restrict__ arr_seq, const int64_t* __restrict__ ts,
    const uint8_t* __restrict__ lane_ok, int B, EqCols eq,
    const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ start_ts, int p0, int np, int has_within,
    long long within, const uint8_t* __restrict__ resid,
    unsigned long long* __restrict__ total) {
  __shared__ Tile s;
  __shared__ unsigned long long warp_sum[BLOCK / 32];
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  const long long p = static_cast<long long>(p0) + j;
  const bool live = j < np && pend_valid[p];
  long long ls = 0, st = 0;
  long long ev[MAX_EQ];
  load_entry(eq, live ? p : 0, ev);
  if (live) {
    ls = last_seq[p];
    st = start_ts[p];
  }
  unsigned long long cnt = 0;
  for (int base = 0; base < B; base += LTILE) {
    if (!__syncthreads_or(live)) break;
    const int n = min(LTILE, B - base);
    load_tile(s, arr_seq, ts, lane_ok, eq, base, n);
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < n; ++t) {
      if (!s.ok[t] || s.seq[t] <= ls || !eq_hold(s, eq, ev, t)) continue;
      if (has_within && s.ts[t] - st > within) continue;
      if (resid != nullptr &&
          !resid[static_cast<long long>(base + t) * np + j])
        continue;
      ++cnt;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < BLOCK / 32; ++w) sum += warp_sum[w];
    if (sum) atomicAdd(total, sum);
  }
}

__global__ void release_origin_kernel(const uint8_t* __restrict__ valid,
                                      const int32_t* __restrict__ origin,
                                      const int64_t* __restrict__ seq, int W,
                                      uint8_t* __restrict__ leg_done,
                                      long long* __restrict__ last_seq,
                                      int P) {
  const int w = blockIdx.x * BLOCK + threadIdx.x;
  if (w >= W || !valid[w]) return;
  const int o = origin[w];
  if (o < 0 || o >= P) return;  // no origin: dropped, as mode="drop"
  leg_done[2LL * o] = 0;  // row o, column 0 of bool [P, 2]
  atomicMax(last_seq + o, static_cast<long long>(seq[w]));
}

EqCols make_eq(const void* const* eq_arr, const void* const* eq_ent,
               const int* eq_size, int n_eq) {
  EqCols eq;
  eq.n = n_eq;
  for (int k = 0; k < MAX_EQ; ++k) {
    eq.arr[k] = k < n_eq ? eq_arr[k] : nullptr;
    eq.ent[k] = k < n_eq ? eq_ent[k] : nullptr;
    eq.size[k] = k < n_eq ? eq_size[k] : 0;
  }
  return eq;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Batch [B]: arr_seq, ts int64, lane_ok bool; n_eq <= 4 equalities as host
// arrays (arrival column [B], captured column [P], element size 1, 4 or
// 8). Entries [P]: pend_valid bool, last_seq int64, deadline int64 or null
// (no timer). This launch covers entries [p0, p0 + np) and, where resid is
// not null, reads its bool [B, np] mask tile. Outputs first int64, before,
// after bool [P] for that range.
SIDDHI_API int k11c_absent_scan(const int64_t* arr_seq, const int64_t* ts,
                                const uint8_t* lane_ok, int B,
                                const void* const* eq_arr,
                                const void* const* eq_ent,
                                const int* eq_size, int n_eq,
                                const uint8_t* pend_valid,
                                const int64_t* last_seq,
                                const int64_t* deadline, int p0, int np,
                                const uint8_t* resid, int64_t* first,
                                uint8_t* before, uint8_t* after,
                                cudaStream_t stream) {
  if (n_eq < 0 || n_eq > MAX_EQ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (np <= 0) return 0;
  absent_scan_kernel<<<siddhi_blocks(np, BLOCK), BLOCK, 0, stream>>>(
      arr_seq, ts, lane_ok, B, make_eq(eq_arr, eq_ent, eq_size, n_eq),
      pend_valid, last_seq, deadline, p0, np, resid, first, before, after);
  return siddhi_launch_status();
}

// As k11c_absent_scan for the batch, the equalities and the tile, with
// start_ts int64 [P] and `within` (ms, read when has_within); adds the
// qualifying pairs of entries [p0, p0 + np) to total (int64[1], zeroed by
// the caller before the first tile).
SIDDHI_API int k11d_match_count(const int64_t* arr_seq, const int64_t* ts,
                                const uint8_t* lane_ok, int B,
                                const void* const* eq_arr,
                                const void* const* eq_ent,
                                const int* eq_size, int n_eq,
                                const uint8_t* pend_valid,
                                const int64_t* last_seq,
                                const int64_t* start_ts, int p0, int np,
                                int has_within, long long within,
                                const uint8_t* resid, int64_t* total,
                                cudaStream_t stream) {
  if (n_eq < 0 || n_eq > MAX_EQ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (np <= 0) return 0;
  match_count_kernel<<<siddhi_blocks(np, BLOCK), BLOCK, 0, stream>>>(
      arr_seq, ts, lane_ok, B, make_eq(eq_arr, eq_ent, eq_size, n_eq),
      pend_valid, last_seq, start_ts, p0, np, has_within, within, resid,
      reinterpret_cast<unsigned long long*>(total));
  return siddhi_launch_status();
}

// Completions [W]: valid bool, origin int32, seq int64; the table's
// leg_done bool [P, 2] and last_seq int64 [P], updated in place.
SIDDHI_API int k11e_release_origin(const uint8_t* valid,
                                   const int32_t* origin, const int64_t* seq,
                                   int W, uint8_t* leg_done,
                                   int64_t* last_seq, int P,
                                   cudaStream_t stream) {
  if (W <= 0) return 0;
  release_origin_kernel<<<siddhi_blocks(W, BLOCK), BLOCK, 0, stream>>>(
      valid, origin, seq, W, leg_done,
      reinterpret_cast<long long*>(last_seq), P);
  return siddhi_launch_status();
}
