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
// absent_scan and match_count probe K11a's index of the batch
// (k11_index.cuh: the lanes by lane_ok, the equality columns and lane,
// built by k11_match_index), one thread an entry, 256 a block. A lane
// qualifies for a live entry when lane_ok, every equality arrival ==
// captured, arr_seq > last_seq and, where the caller has conjuncts left,
// its [B, T] mask tile (read by lane, not by sorted position); match_count
// adds K11a's `within` (the wrapping ts - start_ts). Those lanes are one
// run of the index, in lane order and so in seq order: a binary search
// finds its first position past last_seq, and the thread walks on from
// there. ts is not sorted along a run, so a lane that fails `within` or
// lies past the deadline does not end the walk.
//   absent_scan  `first` is the first qualifying position's seq; each
//                qualifying position sets `before` (ts < deadline) or
//                `after`, and every one counts as before with no deadline.
//                The walk stops once every output is decided (both flags,
//                or the first hit with no deadline). A dead entry does no
//                work and writes first = BIGSEQ, before = after = 0.
//   match_count  counts the run's qualifying positions; with no `within`
//                and no residual the count is the run's length past
//                last_seq, from a second binary search for the run's end.
//                A warp-shuffle block sum and one atomicAdd a block add
//                into the 64-bit total (the caller zeroes it; launches
//                over residual tiles add to it): an integer, so any order
//                gives the same bits.
// Long runs (a leg without equality, or few values): a thread walks WALK
// positions alone; an entry whose run goes on is then walked by its whole
// warp, 32 consecutive positions a round, up to the run's end found by a
// binary search, so the reads coalesce and only ts (and the lane, for a
// residual) are read. At the apps' widths runs are about a third of a lane
// and no warp takes over.
//
// release_origin: one thread per completion; a valid completion with an
// origin slot o in [0, P) stores 0 into leg_done[o][0] and atomicMax-es
// its seq into last_seq[o]. Completions sharing an origin write the same
// byte and reduce the seq with the atomic, so the order does not matter.
//
// Bound on the H100: bytes for all three. The functions read 25 bytes a
// lane plus 4-8 per equality and 17 bytes an entry plus its captured
// columns; absent_scan writes 10 bytes an entry, match_count 8 bytes.
// The design moves more: the index (29 + 8 n bytes a lane written once by
// the gather and read once), K7's passes and K1, and O(log B + run)
// positions an entry, which at config 4's width (B = 32768, P = 131072,
// values uniform over 1..100,000) stay near those bytes. release_origin
// reads 13 bytes a completion and writes 9 bytes an origin.

#include "k11_index.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int WALK = 32;  // positions a thread walks before its warp helps
constexpr long long BIGSEQ = 1LL << 62;
constexpr long long MAX_SEQ = 0x7fffffffffffffffLL;
constexpr unsigned FULL = 0xffffffffu;

// Every thread of the grid reaches the warp phase's ballots: no thread
// returns early.
__global__ void absent_probe(
    Index x, int B, EqCols eq, const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ deadline, int p0, int np,
    const uint8_t* __restrict__ resid, int64_t* __restrict__ first,
    uint8_t* __restrict__ before, uint8_t* __restrict__ after) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  const long long p = static_cast<long long>(p0) + j;
  const bool timed = deadline != nullptr;
  long long dl = 0, fs = BIGSEQ;
  bool bf = false, af = false;
  int m = B, end = B;  // the warp walks [m, end) of this entry's run
  if (j < np && pend_valid[p]) {
    long long ev[MAX_EQ];
    load_entry(eq, p, ev);
    if (timed) dl = deadline[p];
    m = first_not_below(x, B, eq.n, ev, last_seq[p], 0, B);
    for (const int stop = min(B, m + WALK); m < stop; ++m) {
      if (!in_run(x, B, eq.n, ev, m)) {
        m = B;
        break;
      }
      if (resid != nullptr &&
          !resid[static_cast<long long>(x.lane[m]) * np + j])
        continue;
      if (fs == BIGSEQ) fs = x.seq[m];
      if (!timed || x.ts[m] < dl) {
        bf = true;
      } else {
        af = true;
      }
      if (bf && (af || !timed)) {
        m = B;
        break;
      }
    }
    if (m < B) end = first_not_below(x, B, eq.n, ev, MAX_SEQ, m, B);
  }
  const int lane = threadIdx.x & 31;
  for (unsigned todo = __ballot_sync(FULL, m < end); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int wend = __shfl_sync(FULL, end, src);
    const int wj = __shfl_sync(FULL, j, src);
    const long long wdl = __shfl_sync(FULL, dl, src);
    long long wfs = __shfl_sync(FULL, fs, src);
    bool wbf = __shfl_sync(FULL, static_cast<int>(bf), src) != 0;
    bool waf = __shfl_sync(FULL, static_cast<int>(af), src) != 0;
    for (int wm = __shfl_sync(FULL, m, src); wm < wend; wm += 32) {
      const int mm = wm + lane;
      bool q = mm < wend;
      if (q && resid != nullptr)
        q = resid[static_cast<long long>(x.lane[mm]) * np + wj] != 0;
      const unsigned hit = __ballot_sync(FULL, q);
      const unsigned early =
          __ballot_sync(FULL, q && (!timed || x.ts[mm] < wdl));
      if (hit && wfs == BIGSEQ) wfs = x.seq[wm + __ffs(hit) - 1];
      wbf = wbf || early != 0;
      waf = waf || (hit & ~early) != 0;
      if (wbf && (waf || !timed)) break;
    }
    if (lane == src) {
      fs = wfs;
      bf = wbf;
      af = waf;
    }
  }
  if (j < np) {
    first[p] = fs;
    before[p] = bf;
    after[p] = af;
  }
}

__global__ void count_probe(
    Index x, int B, EqCols eq, const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ start_ts, int p0, int np, int has_within,
    long long within, const uint8_t* __restrict__ resid,
    unsigned long long* __restrict__ total) {
  __shared__ unsigned long long warp_sum[BLOCK / 32];
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  const long long p = static_cast<long long>(p0) + j;
  long long st = 0;
  unsigned long long cnt = 0;
  int m = B, end = B;  // the warp walks [m, end) of this entry's run
  if (j < np && pend_valid[p]) {
    long long ev[MAX_EQ];
    load_entry(eq, p, ev);
    st = start_ts[p];
    m = first_not_below(x, B, eq.n, ev, last_seq[p], 0, B);
    if (!has_within && resid == nullptr) {
      // every position of the run past last_seq qualifies
      cnt = first_not_below(x, B, eq.n, ev, MAX_SEQ, m, B) - m;
      m = B;
    } else {
      for (const int stop = min(B, m + WALK); m < stop; ++m) {
        if (!in_run(x, B, eq.n, ev, m)) {
          m = B;
          break;
        }
        if (has_within && wrap_sub(x.ts[m], st) > within) continue;
        if (resid != nullptr &&
            !resid[static_cast<long long>(x.lane[m]) * np + j])
          continue;
        ++cnt;
      }
      if (m < B) end = first_not_below(x, B, eq.n, ev, MAX_SEQ, m, B);
    }
  }
  const int lane = threadIdx.x & 31;
  for (unsigned todo = __ballot_sync(FULL, m < end); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int wend = __shfl_sync(FULL, end, src);
    const int wj = __shfl_sync(FULL, j, src);
    const long long wst = __shfl_sync(FULL, st, src);
    for (int mm = __shfl_sync(FULL, m, src) + lane; mm < wend; mm += 32) {
      bool q = !has_within || wrap_sub(x.ts[mm], wst) <= within;
      if (q && resid != nullptr)
        q = resid[static_cast<long long>(x.lane[mm]) * np + wj] != 0;
      cnt += q;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(FULL, cnt, o);
  if (lane == 0) warp_sum[threadIdx.x >> 5] = cnt;
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

EqCols captured_eq(const void* const* eq_ent, const int* eq_size,
                   int n_eq) {
  EqCols eq;
  eq.n = n_eq;
  for (int k = 0; k < MAX_EQ; ++k) {
    eq.arr[k] = nullptr;
    eq.ent[k] = k < n_eq ? eq_ent[k] : nullptr;
    eq.size[k] = k < n_eq ? eq_size[k] : 0;
  }
  return eq;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// index: k11_match_index's index of the batch [B] for these n_eq <= 4
// equalities (the arrival side); their captured columns [P] as host
// arrays (device pointer, element size 1, 4 or 8). Entries [P]:
// pend_valid bool, last_seq int64, deadline int64 or null (no timer).
// This launch covers entries [p0, p0 + np) and, where resid is not null,
// reads its bool [B, np] mask tile. Outputs first int64, before, after
// bool [P] for that range.
SIDDHI_API int k11c_absent_scan(const void* index, int B,
                                const void* const* eq_ent,
                                const int* eq_size, int n_eq,
                                const uint8_t* pend_valid,
                                const int64_t* last_seq,
                                const int64_t* deadline, int p0, int np,
                                const uint8_t* resid, int64_t* first,
                                uint8_t* before, uint8_t* after,
                                cudaStream_t stream) {
  if (n_eq < 0 || n_eq > MAX_EQ || (B > 0 && index == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (np <= 0) return 0;
  absent_probe<<<siddhi_blocks(np, BLOCK), BLOCK, 0, stream>>>(
      index_at(index, B, n_eq), B, captured_eq(eq_ent, eq_size, n_eq),
      pend_valid, last_seq, deadline, p0, np, resid, first, before, after);
  return siddhi_launch_status();
}

// As k11c_absent_scan for the index, the equalities and the tile, with
// start_ts int64 [P] and `within` (ms, read when has_within); adds the
// qualifying pairs of entries [p0, p0 + np) to total (int64[1], zeroed by
// the caller before the first tile).
SIDDHI_API int k11d_match_count(const void* index, int B,
                                const void* const* eq_ent,
                                const int* eq_size, int n_eq,
                                const uint8_t* pend_valid,
                                const int64_t* last_seq,
                                const int64_t* start_ts, int p0, int np,
                                int has_within, long long within,
                                const uint8_t* resid, int64_t* total,
                                cudaStream_t stream) {
  if (n_eq < 0 || n_eq > MAX_EQ || (B > 0 && index == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (np <= 0) return 0;
  count_probe<<<siddhi_blocks(np, BLOCK), BLOCK, 0, stream>>>(
      index_at(index, B, n_eq), B, captured_eq(eq_ent, eq_size, n_eq),
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
