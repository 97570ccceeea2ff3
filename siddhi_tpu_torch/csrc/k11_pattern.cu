// K11 — the pattern / sequence step's device primitives.
//
// Replaces two parts of siddhi_tpu/core/pattern_runtime.py:
//   K11a  the per-position pass of PatternQueryRuntime._make_step
//         (:1189-1226 over _leg_cond :706): for each pending entry, the
//         first qualifying arrival of the batch — `argmin` over B of
//         where(q, arr_seq, BIGSEQ) — whether there is one, and for
//         sequences the strict kill; as k11_match_index (pattern mode's
//         index of the batch) and k11_first_match.
//   K11b  _insert_entries (:1460, through _advance :1403): candidate
//         entries into the free slots of a pending table, the k-th valid
//         candidate into the k-th free slot; as k11_insert_prepare (two
//         launches) and k11_insert_scatter.
// Both are bit for bit with the JAX functions.
//
// first_match, pattern mode: an exact index of the batch (k11_index.cuh),
// built once a call or, by the pattern step, once a leg and batch and
// shared with K11c and K11d (k11c_absent.cu), then one probe a pending
// entry.
//   index  the batch's lanes ordered by (lane_ok first, the equality
//          arrival columns, lane): the wrapper sorts them with K7 (one
//          stable sort a column, least significant first, on keys whose
//          order is the column's value order) and K1 (lane_ok first),
//          then k11_match_index gathers, at each sorted position, the
//          lane, lane_ok, arr_seq, ts and the columns as int64. A run of
//          equal tuples holds its
//          lanes in lane order, so their arr_seq increases along it (valid
//          lanes carry strictly increasing seqs, state.seq + rank).
//   probe  one thread an entry, 256 a block: a binary search for the first
//          position whose (tuple, arr_seq) is not below (captured tuple,
//          last_seq), i.e. the entry's run past last_seq, then a walk
//          along the run that tests `within` and the residual and stops
//          at the first lane that passes. ts is not sorted along a run, so
//          a lane that fails `within` does not end the walk. A dead entry
//          does no work. With no equality the run is every lane_ok lane.
// The first qualifying lane in lane order is the argmin over B of
// where(q, arr_seq, BIGSEQ). The residual, where the caller has conjuncts
// left, is a [B, T] mask tile (one probe launch a tile of T entries, on
// the same index).
//
// first_match, sequence mode: only the arrival with seq last_seq + 1 can
// qualify. Its lane is order[last_seq + 1 - seq0] in K1's valid-first
// order, if that lane is valid; the thread reads it directly. A valid next
// lane that fails the condition kills the entry (killed = 1).
//
// b_star is 0 wherever nothing qualifies, as jnp.argmin gives for an
// all-BIGSEQ column.
//
// insert: K1's three-launch structure. prepare: per-block counts of the
// valid candidates and of the table's free slots, then one block scans
// the candidate counts into block offsets and sums the free slots, which
// leaves n_free and n_drop = max(0, candidates - n_free) on the device.
// scatter: each valid candidate re-derives its rank with a warp-shuffle
// block scan; rank < n_free fits into slot free_order[rank] (free_order is
// K1 over ~valid, free slots first, ascending). Slots are distinct, so no
// two threads write one word. The columns to write come as jobs in the
// parameter block (destination, source or a fill value, element size),
// up to 32 a launch: captured columns, frame validity and timestamps,
// start_ts, last_seq, armed_ts, leg_done (cleared), origin and valid.
//
// Bound on the H100: bytes, both. first_match reads, for the index, 25
// bytes a lane plus 4-8 per equality (and the sorts' keys), 17 bytes an
// entry plus its captured columns, and writes 10 bytes an entry; a probe
// reads O(log B + run) positions of the index, so at config 4's width
// (B = 32768, values unique per lane) its work is close to those bytes.
// The insert reads the candidates' and free slots' flags and writes each
// fitting candidate's columns once.

#include "k11_index.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int IBLOCK = 1024;
constexpr int MAX_JOBS = 32;

struct Job {
  void* dst;        // table column [P] (leg_done: [P, 2] as 2 bytes a row)
  const void* src;  // candidate column [W], or null: write `fill`
  long long fill;
  int size;  // bytes an element: 1, 2, 4 or 8
};

struct Jobs {
  Job job[MAX_JOBS];
  int n;
};

// One thread a sorted position m: gather lane order[m]'s columns.
__global__ void match_index(const int32_t* __restrict__ order,
                            const int64_t* __restrict__ arr_seq,
                            const int64_t* __restrict__ ts,
                            const uint8_t* __restrict__ lane_ok, int B,
                            EqCols eq, Index x) {
  const long long m = static_cast<long long>(blockIdx.x) * BLOCK +
                      threadIdx.x;
  if (m >= B) return;
  const int l = order[m];
  x.lane[m] = l;
  x.ok[m] = lane_ok[l];
  x.seq[m] = arr_seq[l];
  x.ts[m] = ts[l];
  for (int k = 0; k < eq.n; ++k)
    x.key[k * static_cast<long long>(B) + m] =
        load_as_i64(eq.arr[k], eq.size[k], l);
}

// One thread an entry of [p0, p0 + np): the first lane of its run past
// last_seq that passes `within` and the residual (see the file's comment).
__global__ void first_match_pattern(
    Index x, int B, EqCols eq, const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ start_ts, int p0, int np, int has_within,
    long long within, const uint8_t* __restrict__ resid,
    int64_t* __restrict__ b_star, uint8_t* __restrict__ matched,
    uint8_t* __restrict__ killed) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= np) return;
  const long long p = static_cast<long long>(p0) + j;
  bool found = false;
  int hit = 0;
  if (pend_valid[p]) {
    const long long ls = last_seq[p];
    const long long st = start_ts[p];
    long long ev[MAX_EQ];
    load_entry(eq, p, ev);
    for (int m = first_not_below(x, B, eq.n, ev, ls, 0, B); m < B; ++m) {
      if (!in_run(x, B, eq.n, ev, m)) break;  // past the run
      if (has_within && wrap_sub(x.ts[m], st) > within) continue;
      const int l = x.lane[m];
      if (resid != nullptr && !resid[static_cast<long long>(l) * np + j])
        continue;
      hit = l;
      found = true;
      break;
    }
  }
  b_star[p] = found ? hit : 0;
  matched[p] = found;
  killed[p] = 0;
}

__global__ void first_match_sequence(
    const int64_t* __restrict__ ts, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ lane_ok, const int32_t* __restrict__ order,
    const int64_t* __restrict__ seq0, int B, EqCols eq,
    const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ start_ts, int p0, int np, int has_within,
    long long within, const uint8_t* __restrict__ resid,
    int64_t* __restrict__ b_star, uint8_t* __restrict__ matched,
    uint8_t* __restrict__ killed) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= np) return;
  const long long p = static_cast<long long>(p0) + j;
  bool found = false, kill = false;
  int hit = 0;
  if (pend_valid[p]) {
    const long long r = last_seq[p] + 1 - seq0[0];
    if (r >= 0 && r < B) {
      const int b = order[r];
      if (valid[b]) {  // the next arrival: it matches or it kills
        bool q = lane_ok[b] != 0;
        for (int k = 0; k < eq.n; ++k)
          q = q && load_as_i64(eq.arr[k], eq.size[k], b) ==
                       load_as_i64(eq.ent[k], eq.size[k], p);
        if (has_within) q = q && ts[b] - start_ts[p] <= within;
        if (resid != nullptr)
          q = q && resid[static_cast<long long>(b) * np + j] != 0;
        found = q;
        kill = !q;
        hit = q ? b : 0;
      }
    }
  }
  b_star[p] = hit;
  matched[p] = found;
  killed[p] = kill;
}

// Per block: the valid candidates among lanes [0, W) and the free table
// slots among [0, P) (the grid covers max(W, P)).
__global__ void insert_count(const uint8_t* __restrict__ cand_valid, int W,
                             const uint8_t* __restrict__ table_valid, int P,
                             int* __restrict__ cand_cnt,
                             int* __restrict__ free_cnt) {
  __shared__ int smem[IBLOCK / 32];
  const int i = blockIdx.x * IBLOCK + threadIdx.x;
  int total;
  block_exclusive_sum<IBLOCK>((i < W && cand_valid[i]) ? 1 : 0, smem, &total);
  if (threadIdx.x == 0) cand_cnt[blockIdx.x] = total;
  block_exclusive_sum<IBLOCK>((i < P && !table_valid[i]) ? 1 : 0, smem,
                              &total);
  if (threadIdx.x == 0) free_cnt[blockIdx.x] = total;
}

// One block: cand_cnt[b] becomes the valid candidates before block b;
// totals[0] the candidates, totals[1] = n_free; n_drop receives
// max(0, candidates - n_free).
__global__ void insert_scan(int* __restrict__ cand_cnt,
                            const int* __restrict__ free_cnt, int nblocks,
                            int* __restrict__ totals,
                            int64_t* __restrict__ n_drop) {
  __shared__ int smem[IBLOCK / 32];
  int carry = 0, n_free = 0;
  for (int base = 0; base < nblocks; base += IBLOCK) {
    const int j = base + threadIdx.x;
    const int v = j < nblocks ? cand_cnt[j] : 0;
    int total;
    const int ex = block_exclusive_sum<IBLOCK>(v, smem, &total);
    if (j < nblocks) cand_cnt[j] = carry + ex;
    carry += total;
    block_exclusive_sum<IBLOCK>(j < nblocks ? free_cnt[j] : 0, smem, &total);
    n_free += total;
  }
  if (threadIdx.x == 0) {
    totals[0] = carry;
    totals[1] = n_free;
    n_drop[0] = carry > n_free ? carry - n_free : 0;
  }
}

__device__ __forceinline__ void copy_elem(const Job& jb, long long dst_i,
                                          long long src_i) {
  switch (jb.size) {
    case 8:
      static_cast<long long*>(jb.dst)[dst_i] =
          jb.src ? static_cast<const long long*>(jb.src)[src_i] : jb.fill;
      break;
    case 4:
      static_cast<int*>(jb.dst)[dst_i] =
          jb.src ? static_cast<const int*>(jb.src)[src_i]
                 : static_cast<int>(jb.fill);
      break;
    case 2:
      static_cast<uint16_t*>(jb.dst)[dst_i] =
          jb.src ? static_cast<const uint16_t*>(jb.src)[src_i]
                 : static_cast<uint16_t>(jb.fill);
      break;
    default:
      static_cast<uint8_t*>(jb.dst)[dst_i] =
          jb.src ? static_cast<const uint8_t*>(jb.src)[src_i]
                 : static_cast<uint8_t>(jb.fill);
  }
}

__global__ void insert_scatter(const uint8_t* __restrict__ cand_valid, int W,
                               const int32_t* __restrict__ free_order,
                               const int* __restrict__ block_off,
                               const int* __restrict__ totals, Jobs jobs) {
  __shared__ int smem[IBLOCK / 32];
  const int i = blockIdx.x * IBLOCK + threadIdx.x;
  const int v = (i < W && cand_valid[i]) ? 1 : 0;
  int total;
  const int ex = block_exclusive_sum<IBLOCK>(v, smem, &total);
  if (!v) return;
  const int rank = block_off[blockIdx.x] + ex;
  if (rank >= totals[1]) return;  // past the free slots: dropped
  const long long slot = free_order[rank];
  for (int k = 0; k < jobs.n; ++k) copy_elem(jobs.job[k], slot, i);
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Bytes of the pattern-mode index for a batch of B lanes and n_eq
// equality columns.
SIDDHI_API long long k11_index_bytes(int B, int n_eq) {
  return index_bytes(B, n_eq);
}

// The pattern-mode index (see the file's comment): order int32[B], the
// batch's lanes by (lane_ok first, the equality columns, lane); arr_seq,
// ts int64 and lane_ok bool [B]; n_eq <= 4 arrival columns as host arrays
// (device pointer, element size 1, 4 or 8). index: k11_index_bytes(B,
// n_eq) bytes, fully written.
SIDDHI_API int k11_match_index(const int32_t* order, const int64_t* arr_seq,
                               const int64_t* ts, const uint8_t* lane_ok,
                               int B, const void* const* eq_arr,
                               const int* eq_size, int n_eq, void* index,
                               cudaStream_t stream) {
  if (n_eq < 0 || n_eq > MAX_EQ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  EqCols eq;
  eq.n = n_eq;
  for (int k = 0; k < MAX_EQ; ++k) {
    eq.arr[k] = k < n_eq ? eq_arr[k] : nullptr;
    eq.ent[k] = nullptr;
    eq.size[k] = k < n_eq ? eq_size[k] : 0;
  }
  match_index<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(
      order, arr_seq, ts, lane_ok, B, eq, index_at(index, B, n_eq));
  return siddhi_launch_status();
}

// Batch [B]: ts int64; valid, lane_ok bool; pattern mode reads the index
// k11_match_index built for this batch and these columns; sequence mode
// reads order int32[B] (K1 over valid), seq0 int64[1] and the columns.
// n_eq <= 4 equalities as host arrays (arrival column [B], captured
// column [P], element size 1, 4 or 8). Entries [P]:
// pend_valid bool, last_seq, start_ts int64; this launch covers entries
// [p0, p0 + np) and, where resid is not null, reads its bool [B, np] mask
// tile. Outputs b_star int64, matched, killed bool [P] for that range.
SIDDHI_API int k11_first_match(const int64_t* ts, const uint8_t* valid,
                               const uint8_t* lane_ok, const int32_t* order,
                               const int64_t* seq0, const void* index,
                               int B, const void* const* eq_arr,
                               const void* const* eq_ent,
                               const int* eq_size, int n_eq,
                               const uint8_t* pend_valid,
                               const int64_t* last_seq,
                               const int64_t* start_ts, int p0, int np,
                               int sequence, int has_within,
                               long long within, const uint8_t* resid,
                               int64_t* b_star, uint8_t* matched,
                               uint8_t* killed, cudaStream_t stream) {
  if (n_eq < 0 || n_eq > MAX_EQ || (!sequence && index == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (np <= 0) return 0;
  EqCols eq;
  eq.n = n_eq;
  for (int k = 0; k < MAX_EQ; ++k) {
    eq.arr[k] = k < n_eq ? eq_arr[k] : nullptr;
    eq.ent[k] = k < n_eq ? eq_ent[k] : nullptr;
    eq.size[k] = k < n_eq ? eq_size[k] : 0;
  }
  const unsigned grid = siddhi_blocks(np, BLOCK);
  if (sequence) {
    first_match_sequence<<<grid, BLOCK, 0, stream>>>(
        ts, valid, lane_ok, order, seq0, B, eq, pend_valid, last_seq,
        start_ts, p0, np, has_within, within, resid, b_star, matched,
        killed);
  } else {
    first_match_pattern<<<grid, BLOCK, 0, stream>>>(
        index_at(const_cast<void*>(index), B, n_eq), B, eq, pend_valid,
        last_seq, start_ts, p0, np, has_within, within, resid, b_star,
        matched, killed);
  }
  return siddhi_launch_status();
}

// cand_valid bool[W], table_valid bool[P]; scratch int32[2 * nb + 2] with
// nb = ceil(max(W, P) / 1024): candidate block offsets, free-slot block
// counts, then (candidates, n_free); n_drop int64[1].
SIDDHI_API int k11_insert_prepare(const uint8_t* cand_valid,
                                  const uint8_t* table_valid, int W, int P,
                                  int* scratch, int64_t* n_drop,
                                  cudaStream_t stream) {
  if (W <= 0) return 0;
  const int nb = static_cast<int>(siddhi_blocks(W > P ? W : P, IBLOCK));
  insert_count<<<nb, IBLOCK, 0, stream>>>(cand_valid, W, table_valid, P,
                                          scratch, scratch + nb);
  const int rc = siddhi_launch_status();
  if (rc) return rc;
  insert_scan<<<1, IBLOCK, 0, stream>>>(scratch, scratch + nb, nb,
                                        scratch + 2 * nb, n_drop);
  return siddhi_launch_status();
}

// After k11_insert_prepare on the same scratch: writes the jobs' columns
// of every fitting candidate into slot free_order[rank]. Jobs, n_jobs <=
// 32 host arrays: dst[k] the table column, src[k] the candidate column or
// null (write fill[k]), size[k] the bytes an element (1, 2, 4 or 8).
SIDDHI_API int k11_insert_scatter(const uint8_t* cand_valid,
                                  const int32_t* free_order, int W, int P,
                                  const int* scratch, void* const* dst,
                                  const void* const* src,
                                  const long long* fill, const int* size,
                                  int n_jobs, cudaStream_t stream) {
  if (n_jobs < 0 || n_jobs > MAX_JOBS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0 || n_jobs == 0) return 0;
  Jobs jobs;
  jobs.n = n_jobs;
  for (int k = 0; k < n_jobs; ++k) {
    jobs.job[k].dst = dst[k];
    jobs.job[k].src = src[k];
    jobs.job[k].fill = fill[k];
    jobs.job[k].size = size[k];
  }
  const int nb = static_cast<int>(siddhi_blocks(W > P ? W : P, IBLOCK));
  insert_scatter<<<siddhi_blocks(W, IBLOCK), IBLOCK, 0, stream>>>(
      cand_valid, W, free_order, scratch, scratch + 2 * nb, jobs);
  return siddhi_launch_status();
}
