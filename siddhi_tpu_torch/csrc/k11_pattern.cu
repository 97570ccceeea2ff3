// K11 — the pattern / sequence step's device primitives.
//
// Replaces two parts of siddhi_tpu/core/pattern_runtime.py:
//   K11a  the per-position pass of PatternQueryRuntime._make_step
//         (:1189-1226 over _leg_cond :706): for each pending entry, the
//         first qualifying arrival of the batch — `argmin` over B of
//         where(q, arr_seq, BIGSEQ) — whether there is one, and for
//         sequences the strict kill; as k11_first_match.
//   K11b  _insert_entries (:1460, through _advance :1403): candidate
//         entries into the free slots of a pending table, the k-th valid
//         candidate into the k-th free slot; as k11_insert_prepare (two
//         launches) and k11_insert_scatter.
// Both are bit for bit with the JAX functions.
//
// first_match, pattern mode: one thread per pending entry, 256 a block.
// Valid lanes carry strictly increasing arrival seqs (state.seq + rank),
// so the argmin is the first qualifying lane in lane order. The block
// stages the batch's arr_seq, ts, lane_ok and the equality columns in
// shared-memory tiles of 512 lanes and every live thread walks them in
// order, stopping at its first hit; a dead entry does no work, and the
// block stops loading tiles once every thread is done (__syncthreads_or).
// A qualifying lane is lane_ok (valid and the conjuncts over the arrival
// alone), arr_seq > last_seq, every equality arrival == captured, ts -
// start_ts <= within, and, where the caller has conjuncts left, its [B, T]
// mask tile (the wrapper launches once per tile of T entries then).
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
// Bound on the H100: bytes, both. first_match reads 25 bytes a lane plus
// 4-8 per equality, 17 bytes an entry plus its captured columns, and
// writes 10 bytes an entry; its work is the lanes each live entry walks
// to its first hit (all B for an entry that finds none), which at config
// 4's width (B = 32768, P = 131072) is far above that byte bound — a
// hash of the batch's equality keys would cut the walk, in a later PR.
// The insert reads the candidates' and free slots' flags and writes each
// fitting candidate's columns once.

#include "common.cuh"

namespace {

constexpr int MAX_EQ = 4;
constexpr int BLOCK = 256;
constexpr int LTILE = 512;
constexpr int IBLOCK = 1024;
constexpr int MAX_JOBS = 32;

struct EqCols {
  const void* arr[MAX_EQ];  // arrival columns [B]
  const void* ent[MAX_EQ];  // captured columns [P]
  int size[MAX_EQ];         // element size: 1 (bool), 4 or 8
  int n;
};

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

__device__ __forceinline__ long long load_as_i64(const void* p, int size,
                                                 long long i) {
  if (size == 8) return static_cast<const long long*>(p)[i];
  if (size == 4) return static_cast<const int*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

__global__ void first_match_pattern(
    const int64_t* __restrict__ arr_seq, const int64_t* __restrict__ ts,
    const uint8_t* __restrict__ lane_ok, int B, EqCols eq,
    const uint8_t* __restrict__ pend_valid,
    const int64_t* __restrict__ last_seq,
    const int64_t* __restrict__ start_ts, int p0, int np, int has_within,
    long long within, const uint8_t* __restrict__ resid,
    int64_t* __restrict__ b_star, uint8_t* __restrict__ matched,
    uint8_t* __restrict__ killed) {
  __shared__ long long s_seq[LTILE];
  __shared__ long long s_ts[LTILE];
  __shared__ long long s_eq[MAX_EQ][LTILE];
  __shared__ uint8_t s_ok[LTILE];
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  const long long p = static_cast<long long>(p0) + j;
  const bool live = j < np && pend_valid[p];
  long long ls = 0, st = 0;
  long long ev[MAX_EQ];
#pragma unroll
  for (int k = 0; k < MAX_EQ; ++k) ev[k] = 0;
  if (live) {
    ls = last_seq[p];
    st = start_ts[p];
    for (int k = 0; k < eq.n; ++k) ev[k] = load_as_i64(eq.ent[k], eq.size[k], p);
  }
  bool done = !live;
  bool found = false;
  int hit = 0;
  for (int base = 0; base < B; base += LTILE) {
    // also the barrier between reading one tile and loading the next
    if (!__syncthreads_or(!done)) break;
    const int n = min(LTILE, B - base);
    for (int t = threadIdx.x; t < n; t += BLOCK) {
      const int b = base + t;
      s_seq[t] = arr_seq[b];
      s_ts[t] = ts[b];
      s_ok[t] = lane_ok[b];
      for (int k = 0; k < eq.n; ++k)
        s_eq[k][t] = load_as_i64(eq.arr[k], eq.size[k], b);
    }
    __syncthreads();
    if (done) continue;
    for (int t = 0; t < n; ++t) {
      if (!s_ok[t] || s_seq[t] <= ls) continue;
      bool ok = true;
      for (int k = 0; k < eq.n; ++k) ok = ok && s_eq[k][t] == ev[k];
      if (!ok) continue;
      if (has_within && s_ts[t] - st > within) continue;
      if (resid != nullptr &&
          !resid[static_cast<long long>(base + t) * np + j])
        continue;
      hit = base + t;
      found = true;
      done = true;
      break;
    }
  }
  if (j < np) {
    b_star[p] = found ? hit : 0;
    matched[p] = found;
    killed[p] = 0;
  }
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

// Batch [B]: arr_seq, ts int64; valid, lane_ok bool; sequence mode also
// order int32[B] (K1 over valid) and seq0 int64[1]; n_eq <= 4 equalities
// as host arrays (arrival column [B], captured column [P], element size
// 1, 4 or 8). Entries [P]:
// pend_valid bool, last_seq, start_ts int64; this launch covers entries
// [p0, p0 + np) and, where resid is not null, reads its bool [B, np] mask
// tile. Outputs b_star int64, matched, killed bool [P] for that range.
SIDDHI_API int k11_first_match(const int64_t* arr_seq, const int64_t* ts,
                               const uint8_t* valid, const uint8_t* lane_ok,
                               const int32_t* order, const int64_t* seq0,
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
  if (n_eq < 0 || n_eq > MAX_EQ)
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
        arr_seq, ts, lane_ok, B, eq, pend_valid, last_seq, start_ts, p0,
        np, has_within, within, resid, b_star, matched, killed);
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
