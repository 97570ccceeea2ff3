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
//         candidate into the k-th free slot; as k11_pending_insert (one
//         cooperative launch).
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
// insert: one cooperative launch (at most the co-resident blocks, one a
// 1,024 slots or candidates; one block is a plain launch, which the card
// starts sooner; block g takes a contiguous share of the candidates and
// one of the table's slots):
//   1. each block counts its valid candidates and its free slots;
//   grid barrier;
//   2. each block sums the counts of the blocks before it and of all, so
//      it knows the rank of its first candidate and of its first free
//      slot, the candidates and n_free; block 0 writes n_drop = max(0,
//      candidates - n_free) on the device;
//   3. each free slot of free rank f below the candidate count writes its
//      slot number to map[f], a rank->slot map in the library's workspace
//      (a block whose first free rank is past the candidates stops);
//   grid barrier;
//   4. each valid candidate of rank r below n_free reads slot = map[r],
//      zeroes map[r] (each entry written in 3 is read by exactly one
//      candidate, so the map is zero again when the launch ends) and
//      writes every column job there, all the jobs' loads issued before
//      the first store. Slots are distinct, so no two threads write one
//      word. The table's valid flags are read in 1 and 3 only, before any
//      column (valid included) is written in 4.
// The columns come as jobs in the parameter block (destination, source or
// a fill value, element size), up to 32: captured columns, frame validity
// and timestamps, start_ts, last_seq, armed_ts, leg_done (cleared), origin
// and valid. A table of more than 32 jobs also has each candidate's slot
// (-1 where it does not fit) written to dest[W], and the rest of its jobs
// run as plain launches of 32 jobs that read dest: ceil(jobs / 32)
// launches a call in all. The block that finishes last zeroes the block
// counts and the barrier counters.

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
constexpr int MAX_JOBS = 32;
// the insert: slots a block counts, at least; workspace words (the
// barrier, the done counter, then two counts a block and the map)
constexpr int INSERT_SLOTS = 1024;
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_HEAD = 4;

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

// Candidate i's value of a job, as bits (its fill where it has no source).
__device__ __forceinline__ unsigned long long load_elem(const Job& jb,
                                                        long long i) {
  if (jb.src == nullptr) return static_cast<unsigned long long>(jb.fill);
  switch (jb.size) {
    case 8:
      return static_cast<const unsigned long long*>(jb.src)[i];
    case 4:
      return static_cast<const uint32_t*>(jb.src)[i];
    case 2:
      return static_cast<const uint16_t*>(jb.src)[i];
    default:
      return static_cast<const uint8_t*>(jb.src)[i];
  }
}

__device__ __forceinline__ void store_elem(const Job& jb, long long slot,
                                           unsigned long long v) {
  switch (jb.size) {
    case 8:
      static_cast<unsigned long long*>(jb.dst)[slot] = v;
      break;
    case 4:
      static_cast<uint32_t*>(jb.dst)[slot] = static_cast<uint32_t>(v);
      break;
    case 2:
      static_cast<uint16_t*>(jb.dst)[slot] = static_cast<uint16_t>(v);
      break;
    default:
      static_cast<uint8_t*>(jb.dst)[slot] = static_cast<uint8_t>(v);
  }
}

// Every job of candidate i into `slot`: all the loads issued before the
// first store, so a candidate waits for one memory round trip, not one a
// job (the compiler may not move a load past a store that could alias
// it).
__device__ __forceinline__ void copy_jobs(const Jobs& jobs, int slot,
                                          int i) {
  unsigned long long v[MAX_JOBS];
#pragma unroll
  for (int k = 0; k < MAX_JOBS; ++k)
    if (k < jobs.n) v[k] = load_elem(jobs.job[k], i);
#pragma unroll
  for (int k = 0; k < MAX_JOBS; ++k)
    if (k < jobs.n) store_elem(jobs.job[k], slot, v[k]);
}

// Block g: candidates [c0, c1) and slots [s0, s1) (shares cw and cp).
// table_valid is also the destination of the valid job: it is read only
// before the second barrier, and written only after it.
__global__ void __launch_bounds__(BLOCK)
    k11_insert(const uint8_t* __restrict__ cand_valid, int W,
               const uint8_t* table_valid, int P, Jobs jobs,
               int32_t* __restrict__ dest, int64_t* __restrict__ n_drop,
               unsigned* ws, int cw, int cp) {
  __shared__ int smem[BLOCK / 32];
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  unsigned* cnt = ws + WS_HEAD;
  int* map = reinterpret_cast<int*>(cnt + 2 * G);
  const int c0 = min(W, g * cw), c1 = min(W, c0 + cw);
  const int s0 = min(P, g * cp), s1 = min(P, s0 + cp);
  {
    int nc = 0, nf = 0;
    for (int i = c0 + tid; i < c1; i += BLOCK) nc += cand_valid[i] != 0;
    for (int c = s0 + tid; c < s1; c += BLOCK) nf += table_valid[c] == 0;
    int tc, tf;
    block_exclusive_sum<BLOCK>(nc, smem, &tc);
    block_exclusive_sum<BLOCK>(nf, smem, &tf);
    if (tid == 0) {
      cnt[2 * g] = static_cast<unsigned>(tc);
      cnt[2 * g + 1] = static_cast<unsigned>(tf);
    }
  }
  unsigned phase = 0;
  siddhi_grid_sync(ws + WS_BAR, phase);
  int cand_before, n_cand, free_before, n_free;
  {
    int pc = 0, ac = 0, pf = 0, af = 0;
    for (int j = tid; j < G; j += BLOCK) {
      const int c = static_cast<int>(__ldcg(cnt + 2 * j));
      const int f = static_cast<int>(__ldcg(cnt + 2 * j + 1));
      ac += c;
      af += f;
      if (j < g) {
        pc += c;
        pf += f;
      }
    }
    block_exclusive_sum<BLOCK>(pc, smem, &cand_before);
    block_exclusive_sum<BLOCK>(ac, smem, &n_cand);
    block_exclusive_sum<BLOCK>(pf, smem, &free_before);
    block_exclusive_sum<BLOCK>(af, smem, &n_free);
  }
  if (g == 0 && tid == 0) n_drop[0] = n_cand > n_free ? n_cand - n_free : 0;
  // the free slots of rank below the candidate count, into the map
  int base = free_before;
  for (int x0 = s0; x0 < s1 && base < n_cand; x0 += BLOCK) {
    const int c = x0 + tid;
    const int f = c < s1 && table_valid[c] == 0 ? 1 : 0;
    int n;
    const int r = base + block_exclusive_sum<BLOCK>(f, smem, &n);
    if (f && r < n_cand) map[r] = c;
    base += n;
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  // the fitting candidates, into their slots
  base = cand_before;
  for (int x0 = c0; x0 < c1 && (base < n_free || dest != nullptr);
       x0 += BLOCK) {
    const int i = x0 + tid;
    const int v = i < c1 && cand_valid[i] ? 1 : 0;
    int n;
    const int r = base + block_exclusive_sum<BLOCK>(v, smem, &n);
    int slot = -1;
    if (v && r < n_free) {
      slot = __ldcg(map + r);
      map[r] = 0;
      copy_jobs(jobs, slot, i);
    }
    if (dest != nullptr && i < c1) dest[i] = slot;
    base += n;
  }
  if (siddhi_grid_last(ws + WS_BAR, ws + WS_DONE))
    for (int j = tid; j < 2 * G; j += BLOCK) cnt[j] = 0u;
}

// The jobs past the first 32 of a table: candidate i into slot dest[i].
__global__ void insert_more(const int32_t* __restrict__ dest, int W,
                            Jobs jobs) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= W) return;
  const int slot = dest[i];
  if (slot < 0) return;
  copy_jobs(jobs, slot, i);
}

int insert_capacity() {
  static int cap = -1;
  if (cap < 0) cap = siddhi_coop_capacity(k11_insert, BLOCK);
  return cap;
}

// Blocks of an insert of W candidates into P slots: one a INSERT_SLOTS
// slots or candidates, at most the co-resident blocks.
int insert_grid(int W, int P) {
  const int n = W > P ? W : P;
  const int want = n > INSERT_SLOTS ? (n + INSERT_SLOTS - 1) / INSERT_SLOTS
                                    : 1;
  const int cap = insert_capacity();
  return want < cap ? want : cap;
}

Jobs jobs_of(void* const* dst, const void* const* src, const long long* fill,
             const int* size, int n) {
  Jobs jobs;
  jobs.n = n;
  for (int k = 0; k < n; ++k) {
    jobs.job[k].dst = dst[k];
    jobs.job[k].src = src[k];
    jobs.job[k].fill = fill[k];
    jobs.job[k].size = size[k];
  }
  return jobs;
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

// Bytes of the insert's workspace for W candidates into P slots (zero
// when first allocated and after every launch); 0 where the card has no
// cooperative launches.
SIDDHI_API long long k11_insert_workspace_bytes(int W, int P) {
  const int G = insert_grid(W, P);
  if (G <= 0) return 0;
  const int m = W < P ? W : P;
  return 4ll * (WS_HEAD + 2ll * G + m);
}

// The whole insert: cand_valid bool[W] and the table's valid bool[P]
// (also the destination of one job); jobs as host arrays: dst[k] the
// table column, src[k] the candidate column or null (write fill[k]),
// size[k] the bytes an element (1, 2, 4 or 8). n_drop int64[1] out; ws
// the workspace (k11_insert_workspace_bytes); dest int32[W], needed (and
// written) only past 32 jobs.
SIDDHI_API int k11_pending_insert(const uint8_t* cand_valid, int W,
                                  const uint8_t* table_valid, int P,
                                  void* const* dst, const void* const* src,
                                  const long long* fill, const int* size,
                                  int n_jobs, int32_t* dest, int64_t* n_drop,
                                  unsigned* ws, cudaStream_t stream) {
  if (W < 0 || P < 0 || n_jobs < 0 || (n_jobs > MAX_JOBS && dest == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < n_jobs; ++k)
    if (size[k] != 1 && size[k] != 2 && size[k] != 4 && size[k] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) return 0;
  int grid = insert_grid(W, P);
  if (grid <= 0) return static_cast<int>(cudaErrorNotSupported);
  int cw = (W + grid - 1) / grid;
  int cp = P > 0 ? (P + grid - 1) / grid : 0;
  Jobs jobs = jobs_of(dst, src, fill, size,
                      n_jobs < MAX_JOBS ? n_jobs : MAX_JOBS);
  int32_t* d = n_jobs > MAX_JOBS ? dest : nullptr;
  void* args[] = {&cand_valid, &W,  &table_valid, &P,  &jobs,
                  &d,          &n_drop, &ws,      &cw, &cp};
  // one block waits for no other: a plain launch (cheaper on the card)
  const cudaError_t e =
      grid == 1 ? cudaLaunchKernel(reinterpret_cast<const void*>(k11_insert),
                                   dim3(1), dim3(BLOCK), args, 0, stream)
                : cudaLaunchCooperativeKernel(
                      reinterpret_cast<const void*>(k11_insert), dim3(grid),
                      dim3(BLOCK), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  int rc = siddhi_launch_status();
  for (int k0 = MAX_JOBS; rc == 0 && k0 < n_jobs; k0 += MAX_JOBS) {
    const int n = n_jobs - k0 < MAX_JOBS ? n_jobs - k0 : MAX_JOBS;
    insert_more<<<siddhi_blocks(W, BLOCK), BLOCK, 0, stream>>>(
        dest, W, jobs_of(dst + k0, src + k0, fill + k0, size + k0, n));
    rc = siddhi_launch_status();
  }
  return rc;
}
