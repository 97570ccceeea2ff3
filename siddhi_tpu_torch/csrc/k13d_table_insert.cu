// K13d — the in-memory table's insert: primary-key dedup and row placement.
//
// Replaces siddhi_tpu/core/table.py `InMemoryTable._make_insert`:
//   dedup (:177-190):
//     eq   = AND_k batch[k][:, None] == table[k][None, :]        [B, C]
//     dup  = (eq & table.valid[None, :]).any(1)
//     eq_b = AND_k batch[k][:, None] == batch[k][None, :]        [B, B]
//     dup_in_batch = (eq_b & tril(ones, -1) & valid[None, :]).any(1)
//     ins = valid & ~dup & ~dup_in_batch
//   placement (:191-204): the r-th inserted lane (in lane order) takes the
//     r-th free row (in row order, K1 on ~valid); every column, ts and
//     valid = True are scattered there; overflow = n_ins - n_fit and
//     dropped = n_valid - n_ins are returned.
//
// Equality is JAX's `==` in each column's promoted type, ANDed over up to
// MAX_KEYS columns, through the canonical keys and hash of k13_keys.cuh
// (shared with K13e's equality route): integers, bools and string codes
// bitwise, floats as floats (NaN equal to nothing, -0.0 == 0.0). A key
// with a NaN column equals no key, so such a lane or row takes no part.
//
// k13d_dedup: O(B + C) through one open-addressing hash of the keys, in
// one cooperative launch (at most the co-resident blocks, each walking the
// elements grid-stride):
//   build  every live row and valid lane with no NaN key hashes its
//          canonical columns (splitmix64 mixing, column order kept) and
//          claims an empty slot with atomicCAS, or walks to the slot whose
//          representative (a row or lane index) has equal columns, read
//          from the real key columns, so a collision costs a probe and
//          never a wrong answer. Its slot's mark takes the atomicMax of
//          0xffffffff for a row and 0x7fffffff - b for lane b: a row, else
//          the first lane of the class (the warp's lowest element of a slot
//          issues the one atomic for the warp). The table has at least
//          2 (C + B) slots, so a probe always ends at an empty slot;
//   grid barrier;
//   probe  lane b is dropped when its slot's mark is a row's or names a
//          lane before b. Only the lane's valid flag matters for the
//          in-batch rule, not whether that lane stayed, as in the JAX mask;
//          atomics decide no order the output depends on, so the result is
//          deterministic. Every lane's drop flag is written (no clear);
//   grid barrier, then the table and the lanes' slots are zeroed, so the
//          next call (of any size) finds its region zero.
//
// k13d_place: one cooperative launch. Each block counts the valid and
// staying lanes of its contiguous share of the lanes and, grid-stride, the
// free rows; a grid barrier; every block sums the counts (all blocks, and
// its predecessors' staying lanes). If the staying lanes overflow the free
// rows, nothing is written (an overflowing insert is all or nothing) and
// only the two counts are left. Otherwise each block ranks its staying
// lanes with block scans from its offset and writes each column of each
// into its free row, in place, reading the batch's columns coalesced; free
// rows are distinct, so the scatter has no conflict. The counts stay on
// the device; the caller reads both in one copy.
//
// Workspace (the library's, per stream; zero when first allocated and
// zero after every launch): the barrier and done counters, then either
// the placement's per-block counts or the dedup's table (a reference and
// a mark a slot) and the lanes' slots. The block that finishes last zeroes
// the counters and the placement's counts.
//
// Bound on the H100: bytes. The dedup reads the keys and valid flags once
// and writes the drop flags (~0.4 MB at app AC's B = 16,384 against C =
// 65,536); the design also writes and reads the 2^18-slot table (2 MB, in
// L2). The placement reads the flags and writes each staying lane's row.

#include "k13_keys.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_COLS = 64;
constexpr int PLACE_LANES = 512;  // lanes a placement block ranks, at least
constexpr int MIN_SLOTS = 256;
// workspace words: the barrier, the done counter, then the scratch region
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_HEAD = 4;
constexpr unsigned ROW_MARK = 0xffffffffu;
constexpr unsigned FIRST_LANE = 0x7fffffffu;  // lane b marks FIRST_LANE - b

struct Cols {
  const void* src[MAX_COLS];  // the batch's columns [B], ts last
  void* dst[MAX_COLS];        // the table's columns [C], ts last
  int size[MAX_COLS];         // bytes a value: 1, 4 or 8
  int n;
};

// Element e's key: row e below C, lane e - C above. False if a column is
// NaN.
__device__ __forceinline__ bool element_key(const KeyCols& lanes,
                                            const KeyCols& rows, int e,
                                            int C, unsigned long long* v) {
  return e < C ? read_key(rows, e, v) : read_key(lanes, e - C, v);
}

// Scratch layout of the dedup: ref[S], mark[S], lane_slot[B] (slot + 1).
__global__ void __launch_bounds__(BLOCK)
    k13d_dup(KeyCols lanes, KeyCols rows,
             const bool* __restrict__ lane_valid,
             const bool* __restrict__ row_valid, int B, int C, unsigned mask,
             unsigned* ws, bool* __restrict__ drop) {
  const int total = C + B;
  const int stride = gridDim.x * BLOCK;
  unsigned* ref = ws + WS_HEAD;
  unsigned* mark = ref + mask + 1;
  unsigned* lane_slot = mark + mask + 1;
  // build: the trip count is the same across the block, so warps stay
  // whole for the mark's match
  for (int e0 = blockIdx.x * BLOCK; e0 < total; e0 += stride) {
    const int e = e0 + threadIdx.x;
    unsigned long long v[MAX_KEYS];
    bool ins = false;
    if (e < total)
      ins = (e < C ? row_valid[e] : lane_valid[e - C]) &&
            element_key(lanes, rows, e, C, v);
    unsigned s = 0xffffffffu;
    if (ins) {
      s = static_cast<unsigned>(key_hash(v, lanes.n)) & mask;
      for (;;) {
        // a claimed slot keeps its reference for the launch: read it first,
        // so a class's repeats spend no atomic
        unsigned r = *reinterpret_cast<volatile unsigned*>(ref + s);
        if (r == 0u) {
          r = atomicCAS(ref + s, 0u, static_cast<unsigned>(e) + 1u);
          if (r == 0u) break;  // claimed
        }
        unsigned long long w[MAX_KEYS];
        element_key(lanes, rows, static_cast<int>(r) - 1, C, w);
        if (key_equal(w, v, lanes.n)) break;  // the class's slot
        s = (s + 1u) & mask;
      }
      if (e >= C) lane_slot[e - C] = s + 1u;
    }
    // elements ascend with the warp's lanes, and rows precede lanes: the
    // lowest element of a slot holds the warp's largest mark for it
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (ins && (peers & lanemask_lt()) == 0u)
      atomicMax(mark + s, e < C ? ROW_MARK
                                : FIRST_LANE - static_cast<unsigned>(e - C));
  }
  unsigned phase = 0;
  siddhi_grid_sync(ws + WS_BAR, phase);
  for (int b = blockIdx.x * BLOCK + threadIdx.x; b < B; b += stride) {
    const unsigned ls = __ldcg(lane_slot + b);
    bool d = false;
    if (ls != 0u) {
      const unsigned m = __ldcg(mark + ls - 1u);
      d = m == ROW_MARK || FIRST_LANE - m < static_cast<unsigned>(b);
    }
    drop[b] = d;
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  const long long words = 2ll * (mask + 1ull) + B;
  for (long long j = blockIdx.x * BLOCK + threadIdx.x; j < words; j += stride)
    ref[j] = 0u;
  siddhi_grid_last(ws + WS_BAR, ws + WS_DONE);
}

template <typename T>
__device__ __forceinline__ void move_one(const void* src, void* dst, int b,
                                         int slot) {
  static_cast<T*>(dst)[slot] = static_cast<const T*>(src)[b];
}

__device__ __forceinline__ bool stays(const bool* valid, const bool* drop,
                                      int b) {
  return valid[b] && !(drop != nullptr && drop[b]);
}

// Scratch layout of the placement: a block's (staying, valid, free) counts.
__global__ void __launch_bounds__(BLOCK)
    k13d_place(const bool* __restrict__ valid, const bool* __restrict__ drop,
               int B, bool* __restrict__ row_valid, int C,
               const int* __restrict__ free_order, Cols cols,
               int* __restrict__ counts, unsigned* ws, int per_block) {
  __shared__ int smem[BLOCK / 32];
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  unsigned* cnt = ws + WS_HEAD;
  const int b0 = min(B, g * per_block);
  const int b1 = min(B, b0 + per_block);
  {
    int s = 0, v = 0, f = 0;
    for (int b = b0 + tid; b < b1; b += BLOCK) {
      v += valid[b];
      s += stays(valid, drop, b);
    }
    for (int c = g * BLOCK + tid; c < C; c += G * BLOCK) f += !row_valid[c];
    int ts, tv, tf;
    block_exclusive_sum<BLOCK>(s, smem, &ts);
    block_exclusive_sum<BLOCK>(v, smem, &tv);
    block_exclusive_sum<BLOCK>(f, smem, &tf);
    if (tid == 0) {
      cnt[3 * g] = static_cast<unsigned>(ts);
      cnt[3 * g + 1] = static_cast<unsigned>(tv);
      cnt[3 * g + 2] = static_cast<unsigned>(tf);
    }
  }
  unsigned phase = 0;
  siddhi_grid_sync(ws + WS_BAR, phase);
  int before, n_ins, n_valid, n_free;
  {
    int p = 0, s = 0, v = 0, f = 0;
    for (int j = tid; j < G; j += BLOCK) {
      const int sj = static_cast<int>(__ldcg(cnt + 3 * j));
      s += sj;
      if (j < g) p += sj;
      v += static_cast<int>(__ldcg(cnt + 3 * j + 1));
      f += static_cast<int>(__ldcg(cnt + 3 * j + 2));
    }
    block_exclusive_sum<BLOCK>(p, smem, &before);
    block_exclusive_sum<BLOCK>(s, smem, &n_ins);
    block_exclusive_sum<BLOCK>(v, smem, &n_valid);
    block_exclusive_sum<BLOCK>(f, smem, &n_free);
  }
  const int overflow = n_ins > n_free ? n_ins - n_free : 0;
  if (g == 0 && tid == 0) {
    counts[0] = overflow;
    counts[1] = n_valid - n_ins;
  }
  if (!overflow) {  // else leave the table as it was
    int base = before;
    for (int x0 = b0; x0 < b1; x0 += BLOCK) {  // the same trip count
      const int b = x0 + tid;
      const int stay = b < b1 && stays(valid, drop, b) ? 1 : 0;
      int n;
      const int r = base + block_exclusive_sum<BLOCK>(stay, smem, &n);
      if (stay) {
        const int slot = free_order[r];
        for (int c = 0; c < cols.n; ++c) {
          switch (cols.size[c]) {
            case 1:
              move_one<uint8_t>(cols.src[c], cols.dst[c], b, slot);
              break;
            case 4:
              move_one<uint32_t>(cols.src[c], cols.dst[c], b, slot);
              break;
            default:
              move_one<unsigned long long>(cols.src[c], cols.dst[c], b,
                                           slot);
          }
        }
        row_valid[slot] = true;
      }
      base += n;
    }
  }
  if (siddhi_grid_last(ws + WS_BAR, ws + WS_DONE))
    for (int j = tid; j < 3 * G; j += BLOCK) cnt[j] = 0u;
}

template <typename Kernel>
int capacity_of(Kernel kernel, int* cache) {
  if (*cache < 0) {
    const int c = siddhi_coop_capacity(kernel, BLOCK);
    if (c <= 0) return 0;
    *cache = c;
  }
  return *cache;
}

int dup_capacity() {
  static int cap = -1;
  return capacity_of(k13d_dup, &cap);
}

int place_capacity() {
  static int cap = -1;
  return capacity_of(k13d_place, &cap);
}

// Slots of the dedup's table for B lanes and C rows: a power of two, at
// least 2 (B + C).
long long table_slots(int B, int C) {
  long long s = MIN_SLOTS;
  while (s < 2ll * (static_cast<long long>(B) + C)) s <<= 1;
  return s;
}

int place_grid(int B) {
  const int want = B > PLACE_LANES ? (B + PLACE_LANES - 1) / PLACE_LANES : 1;
  const int cap = place_capacity();
  return want < cap ? want : cap;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k13d_max_cols() { return MAX_COLS; }

// Bytes of the workspace a call of B lanes against C rows needs (both
// entry points); 0 where the card has no cooperative launches.
SIDDHI_API long long k13d_workspace_bytes(int B, int C) {
  if (dup_capacity() <= 0 || place_capacity() <= 0) return 0;
  const long long dup = 2 * table_slots(B, C) + B;
  const long long place = 3ll * place_grid(B);
  return 4 * (WS_HEAD + (dup > place ? dup : place));
}

// k13d_dedup: drop[b] = 1 where valid lane b's key equals a live row's or
// an earlier valid lane's, else 0. lane_keys/row_keys/types: n_keys host
// entries (device pointers; types K_I8..K_F64, both sides of one type);
// lane_valid bool[B], row_valid bool[C], drop bool[B] out; ws: the
// workspace (k13d_workspace_bytes).
SIDDHI_API int k13d_dedup(const void* const* lane_keys,
                          const void* const* row_keys, const int* types,
                          int n_keys, const bool* lane_valid,
                          const bool* row_valid, int B, int C, bool* drop,
                          unsigned* ws, cudaStream_t stream) {
  if (n_keys < 1 || n_keys > MAX_KEYS || B < 0 || C < 0 ||
      static_cast<long long>(B) + C >= (1ll << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  KeyCols lanes, rows;
  lanes.n = rows.n = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    if (types[k] < K_I8 || types[k] > K_F64)
      return static_cast<int>(cudaErrorInvalidValue);
    lanes.col[k] = lane_keys[k];
    rows.col[k] = row_keys[k];
    lanes.type[k] = rows.type[k] = types[k];
  }
  if (B == 0) return 0;
  const int cap = dup_capacity();
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  const int want = static_cast<int>(siddhi_blocks(B + C, BLOCK));
  const int grid = want < cap ? want : cap;
  unsigned mask = static_cast<unsigned>(table_slots(B, C) - 1);
  void* args[] = {&lanes, &rows, &lane_valid, &row_valid, &B,
                  &C,     &mask, &ws,         &drop};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k13d_dup), dim3(grid), dim3(BLOCK), args,
      0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}

// k13d_place_rows: the staying lanes (valid and not drop; drop may be
// null) into the free rows free_order[0..], every column and valid in
// place, unless they overflow. counts int32[2] out: overflow, dropped.
SIDDHI_API int k13d_place_rows(const bool* valid, const bool* drop, int B,
                               bool* row_valid, int C, const int* free_order,
                               const void* const* src, void* const* dst,
                               const int* sizes, int n_cols, int* counts,
                               unsigned* ws, cudaStream_t stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || B < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (sizes[c] != 1 && sizes[c] != 4 && sizes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.src[c] = src[c];
    cols.dst[c] = dst[c];
    cols.size[c] = sizes[c];
  }
  int grid = place_grid(B);
  if (grid <= 0) return static_cast<int>(cudaErrorNotSupported);
  int per_block = B > 0 ? (B + grid - 1) / grid : 0;
  void* args[] = {&valid, &drop,  &B,      &row_valid, &C,
                  &free_order, &cols, &counts, &ws,        &per_block};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k13d_place), dim3(grid), dim3(BLOCK),
      args, 0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}
