// K4b — the dense key table of a partition's key-slot path: keys -> dense
// slot ids in first-appearance order, the table kept as its K smallest keys
// in sorted order.
//
// Replaces siddhi_tpu/ops/groupby.py `dense_key_lookup_or_insert`
// (:500-551), bit for bit, the table included:
//   keys equal to INT64_MAX (the pad) are read as INT64_MAX - 1;
//   pos = searchsorted(sorted_keys, key); found = sorted_keys[pos] == key;
//   a found lane takes sorted_ids[pos]; an invalid lane 0;
//   a new valid key takes count + r, r the rank of its first lane among
//   the first lanes of the batch's new keys, in lane order; every later
//   lane of the key takes the same id (ids at or past K match no slot);
//   the new table is the K smallest of (the table's entries, the new keys
//   with their ids, pads), stably: the live keys ascending, then the
//   table's pad entries in order (their ids kept);
//   count = min(count + n_new, K).
// A later, smaller new key therefore evicts a live key of a full table, as
// the JAX merge does.
//
// One cooperative launch (at most the co-resident blocks; every block
// stages the table's keys in shared memory for its binary searches):
//   A  each lane reads its key, searches the table, writes the id of a
//      found or invalid lane; a new valid lane hashes its key into an
//      open-addressing table in the workspace (64-bit keys claimed with
//      atomicCAS, stored XOR INT64_MAX so that 0 marks an empty slot), and
//      its slot takes the atomicMax of FIRST_LANE - lane (the warp's
//      lowest lane of a slot issues the one atomic for the warp): the mark
//      names the key's first lane;
//   grid barrier; B  each block counts the first lanes of its contiguous
//      share of the lanes; grid barrier; every block sums its
//      predecessors' counts and ranks its first lanes with block scans:
//      the slot's id is count + r, and the key is written to nk[r];
//   grid barrier; C  each new lane reads its slot's id. Where more than K
//      keys are new, only the K smallest can enter the table: eight radix
//      passes over nk (a 256-bin histogram a byte, grid barriers between)
//      find the K-th smallest, and the keys at or below it are compacted
//      into the candidate buffer;
//   grid barrier; block 0 sorts the candidates (at most K <= 4096) by a
//      bitonic sort in shared memory and merges them with the table into
//      the new table (each entry's place is its index plus its rank in the
//      other list); then every block zeroes its share of the workspace:
//      the slots the lanes used, the lanes' slots, the histograms and block
//      counts. The block that finishes last zeroes the barrier counters.
// The new table is written to its own tensors (the inputs are not
// modified), so no block reads an entry another has overwritten.
//
// Bound on the H100: bytes. The call must read the keys (8 B a lane) and
// the valid flags (1 B), write the ids (4 B) and read and write the table
// (12 B an entry each way); the design also writes and reads the hash
// table and the per-lane slots in L2, and spends its time on the launch
// and its four grid barriers.

#include "k13_keys.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_K = 4096;
constexpr long long KEY_PAD = 0x7fffffffffffffffLL;
constexpr unsigned long long SIGN = 0x8000000000000000ull;
constexpr unsigned FIRST_LANE = 0xffffffffu;  // lane b marks FIRST_LANE - b
constexpr int MIN_SLOTS = 256;
constexpr int RADIX = 256;
constexpr int DIGITS = 8;
// workspace words: the barrier, the done counter, the candidates compacted
// so far, then DIGITS x RADIX histogram words, the per-block first counts
// and (8-byte aligned) the hash table and the lanes' slots
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_CAND = 2;
constexpr int WS_HIST = 4;
static_assert(BLOCK == RADIX, "a thread a histogram bin");

struct Args {
  const long long* sorted_keys;  // [K]
  const int* sorted_ids;         // [K]
  const int* count;              // [1]
  const long long* keys;         // [L]
  const bool* valid;             // [L]
  int L;
  int K;
  unsigned mask;       // hash slots - 1
  int* ids;            // [L] out
  long long* out_keys;  // [K] out
  int* out_ids;        // [K] out
  int* out_count;      // [1] out
  long long* nk;       // [L] scratch: the new keys by rank
  long long* cand_key;  // [K] scratch: the selected candidates
  int* cand_rank;      // [K] scratch: their ranks
  unsigned* ws;
};

// Word offsets of the workspace regions for a grid of G blocks, S slots.
struct Layout {
  long long blk, keys, mark, id, lane, words;
  __host__ __device__ Layout(int G, long long S, int L) {
    blk = WS_HIST + DIGITS * RADIX;
    keys = (blk + G + 1) & ~1ll;  // 8-byte aligned
    mark = keys + 2 * S;
    id = mark + S;
    lane = id + S;
    words = lane + L;
  }
};

long long table_slots(int L) {
  long long s = MIN_SLOTS;
  while (s < 2ll * L) s <<= 1;
  return s;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory: the table's keys (8 K bytes) for the searches,
// then block 0's candidates (12 bytes each, a power of two at least K).
size_t smem_bytes(int K) { return 12 * static_cast<size_t>(pow2_at_least(K)); }

__device__ __forceinline__ long long lane_key(const long long* keys, int b) {
  const long long k = keys[b];
  return k == KEY_PAD ? KEY_PAD - 1 : k;
}

// Elements of a[0, n) below v (a ascending): searchsorted, side 'left'.
__device__ __forceinline__ int lower_bound(const long long* a, int n,
                                           long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool is_first(const unsigned* lane_slot,
                                         const unsigned* mark, int b) {
  const unsigned ls = __ldcg(lane_slot + b);
  return ls != 0u &&
         __ldcg(mark + ls - 1u) == FIRST_LANE - static_cast<unsigned>(b);
}

__global__ void __launch_bounds__(BLOCK) k4b_kernel(Args a) {
  extern __shared__ unsigned long long dyn[];
  __shared__ int scan[BLOCK / 32];
  __shared__ unsigned hist[RADIX];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_need;
  const int L = a.L, K = a.K;
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const int stride = G * BLOCK;
  const Layout lay(G, static_cast<long long>(a.mask) + 1, L);
  unsigned* hist_g = a.ws + WS_HIST;
  unsigned* blk = a.ws + lay.blk;
  unsigned long long* hkey =
      reinterpret_cast<unsigned long long*>(a.ws + lay.keys);
  unsigned* hmark = a.ws + lay.mark;
  unsigned* hid = a.ws + lay.id;
  unsigned* lane_slot = a.ws + lay.lane;
  long long* tkeys = reinterpret_cast<long long*>(dyn);
  for (int i = tid; i < K; i += BLOCK) tkeys[i] = a.sorted_keys[i];
  __syncthreads();
  const int count = *a.count;

  // A: search the table; hash the new lanes' keys. The trip count is the
  // same across the block, so warps stay whole for the mark's match.
  for (int b0 = g * BLOCK; b0 < L; b0 += stride) {
    const int b = b0 + tid;
    bool ins = false;
    unsigned s = 0xffffffffu;
    if (b < L) {
      const long long k = lane_key(a.keys, b);
      const int pos = lower_bound(tkeys, K, k);
      if (!a.valid[b]) {
        a.ids[b] = 0;
      } else if (pos < K && tkeys[pos] == k) {
        a.ids[b] = a.sorted_ids[pos];
      } else {
        ins = true;
        const unsigned long long enc =
            static_cast<unsigned long long>(k ^ KEY_PAD);  // never 0
        s = static_cast<unsigned>(mix64(static_cast<unsigned long long>(k))) &
            a.mask;
        for (;;) {
          // a claimed slot keeps its key for the launch: read it first, so
          // a key's repeats spend no atomic
          unsigned long long r =
              *reinterpret_cast<volatile unsigned long long*>(hkey + s);
          if (r == 0ull) {
            r = atomicCAS(hkey + s, 0ull, enc);
            if (r == 0ull) break;  // claimed
          }
          if (r == enc) break;  // the key's slot
          s = (s + 1u) & a.mask;
        }
        lane_slot[b] = s + 1u;
      }
    }
    // lanes ascend with the warp's lanes: the lowest lane of a slot holds
    // the warp's largest mark for it
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (ins && (peers & lanemask_lt()) == 0u)
      atomicMax(hmark + s, FIRST_LANE - static_cast<unsigned>(b));
  }
  unsigned phase = 0;
  siddhi_grid_sync(a.ws + WS_BAR, phase);

  // B: rank the first lanes in lane order, block by contiguous share
  const int per = (L + G - 1) / G;
  const int c0 = min(L, g * per), c1 = min(L, c0 + per);
  {
    int mine = 0, total;
    for (int b = c0 + tid; b < c1; b += BLOCK)
      mine += is_first(lane_slot, hmark, b);
    block_exclusive_sum<BLOCK>(mine, scan, &total);
    if (tid == 0) blk[g] = static_cast<unsigned>(total);
  }
  siddhi_grid_sync(a.ws + WS_BAR, phase);
  int base, n_new;
  {
    int pre = 0, all = 0;
    for (int j = tid; j < G; j += BLOCK) {
      const int v = static_cast<int>(__ldcg(blk + j));
      all += v;
      if (j < g) pre += v;
    }
    block_exclusive_sum<BLOCK>(pre, scan, &base);
    block_exclusive_sum<BLOCK>(all, scan, &n_new);
  }
  for (int t0 = c0; t0 < c1; t0 += BLOCK) {
    const int b = t0 + tid;
    const int f = b < c1 ? is_first(lane_slot, hmark, b) : 0;
    int tot;
    const int r = base + block_exclusive_sum<BLOCK>(f, scan, &tot);
    if (f) {
      hid[__ldcg(lane_slot + b) - 1u] = static_cast<unsigned>(count + r);
      a.nk[r] = lane_key(a.keys, b);
    }
    base += tot;
  }
  siddhi_grid_sync(a.ws + WS_BAR, phase);

  // C: the new lanes' ids
  for (int b = g * BLOCK + tid; b < L; b += stride) {
    const unsigned ls = __ldcg(lane_slot + b);
    if (ls != 0u) a.ids[b] = static_cast<int>(__ldcg(hid + ls - 1u));
  }
  // more than K new keys: find the K-th smallest (ordered bits, a byte a
  // pass from the top) and compact the K keys at or below it
  const bool select = n_new > K;
  if (select) {
    unsigned long long prefix = 0;
    int need = K;
    for (int d = 0; d < DIGITS; ++d) {
      const int shift = 56 - 8 * d;
      const unsigned long long above = d == 0 ? 0ull : ~0ull << (shift + 8);
      hist[tid] = 0u;
      __syncthreads();
      for (int i = g * BLOCK + tid; i < n_new; i += stride) {
        const unsigned long long u =
            static_cast<unsigned long long>(__ldcg(a.nk + i)) ^ SIGN;
        if ((u & above) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1u);
      }
      __syncthreads();
      unsigned* gh = hist_g + d * RADIX;
      if (hist[tid] != 0u) atomicAdd(gh + tid, hist[tid]);
      siddhi_grid_sync(a.ws + WS_BAR, phase);
      if (tid == 0) {
        int acc = 0, digit = 0;
        for (; digit < RADIX - 1; ++digit) {
          const int c = static_cast<int>(__ldcg(gh + digit));
          if (acc + c >= need) break;
          acc += c;
        }
        s_need = need - acc;
        s_prefix = prefix | static_cast<unsigned long long>(digit) << shift;
      }
      __syncthreads();
      need = s_need;
      prefix = s_prefix;
      __syncthreads();
    }
    for (int i = g * BLOCK + tid; i < n_new; i += stride) {
      const long long k = __ldcg(a.nk + i);
      if ((static_cast<unsigned long long>(k) ^ SIGN) <= prefix) {
        const unsigned at = atomicAdd(a.ws + WS_CAND, 1u);
        if (at < static_cast<unsigned>(K)) {
          a.cand_key[at] = k;
          a.cand_rank[at] = i;
        }
      }
    }
  }
  siddhi_grid_sync(a.ws + WS_BAR, phase);

  if (g == 0) {
    // the candidates, sorted; merged with the table's live keys
    const int m = select ? K : n_new;
    const int kp = pow2_at_least(max(m, 1));
    long long* ck = reinterpret_cast<long long*>(dyn);
    int* cr = reinterpret_cast<int*>(ck + kp);
    for (int i = tid; i < kp; i += BLOCK) {
      if (i < m) {
        ck[i] = __ldcg(select ? a.cand_key + i : a.nk + i);
        cr[i] = select ? __ldcg(a.cand_rank + i) : i;
      } else {
        ck[i] = KEY_PAD;
        cr[i] = 0;
      }
    }
    __syncthreads();
    for (int k2 = 2; k2 <= kp; k2 <<= 1) {
      for (int j2 = k2 >> 1; j2 > 0; j2 >>= 1) {
        for (int i = tid; i < kp; i += BLOCK) {
          const int ixj = i ^ j2;
          if (ixj > i) {
            const long long x = ck[i], y = ck[ixj];
            if ((x > y) == ((i & k2) == 0)) {
              ck[i] = y;
              ck[ixj] = x;
              const int t = cr[i];
              cr[i] = cr[ixj];
              cr[ixj] = t;
            }
          }
        }
        __syncthreads();
      }
    }
    const int t = lower_bound(a.sorted_keys, K, KEY_PAD);  // live entries
    for (int j = tid; j < m; j += BLOCK) {
      const int p = j + lower_bound(a.sorted_keys, t, ck[j]);
      if (p < K) {
        a.out_keys[p] = ck[j];
        a.out_ids[p] = count + cr[j];
      }
    }
    for (int i = tid; i < t; i += BLOCK) {
      const long long k = a.sorted_keys[i];
      const int p = i + lower_bound(ck, m, k);
      if (p < K) {
        a.out_keys[p] = k;
        a.out_ids[p] = a.sorted_ids[i];
      }
    }
    // the table's pad entries, in order, fill what is left
    for (int p = t + m + tid; p < K; p += BLOCK) {
      a.out_keys[p] = a.sorted_keys[p - m];
      a.out_ids[p] = a.sorted_ids[p - m];
    }
    if (tid == 0) {
      *a.out_count = min(count + n_new, K);
      a.ws[WS_CAND] = 0u;
    }
  }
  // leave the workspace zero: the lanes' slots and their marks, ids and
  // keys, the histograms and the block counts
  for (int b = g * BLOCK + tid; b < L; b += stride) {
    const unsigned ls = __ldcg(lane_slot + b);
    if (ls != 0u) {
      hkey[ls - 1u] = 0ull;
      hmark[ls - 1u] = 0u;
      hid[ls - 1u] = 0u;
      lane_slot[b] = 0u;
    }
  }
  if (select)
    for (int i = g * BLOCK + tid; i < DIGITS * RADIX; i += stride)
      hist_g[i] = 0u;
  for (int j = g * BLOCK + tid; j < G; j += stride) blk[j] = 0u;
  siddhi_grid_last(a.ws + WS_BAR, a.ws + WS_DONE);
}

int capacity(int K) {
  static const bool opted = cudaFuncSetAttribute(
      k4b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(MAX_K))) == cudaSuccess;
  if (!opted) return 0;
  return siddhi_coop_capacity(k4b_kernel, BLOCK, smem_bytes(K));
}

int grid_for(int L, int K) {
  const int want = L > BLOCK ? static_cast<int>(siddhi_blocks(L, BLOCK)) : 1;
  const int cap = capacity(K);
  return want < cap ? want : cap;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k4b_max_k() { return MAX_K; }

// Bytes of the workspace a call of L lanes into a K-entry table needs; 0
// where the card has no cooperative launches.
SIDDHI_API long long k4b_workspace_bytes(int L, int K) {
  const int grid = grid_for(L, K);
  if (grid <= 0) return 0;
  return 4 * Layout(grid, table_slots(L), L).words;
}

// Bytes of the scratch (no zeroing needed): the new keys by rank and the
// selected candidates with their ranks.
SIDDHI_API long long k4b_scratch_bytes(int L, int K) {
  return 8ll * L + 12ll * K + 16;
}

// k4b_dense_lookup_or_insert: ids int32[L] and the new table (out_keys
// int64[K], out_ids int32[K], out_count int32[1]) from the table
// (sorted_keys, sorted_ids, count), the lanes' keys int64[L] and valid
// bool[L]. scratch: k4b_scratch_bytes; ws: the workspace
// (k4b_workspace_bytes), zero on entry and on return.
SIDDHI_API int k4b_dense_lookup_or_insert(
    const long long* sorted_keys, const int* sorted_ids, const int* count,
    const long long* keys, const bool* valid, int L, int K, int* ids,
    long long* out_keys, int* out_ids, int* out_count, void* scratch,
    unsigned* ws, cudaStream_t stream) {
  if (L < 0 || L >= (1 << 30) || K < 1 || K > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_for(L, K);
  if (grid <= 0) return static_cast<int>(cudaErrorNotSupported);
  Args a;
  a.sorted_keys = sorted_keys;
  a.sorted_ids = sorted_ids;
  a.count = count;
  a.keys = keys;
  a.valid = valid;
  a.L = L;
  a.K = K;
  a.mask = static_cast<unsigned>(table_slots(L) - 1);
  a.ids = ids;
  a.out_keys = out_keys;
  a.out_ids = out_ids;
  a.out_count = out_count;
  a.nk = static_cast<long long*>(scratch);
  a.cand_key = a.nk + L;
  a.cand_rank = reinterpret_cast<int*>(a.cand_key + K);
  a.ws = ws;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k4b_kernel), dim3(grid), dim3(BLOCK),
      args, smem_bytes(K), stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}
