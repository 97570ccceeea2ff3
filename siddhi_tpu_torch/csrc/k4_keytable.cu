// K4 — open-addressing key table: group-by keys -> dense int32 ids.
//
// Replaces siddhi_tpu/ops/groupby.py `key_lookup_or_insert` and reproduces
// its table state, not only its ids: H = 2K int64 slots (INT64_MAX = empty),
// a double-hashed probe window per key (32 slots: the JAX window's 16 and 16
// more, used only by keys whose first 16 slots are all taken, which the JAX
// table drops)
//   h32 = (lo ^ hi) * 0x9E3779B9 (u32),  base = h32 % H,
//   stride = 1 + 2 * ((h32 >> 16) & 7),
// the first match and the first empty slot in window order, five claim
// waves in which the smaller key wins a contested slot (the JAX scatter-min),
// dense ids ranked in slot order, and the overflow revert with `misses`.
//
// Bound on the H100: bytes, in random 8-byte gathers. A probe reads up to 32
// table words per lane from a 16 MB table (H = 2^21), which the 50 MB L2
// mostly holds, so the cost is L2 latency and one launch per wave. Design:
// one thread per lane per launch; each claim wave is one launch of
// `k4_claim` (64-bit atomicMin = the JAX `.at[].min`) followed by one
// re-probe launch that sees the table as the wave left it, which keeps the
// wave semantics of the JAX loop exactly. Lanes that need nothing return at
// once, so a steady-state batch (all keys present) costs the waves' launch
// latency only — no host sync decides whether to run them. The id ranking
// between the waves and the commit is a torch sort + cumsum in the wrapper.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int DEPTH = 32;
constexpr long long KEY_PAD = 0x7FFFFFFFFFFFFFFFll;

__device__ __forceinline__ long long load_key(const long long* keys, int i) {
  const long long k = keys[i];
  return k == KEY_PAD ? KEY_PAD - 1 : k;  // never collide with the pad
}

struct Window {
  unsigned base;
  unsigned stride;
};

__device__ __forceinline__ Window window_of(long long key, unsigned H) {
  const unsigned long long u = static_cast<unsigned long long>(key);
  unsigned h32 = static_cast<unsigned>(u) ^ static_cast<unsigned>(u >> 32);
  h32 *= 0x9E3779B9u;
  Window w;
  w.base = h32 % H;
  w.stride = 1u + 2u * ((h32 >> 16) & 7u);
  return w;
}

// One probe round: first match / first empty slot in window order. Updates
// need/slot_of/won for lanes that still need a slot, and records the next
// claim candidate. `wslot` is null on the first round (no claim yet).
__global__ void k4_probe(const long long* __restrict__ tbl,
                         const long long* __restrict__ keys, unsigned H, int n,
                         uint8_t* __restrict__ need,
                         int32_t* __restrict__ slot_of,
                         uint8_t* __restrict__ won,
                         const int32_t* __restrict__ wslot,
                         uint8_t* __restrict__ has_empty,
                         int32_t* __restrict__ eslot) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || !need[i]) return;
  const long long key = load_key(keys, i);
  const Window w = window_of(key, H);
  int mslot = -1, es = -1;
  for (int d = 0; d < DEPTH; ++d) {
    const int s = static_cast<int>((w.base + d * w.stride) % H);
    const long long k = tbl[s];
    if (k == key) {
      mslot = s;
      break;  // the first match decides; a later empty slot is irrelevant
    }
    if (k == KEY_PAD && es < 0) es = s;
  }
  if (mslot >= 0) {
    slot_of[i] = mslot;
    if (wslot != nullptr && mslot == wslot[i]) won[i] = 1;
    need[i] = 0;
  }
  has_empty[i] = es >= 0;
  eslot[i] = es >= 0 ? es : 0;
}

__global__ void k4_claim(long long* __restrict__ tbl,
                         const long long* __restrict__ keys, int n,
                         const uint8_t* __restrict__ need,
                         const uint8_t* __restrict__ has_empty,
                         const int32_t* __restrict__ eslot,
                         int32_t* __restrict__ wslot) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  if (need[i] && has_empty[i]) {
    atomicMin(&tbl[eslot[i]], load_key(keys, i));
    wslot[i] = eslot[i];
  } else {
    wslot[i] = -1;
  }
}

// Over the sorted won slots: assign ids count + rank to unique slots, or
// revert the slot to empty when the id space is exhausted.
__global__ void k4_commit(long long* __restrict__ tbl,
                          int32_t* __restrict__ ids,
                          const int32_t* __restrict__ sw,
                          const uint8_t* __restrict__ uniq,
                          const int32_t* __restrict__ rank, int n,
                          const int32_t* __restrict__ count, int K,
                          int32_t* __restrict__ n_new) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || !uniq[i]) return;
  const int new_id = count[0] + rank[i];
  if (new_id >= K) {
    tbl[sw[i]] = KEY_PAD;
  } else {
    ids[sw[i]] = new_id;
    atomicAdd(n_new, 1);
  }
}

// Final verification: a lane resolves only if its slot still stores its key.
__global__ void k4_resolve(const long long* __restrict__ tbl,
                           const int32_t* __restrict__ ids,
                           const long long* __restrict__ keys,
                           const uint8_t* __restrict__ valid,
                           const uint8_t* __restrict__ need,
                           const int32_t* __restrict__ slot_of, int n,
                           int32_t* __restrict__ out_ids,
                           uint8_t* __restrict__ resolved,
                           int32_t* __restrict__ count,
                           const int32_t* __restrict__ n_new, int K,
                           int32_t* __restrict__ misses) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i == 0) count[0] = min(count[0] + n_new[0], K);
  if (i >= n) return;
  const bool ok = valid[i] && !need[i] && tbl[slot_of[i]] == load_key(keys, i);
  out_ids[i] = ok ? ids[slot_of[i]] : 0;
  resolved[i] = ok;
  if (valid[i] && !ok) atomicAdd(misses, 1);
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// First probe (need = valid on entry) and the claim waves. All pointers are
// device memory; need/won/has_empty are uint8, the rest int32.
SIDDHI_API int k4_probe_and_claim(long long* tbl, const long long* keys,
                                  int H, int n, int waves, uint8_t* need,
                                  int32_t* slot_of, uint8_t* won,
                                  int32_t* wslot, uint8_t* has_empty,
                                  int32_t* eslot, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned grid = siddhi_blocks(n, BLOCK);
  const unsigned uH = static_cast<unsigned>(H);
  k4_probe<<<grid, BLOCK, 0, stream>>>(tbl, keys, uH, n, need, slot_of, won,
                                       nullptr, has_empty, eslot);
  int rc = siddhi_launch_status();
  for (int r = 0; r < waves && rc == 0; ++r) {
    k4_claim<<<grid, BLOCK, 0, stream>>>(tbl, keys, n, need, has_empty, eslot,
                                         wslot);
    rc = siddhi_launch_status();
    if (rc) break;
    k4_probe<<<grid, BLOCK, 0, stream>>>(tbl, keys, uH, n, need, slot_of, won,
                                         wslot, has_empty, eslot);
    rc = siddhi_launch_status();
  }
  return rc;
}

// Commit the ranked new entries, then resolve every lane. `n_new` is one
// int32 of zeroed scratch; count and misses are the table's int32 scalars.
SIDDHI_API int k4_commit_and_resolve(
    long long* tbl, int32_t* ids, const int32_t* sw, const uint8_t* uniq,
    const int32_t* rank, const long long* keys, const uint8_t* valid,
    const uint8_t* need, const int32_t* slot_of, int n, int K,
    int32_t* count, int32_t* misses, int32_t* n_new, int32_t* out_ids,
    uint8_t* resolved, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned grid = siddhi_blocks(n, BLOCK);
  k4_commit<<<grid, BLOCK, 0, stream>>>(tbl, ids, sw, uniq, rank, n, count, K,
                                        n_new);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k4_resolve<<<grid, BLOCK, 0, stream>>>(tbl, ids, keys, valid, need, slot_of,
                                         n, out_ids, resolved, count, n_new, K,
                                         misses);
  return siddhi_launch_status();
}
