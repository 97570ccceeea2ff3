// K1 — stable partition order (stream compaction).
//
// Replaces siddhi_tpu/ops/search.py `stable_partition_order`: the
// permutation that stably moves live lanes to the front. The JAX version is
// two cumsums and one scatter; order[pos_live(i)] = i for live lanes and
// order[n_live + pos_dead(i)] = i for dead ones. This kernel gives the same
// permutation bit for bit.
//
// Bound on the H100: bytes. Per lane it reads one byte and writes one int32
// index (5 bytes a lane, ~0.66 MB at a 131,072-lane batch), so the least
// time is ~0.2 us at 3.35 TB/s: one launch's latency is ten times that, so
// the design spends one plain launch a call, needs no grid barrier, and
// allocates nothing.
//
// A dead lane's place, n_live + (dead lanes before it), needs the global
// live count; written as n - 1 - (dead lanes after it) it needs only the
// dead lanes after it. So one launch runs two decoupled look-backs
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016) in opposite directions: the block that takes virtual
// index v (in the order blocks start, from a counter) places the live
// lanes of tile v, after the live counts of tiles 0..v-1, and the dead
// lanes of tile T-1-v, after the dead counts of tiles T-v..T-1. Both
// chains wait only on blocks that started earlier, so a plain launch of
// any size makes progress. A thread reads 16 live flags with one 16-byte
// load (byte loads where the flags are not 16-byte aligned, and at the
// end) and keeps them as a 16-bit mask; a tile's lanes are staged in
// shared memory in their order and written out coalesced. Up to one tile
// (4,096 lanes) one block places both parts without a workspace. The
// workspace (the library's, per stream) holds the block counter, the done
// counter and both chains' flags; the block that finishes last zeroes it.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int ITEMS = 16;            // lanes a thread: one 16-byte load
constexpr int TILE = BLOCK * ITEMS;  // lanes a tile
// workspace words: the block counter, the done counter, then the live
// chain's T flags and the dead chain's T flags
constexpr int WS_NEXT = 0;
constexpr int WS_DONE = 1;
constexpr int WS_CHAINS = 2;
constexpr unsigned FLAG_A = 1u << 30;  // a tile's own count
constexpr unsigned FLAG_P = 2u << 30;  // the count through this tile
constexpr unsigned COUNT_MASK = FLAG_A - 1u;

// Bits 7, 15, 23 and 31 of w set where its byte is non-zero, packed into
// the low 4 bits.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (hi >> 7 & 1u) | (hi >> 14 & 2u) | (hi >> 21 & 4u) | (hi >> 28 & 8u);
}

// The live flags of lanes [i0, i0 + ITEMS) as a mask (bit k: lane i0 + k);
// lanes at or past n are dead.
__device__ __forceinline__ unsigned live_mask(const uint8_t* live, int i0,
                                              int n, bool aligned) {
  if (aligned && i0 + ITEMS <= n) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(live + i0));
    return nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 |
           nonzero_bytes(w.z) << 8 | nonzero_bytes(w.w) << 12;
  }
  unsigned m = 0u;
  for (int k = 0; k < ITEMS && i0 + k < n; ++k)
    if (live[i0 + k]) m |= 1u << k;
  return m;
}

// Called by one whole warp: the sum of the counts of chain positions
// 0..v-1, read back from v-1 a window of 32 at a time until a position
// holding its inclusive count (FLAG_P); a window with a position not yet
// published is read again.
__device__ __forceinline__ unsigned look_back(const unsigned* chain, int v) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0u;
  for (int j = v - 1; j >= 0;) {
    const int k = j - lane;
    const unsigned w =
        k >= 0 ? *reinterpret_cast<const volatile unsigned*>(chain + k)
               : FLAG_P;  // before position 0: a count of 0
    if (__any_sync(0xffffffffu, w == 0u)) continue;
    const unsigned p = __ballot_sync(0xffffffffu, (w & FLAG_P) != 0u);
    unsigned c = p == 0u || lane < __ffs(p) ? (w & COUNT_MASK) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    excl += c;
    if (p != 0u) break;
    j -= 32;
  }
  return excl;
}

// Stage the lanes of tile t that are live (want_live) or dead, in lane
// order, and write them to order[base..]. m: this thread's mask; ex, cnt:
// the block's exclusive scan and total of those lanes' counts.
__device__ __forceinline__ void place(int t, int n, unsigned m, bool want_live,
                                      int ex, int cnt, int base,
                                      int32_t* ids, int32_t* order) {
  const int first = threadIdx.x * ITEMS;
  const int t0 = t * TILE;
  const int tn = min(TILE, n - t0);
  const unsigned mine = want_live ? m : ~m & 0xffffu;
  for (int k = 0; k < ITEMS && first + k < tn; ++k)
    if (mine >> k & 1u)
      ids[ex + __popc(mine & ((1u << k) - 1u))] = t0 + first + k;
  __syncthreads();
  for (int j = threadIdx.x; j < cnt; j += BLOCK) order[base + j] = ids[j];
  __syncthreads();  // ids is reused
}

__global__ void __launch_bounds__(BLOCK)
    k1_partition(const uint8_t* __restrict__ live, int n, int aligned,
                 unsigned* ws, int32_t* __restrict__ order) {
  __shared__ int32_t ids[TILE];
  __shared__ int smem[BLOCK / 32];
  __shared__ int s_v;
  __shared__ unsigned s_live_before, s_dead_after;
  const int T = gridDim.x;
  const int tid = threadIdx.x;
  const int first = tid * ITEMS;
  if (T == 1) {  // one block: the live lanes, then the dead ones
    const unsigned m = live_mask(live, first, n, aligned);
    int n_live;
    const int ex = block_exclusive_sum<BLOCK>(__popc(m), smem, &n_live);
    for (int k = 0; k < ITEMS && first + k < n; ++k) {
      const int rank = ex + __popc(m & ((1u << k) - 1u));  // live before
      ids[(m >> k & 1u) ? rank : n_live + first + k - rank] = first + k;
    }
    __syncthreads();
    for (int j = tid; j < n; j += BLOCK) order[j] = ids[j];
    return;
  }
  unsigned* fwd = ws + WS_CHAINS;  // live counts, tile v at position v
  unsigned* bwd = fwd + T;         // dead counts, tile T-1-v at position v
  if (tid == 0) s_v = static_cast<int>(atomicAdd(ws + WS_NEXT, 1u));
  __syncthreads();
  const int v = s_v;
  const int u = T - 1 - v;  // the tile whose dead lanes this block places
  const unsigned mf = live_mask(live, v * TILE + first, n, aligned);
  const unsigned mb = live_mask(live, u * TILE + first, n, aligned);
  const int un = min(TILE, n - u * TILE);
  const int own_dead = max(0, min(ITEMS, un - first)) - __popc(mb);
  int n_live_v, n_dead_u;
  const int ex_live = block_exclusive_sum<BLOCK>(__popc(mf), smem, &n_live_v);
  const int ex_dead = block_exclusive_sum<BLOCK>(own_dead, smem, &n_dead_u);
  if (tid < 64) {
    // warp 0 runs the live chain, warp 1 the dead chain: each publishes
    // its own count at once, looks back, then publishes the count through
    const bool dead = tid >= 32;
    volatile unsigned* mine = (dead ? bwd : fwd) + v;
    const unsigned own = static_cast<unsigned>(dead ? n_dead_u : n_live_v);
    if ((tid & 31) == 0) *mine = (v == 0 ? FLAG_P : FLAG_A) | own;
    const unsigned prior = look_back(dead ? bwd : fwd, v);
    if ((tid & 31) == 0) {
      *mine = FLAG_P | (prior + own);
      if (dead)
        s_dead_after = prior;
      else
        s_live_before = prior;
    }
  }
  __syncthreads();
  place(v, n, mf, true, ex_live, n_live_v,
        static_cast<int>(s_live_before), ids, order);
  place(u, n, mb, false, ex_dead, n_dead_u,
        n - static_cast<int>(s_dead_after) - n_dead_u, ids, order);
  // the last block to finish zeroes the workspace
  __syncthreads();
  int last = 0;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ws + WS_DONE, 1u) == static_cast<unsigned>(T - 1);
  }
  if (__syncthreads_or(last)) {
    for (int j = tid; j < 2 * T; j += BLOCK) fwd[j] = 0u;
    if (tid == 0) {
      ws[WS_NEXT] = 0u;
      ws[WS_DONE] = 0u;
    }
  }
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Lanes a tile: a call of n lanes takes a workspace of 2 + 2 ceil(n / tile)
// int32 words, zero when first allocated; one tile takes none (ws may be
// null).
SIDDHI_API int k1_tile_lanes() { return TILE; }

// live: uint8[n] (torch.bool storage); order: int32[n]; ws: the workspace.
SIDDHI_API int k1_stable_partition_order(const uint8_t* live, int32_t* order,
                                         unsigned* ws, int n,
                                         cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n >= static_cast<int>(COUNT_MASK))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = siddhi_blocks(n, TILE);
  if (tiles > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = (reinterpret_cast<uintptr_t>(live) & 15u) == 0u;
  k1_partition<<<tiles, BLOCK, 0, stream>>>(live, n, aligned, ws, order);
  return siddhi_launch_status();
}
