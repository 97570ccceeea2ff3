// K7 merge — the windows' emission order of G pre-sorted lane groups.
//
// Replaces siddhi_tpu/ops/windows.py `_merge_order`: G groups (2 on a
// sliding step: expired candidates then currents; 2 or 3 on a batch
// window: current, reset, expired) of unequal lengths, whose valid lanes
// carry nondecreasing (hi, lo) keys, packed as (hi << 32) | (lo & 0xFFFFFFFF)
// (lo zero-extended). A valid lane's place is its rank among its group's
// valid lanes plus, for every other group h, the count of h's valid keys
// <= its key where h comes earlier in the concatenation and < its key where
// h comes later, which is the stable concatenation order on ties; invalid
// lanes follow every valid lane in concatenation order. The JAX function
// (and the plain version, ops/windows.py `_merge_order_plain`) compacts
// each group with K1, pads the compacted keys with BIG = 2^62, and runs
// K6's binary search of every key into every other group's padded keys;
// this kernel computes the same permutation bit for bit, searching the
// same padded arrays with the same walk.
//
// One launch a call: a cooperative grid of no more blocks than the card
// holds at once (one block, a plain launch, up to SMALL_LANES lanes), tiles
// of 256 threads x 4 lanes, each tile within one group:
//   1. each tile counts its valid lanes;                       grid barrier
//   2. every block sums the tile counts it needs (each group's valid count
//      and its tiles' prefix within their group), then compacts its tiles:
//      a valid lane's packed key and lane id go to its group's compacted
//      arrays (scratch), an invalid lane straight to its place in the
//      order (after every valid lane and the invalid lanes before it);
//                                                              grid barrier
//   3. each block stages the top LEVELS levels of every group's search in
//      shared memory, then every compacted key searches the other groups
//      (a thread walks 4 keys at once) and writes its lane to its place.
// Nothing is read back to the host; the workspace (the barrier's counter
// and a done counter) is zero on entry and the last block zeroes it.
//
// Bound on the H100: bytes, hi, lo and valid read once and the order
// written once (13 bytes a lane: 262,144 lanes ~3.4 MB, ~1 us at 3.35
// TB/s). The design moves the compacted keys once more (12 bytes a valid
// lane, L2 resident) and each search is ~17 dependent loads, 8 of them from
// shared memory; the two grid barriers and the walks' latency set its time.

#include "common.cuh"

namespace {

constexpr int MAXG = 4;
constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int TILE = BLOCK * ITEMS;  // lanes a tile (phases 1 and 2)
constexpr int CHUNK = BLOCK * ITEMS;  // keys a block's pass of phase 3
constexpr int LEVELS = 8;             // search steps from shared memory
constexpr int SMALL_LANES = 4 * TILE;
constexpr long long BIG = 1LL << 62;
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_WORDS = 2;

struct Args {
  const void* hi[MAXG];
  const void* lo[MAXG];
  const uint8_t* valid[MAXG];
  int hi8[MAXG];  // 1: int64 words, 0: int32
  int lo8[MAXG];
  int len[MAXG];
  int off[MAXG];         // the group's first lane in the concatenation
  int tile0[MAXG + 1];   // the group's first tile; tile0[G] = tiles
  int G;
  int total;
  int* tile_cnt;   // scratch [tiles]
  long long* ck;   // scratch [total]: group g's compacted keys at off[g]
  int32_t* og;     // scratch [total]: their lanes within the group
  int32_t* order;  // out [total]
  unsigned* ws;
};

__device__ __forceinline__ long long key_at(const Args& a, int g, int i) {
  const unsigned long long hi =
      a.hi8[g] ? static_cast<unsigned long long>(
                     static_cast<const long long*>(a.hi[g])[i])
               : static_cast<unsigned long long>(static_cast<long long>(
                     static_cast<const int*>(a.hi[g])[i]));
  const unsigned lo =
      a.lo8[g] ? static_cast<unsigned>(static_cast<const long long*>(a.lo[g])[i])
               : static_cast<unsigned>(static_cast<const int*>(a.lo[g])[i]);
  return static_cast<long long>((hi << 32) | lo);
}

__device__ __forceinline__ int group_of_tile(const Args& a, int t) {
  int g = 0;
  while (g + 1 < a.G && t >= a.tile0[g + 1]) ++g;
  return g;
}

__device__ __forceinline__ void barrier(const Args& a, unsigned& phase) {
  if (gridDim.x == 1)
    __syncthreads();
  else
    siddhi_grid_sync(a.ws + WS_BAR, phase);
}

// The block's sum of one int a thread (every thread gets it).
__device__ __forceinline__ int block_sum(int v, int* smem) {
  int total;
  block_exclusive_sum<BLOCK>(v, smem, &total);
  return total;
}

// The valid flags of lanes [i0, i0 + ITEMS) of group g as a mask.
__device__ __forceinline__ unsigned valid_mask(const Args& a, int g, int i0) {
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (i0 + k < a.len[g] && a.valid[g][i0 + k]) m |= 1u << k;
  return m;
}

__global__ void __launch_bounds__(BLOCK) k7_merge(Args a) {
  __shared__ int smem[BLOCK / 32];
  __shared__ long long top[MAXG][1 << LEVELS];
  const int tid = threadIdx.x;
  const int tiles = a.tile0[a.G];
  unsigned phase = 0u;

  // 1. valid lanes a tile
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int g = group_of_tile(a, t);
    const int i0 = (t - a.tile0[g]) * TILE + tid * ITEMS;
    const int c = block_sum(__popc(valid_mask(a, g, i0)), smem);
    if (tid == 0) a.tile_cnt[t] = c;
  }
  barrier(a, phase);

  // 2. each group's valid count, then the compaction
  int nv[MAXG];
  {
    int part[MAXG] = {0, 0, 0, 0};
    for (int j = tid; j < tiles; j += BLOCK) {
      const int c = __ldcg(a.tile_cnt + j);
      const int g = group_of_tile(a, j);
#pragma unroll
      for (int h = 0; h < MAXG; ++h) part[h] += h == g ? c : 0;
    }
#pragma unroll
    for (int h = 0; h < MAXG; ++h)
      nv[h] = h < a.G ? block_sum(part[h], smem) : 0;
  }
  int total_valid = 0;
  for (int h = 0; h < a.G; ++h) total_valid += nv[h];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int g = group_of_tile(a, t);
    int before = 0;  // valid lanes of g in its tiles before t
    for (int j = a.tile0[g] + tid; j < t; j += BLOCK)
      before += __ldcg(a.tile_cnt + j);
    const int pre = block_sum(before, smem);
    int inv_base = total_valid;  // invalid lanes of the groups before g
    for (int h = 0; h < g; ++h) inv_base += a.len[h] - nv[h];
    const int i0 = (t - a.tile0[g]) * TILE + tid * ITEMS;
    const unsigned m = valid_mask(a, g, i0);
    int tile_valid;
    const int ex = block_exclusive_sum<BLOCK>(__popc(m), smem, &tile_valid);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = i0 + k;
      if (i >= a.len[g]) break;
      const int vb = pre + ex + __popc(m & ((1u << k) - 1u));
      if (m >> k & 1u) {
        a.ck[a.off[g] + vb] = key_at(a, g, i);
        a.og[a.off[g] + vb] = i;
      } else {
        a.order[inv_base + (i - vb)] = a.off[g] + i;
      }
    }
  }
  barrier(a, phase);

  // 3. the searches. top[h][m] = group h's padded key at min(m << sh, N) - 1
  int bits[MAXG], tl[MAXG];
#pragma unroll
  for (int h = 0; h < MAXG; ++h) {
    const int n = h < a.G ? a.len[h] : 0;
    bits[h] = n > 0 ? 32 - __clz(n) : 0;
    tl[h] = bits[h] < LEVELS ? bits[h] : LEVELS;
  }
  for (int h = 0; h < a.G; ++h) {
    const int n = a.len[h], sh = bits[h] - tl[h];
    for (int m = tid + 1; m < (1 << tl[h]); m += BLOCK) {
      const long long c = static_cast<long long>(m) << sh;
      const int j = static_cast<int>((c < n ? c : n) - 1);
      top[h][m] = j < nv[h] ? a.ck[a.off[h] + j] : BIG;
    }
  }
  __syncthreads();
  int chunks = 0;
  for (int g = 0; g < a.G; ++g) chunks += (nv[g] + CHUNK - 1) / CHUNK;
  for (int q = blockIdx.x; q < chunks; q += gridDim.x) {
    int g = 0, c = q;
    while (c >= (nv[g] + CHUNK - 1) / CHUNK) {
      c -= (nv[g] + CHUNK - 1) / CHUNK;
      ++g;
    }
    long long key[ITEMS];
    int rank[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      rank[k] = c * CHUNK + k * BLOCK + tid;  // the key's rank in g
      key[k] = rank[k] < nv[g] ? a.ck[a.off[g] + rank[k]] : 0;
    }
    int base[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) base[k] = rank[k];
    for (int h = 0; h < a.G; ++h) {
      if (h == g) continue;
      const bool right = h < g;  // earlier groups count equal keys too
      const int n = a.len[h], sh = bits[h] - tl[h];
      int pos[ITEMS] = {0, 0, 0, 0};
      for (int s = 0; s < bits[h]; ++s) {
        const int step = 1 << (bits[h] - 1 - s);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int cand = pos[k] + step;
          long long probe;
          if (s < tl[h]) {
            probe = top[h][cand >> sh];
          } else {
            const int j = (cand < n ? cand : n) - 1;
            probe = j < nv[h] ? a.ck[a.off[h] + j] : BIG;
          }
          const bool ok = right ? probe <= key[k] : probe < key[k];
          if (cand <= n && ok) pos[k] = cand;
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) base[k] += pos[k];
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (rank[k] < nv[g])
        a.order[base[k]] = a.off[g] + a.og[a.off[g] + rank[k]];
  }

  // the last block out zeroes the barrier's counter and the done counter
  if (gridDim.x > 1) siddhi_grid_last(a.ws + WS_BAR, a.ws + WS_DONE);
}

int capacity() {
  static int cap = -1;
  if (cap < 0) {
    const int c = siddhi_coop_capacity(k7_merge, BLOCK);
    if (c <= 0) return 0;
    cap = c;
  }
  return cap;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k7_merge_max_groups() { return MAXG; }

// Blocks the cooperative grid takes at most (the card holds them at once);
// more tiles than this and a block walks several.
SIDDHI_API int k7_merge_grid_capacity() { return capacity(); }

// Lanes a tile: each group's lanes cut into ceil(len / tile) tiles.
SIDDHI_API int k7_merge_tile_lanes() { return TILE; }

// Bytes of the workspace: zero when first allocated, zero after every call.
SIDDHI_API int k7_merge_workspace_bytes() { return WS_WORDS * 4; }

// spec: host int64[2 + 5 G]: G, total, then per group its hi pointer, lo
// pointer, valid pointer (uint8[len]), hi and lo word sizes (4 or 8) packed
// as hi_bytes * 16 + lo_bytes, and len. scratch: int32[tiles], then
// int64[total] (8-byte aligned), then int32[total]. order: int32[total].
// ws: the workspace (may be null when total <= the one-block limit).
SIDDHI_API int k7_merge_order(const long long* spec, int32_t* order,
                              void* scratch, unsigned* ws,
                              cudaStream_t stream) {
  Args a{};
  a.G = static_cast<int>(spec[0]);
  a.total = static_cast<int>(spec[1]);
  if (a.G < 1 || a.G > MAXG || a.total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.total == 0) return 0;
  int off = 0, tiles = 0;
  for (int g = 0; g < a.G; ++g) {
    const long long* s = spec + 2 + 5 * g;
    a.hi[g] = reinterpret_cast<const void*>(s[0]);
    a.lo[g] = reinterpret_cast<const void*>(s[1]);
    a.valid[g] = reinterpret_cast<const uint8_t*>(s[2]);
    a.hi8[g] = (s[3] >> 4) == 8;
    a.lo8[g] = (s[3] & 15) == 8;
    a.len[g] = static_cast<int>(s[4]);
    if (a.len[g] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.off[g] = off;
    a.tile0[g] = tiles;
    off += a.len[g];
    tiles += static_cast<int>(siddhi_blocks(a.len[g], TILE));
  }
  a.tile0[a.G] = tiles;
  if (off != a.total) return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  a.tile_cnt = reinterpret_cast<int*>(s);
  const size_t ck_at = (static_cast<size_t>(tiles) * 4 + 7) / 8 * 8;
  a.ck = reinterpret_cast<long long*>(s + ck_at);
  a.og = reinterpret_cast<int32_t*>(a.ck + a.total);
  a.order = order;
  a.ws = ws;
  if (a.total <= SMALL_LANES) {
    k7_merge<<<1, BLOCK, 0, stream>>>(a);
    return siddhi_launch_status();
  }
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = capacity();
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  const int grid = tiles < cap ? tiles : cap;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k7_merge), dim3(grid), dim3(BLOCK), args,
      0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}

// Bytes of scratch a call of `tiles` tiles and `total` lanes takes.
SIDDHI_API long long k7_merge_scratch_bytes(int tiles, int total) {
  return (static_cast<long long>(tiles) * 4 + 7) / 8 * 8 +
         static_cast<long long>(total) * 12;
}
