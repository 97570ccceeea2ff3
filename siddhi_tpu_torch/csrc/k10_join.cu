// K10 — the stream-stream join's multimap and pair block.
//
// Replaces three functions of siddhi_tpu/ops/join.py:
//   multimap_append  (stage 3: the duplicate-free chained scatters) as
//                    k10_multimap_append — one launch;
//   multimap_probe   as k10_multimap_probe — one thread per probe lane;
//                    where the join compacts its pairs, with
//                    compact_pairs as k10_multimap_probe_compact — one
//                    launch;
//   compact_pairs    as k10_compact_pairs — K1's three-launch compaction
//                    (the sort-merge and cross probes' blocks).
// The multimap indexes a window ring by ring position: heads i32[H] (the
// newest entry per bucket), nexts i32[C] (the next-older entry), slot_hash
// and slot_seq u32[C] (the row's key hash and arrival index mod 2^32).
// Every entry point is bit for bit with the JAX function.
//
// multimap_append: live lane i, the j-th live lane of the batch, lands at
// ring position (appended0 % C + j) wrapped once (B <= C) with tag
// appended0 + j; it links to the previous live lane of its bucket (hash &
// (H - 1)), or, first in the batch, to the bucket's old head; the bucket's
// last live lane becomes its head. Only the order of the lanes within a
// bucket shows in the result. One launch a call, two kernels:
//
// k10_append_parts, up to ATILE = 8,192 lanes (app G's batch): a plain
// launch of up to MAX_PARTS blocks of 1,024 threads, block p taking the
// live lanes whose bucket falls in share p (a multiplicative hash of the
// bucket), so a bucket's lanes meet in one block and no block waits for
// another. Each block reads the whole batch's flags and hashes (8 per
// thread, from L2), ranks the live lanes with a block scan (r = j), stages
// its share's lanes in r order, and links them: up to SMALL_SHARE lanes (a
// uniform batch gives ~60) by one thread a lane scanning the share for the
// nearest earlier lane of its bucket and for a later one; past it (one hot
// key) by sort_pairs and the sorted neighbours. The old heads are read
// before a block barrier and the new ones written after it, so no thread
// reads a head another writes. No workspace.
//
// k10_append, past ATILE lanes: one cooperative launch, tiles of MIN_TILE
// to ATILE lanes, about one a co-resident block (131,072 lanes: 128 tiles
// of 1,024), walked three times:
//   A  each tile stages its live lanes (a block scan gives r) and sorts
//      (hash, r) by bucket in shared memory (sort_pairs: a stable LSD
//      radix sort of at most 8-bit digits over the bits below the highest
//      one that differs, ranked a warp at a time by one ballot a bit and
//      placed by per-warp digit counts; a pass whose bits agree is
//      skipped, so one bucket sorts in no pass); it writes the sorted list
//      and its live count to the scratch and sets bit t of its buckets'
//      tile masks (W = ceil(T / 64) words a bucket, in the workspace);
//   B  (grid barrier) each block scans the tiles' counts (their bases in
//      j); the first lane of a bucket's run links to the last lane of that
//      bucket in the nearest earlier tile (the highest mask bit below t,
//      then a binary search of that tile's sorted list, every lane's
//      search in step), or to the old head; the last lane of a run with no
//      later tile in the mask is the bucket's newest and is flagged in the
//      list; links are staged by r and the ring rows written coalesced;
//   C  (grid barrier) the flagged lanes write the new heads and zero their
//      bucket's mask words.
// The workspace (the library's, per stream: the barrier and done counters
// and the masks) is zero on entry and zero again when the launch ends; the
// scratch (counts and lists) is written before it is read. Nothing is read
// back to the host; appended0 is read on the device.
//
// multimap_probe: walk heads[bucket], then nexts, k_max steps plus one
// truncation probe. An entry is live when 0 < appended - slot_seq <=
// window_len in u32 (wraparound ages), and ages must strictly increase
// along the walk, or it stops: a chain diverted through an overwritten
// slot jumps to a newer row. A hash mismatch keeps walking; a non-match
// writes position 0. Candidates come out reversed, oldest first.
// `truncated` counts lanes whose (k_max+1)-th entry is live (atomicAdd).
//
// multimap_probe_compact: the probe and compact_pairs of its [B, K] block
// in one cooperative launch (one block: a plain launch, which the card
// starts sooner), one thread a lane, tiles of PB = 128 lanes (64 and 256
// timed level with it at app G's shape), at most the co-resident blocks,
// block g taking tiles g, g + G, ...:
//   1. a lane walks its chain once, issuing the three loads of a step
//      (slot_seq, slot_hash, nexts) together and stopping at the chain's
//      end, keeps its up to K matches in registers (K <= KM, a template
//      bound of 4, 16 or 64) and runs the truncation probe; a block scan
//      counts the tile's matches into the workspace, and each block adds
//      its truncated lanes to a workspace word; each block zeroes its
//      share of the pair block (lanes, rows, pv);
//   grid barrier;
//   2. each block sums the tile counts before each of its tiles and in
//      all, and its lanes write their matches oldest first at the tile's
//      offset plus the block scan's (lane, ring position, pv = 1) while
//      below pair_cap; the zeros written in 1 stay past min(total,
//      pair_cap), as compact_pairs leaves them. A block of one tile (the
//      tiles fit the card at once, as at app G) keeps its matches in
//      registers across the barrier; past that a block walks its tiles
//      again (from L2).
// Block 0 writes counts[0..2] = total, max(0, total - pair_cap) and the
// truncated lanes; the block that finishes last zeroes the workspace. Bit
// for bit with multimap_probe followed by compact_pairs.
//
// compact_pairs: order-preserving compaction of P candidate lanes into
// pair_cap: per-block counts, one block scans the block totals (and keeps
// the total on the device), then a stable scatter with warp-shuffle ranks
// that also writes pv = lane < n and zeros lanes n..pair_cap.
//
// Bound on the H100: bytes, all three. append reads 5 bytes a lane and
// writes 3 words a live row plus a head per bucket, and reads the old head
// of each bucket (~0.2 MB at app G's 8,192 lanes: 0.06 us at 3.35 TB/s);
// its time is latency (the blocks' scans and scattered head reads and
// writes; past one tile the sorts and two grid barriers), not bytes. probe
// reads one head and up to k_max + 1 chain entries (12 bytes each) a lane,
// with no locality between steps (a dependent load chain: latency, not
// bandwidth, sets its pace), and writes 5 bytes per candidate; compact
// reads 9 bytes a lane twice and writes 9 bytes per kept lane. The fused
// probe writes 9 bytes a pair slot and none of the [B, K] block: at app
// G's shape its time is the launch, the chain of dependent loads of the
// longest walk (a head, then a step a live entry) and one grid barrier.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int CBLOCK = 1024;
// the fused probe's workspace words: the barrier, the done counter, the
// truncated lanes, then one count a tile
constexpr int WP_TRUNC = 2;
constexpr int WP_TILES = 4;
constexpr int PROBE_MAX_K = 64;
constexpr int PB = 128;  // the fused probe's tile: lanes a block
// multimap_append: a tile of ATILE lanes a block
constexpr int ABLOCK = 1024;
constexpr int ANW = ABLOCK / 32;
constexpr int AITEMS = 8;
constexpr int ATILE = ABLOCK * AITEMS;
// up to ATILE lanes, blocks that each take a share of the buckets; past
// it, tiles of MIN_TILE to ATILE lanes, about one a co-resident block
constexpr int MIN_TILE = ABLOCK;
constexpr int MAX_PARTS = 128;   // bucket shares at most
constexpr int PART_LANES = 64;   // lanes a share, about
constexpr int SMALL_SHARE = 256;  // a share's lanes found by a scan, at most
constexpr int RADIX_BITS = 8;  // bits of a digit, at most
constexpr int R = 1 << RADIX_BITS;
constexpr int SEARCH_STEPS = 14;  // a binary search over ATILE entries
static_assert(ANW * R == ATILE, "the sort's warp counts fill one array");
static_assert((1 << (SEARCH_STEPS - 1)) >= ATILE, "search steps");
constexpr size_t ASMEM = 4ull * ATILE * sizeof(unsigned);
constexpr size_t PSMEM = 3ull * ATILE * sizeof(unsigned);
constexpr unsigned NEWEST = 0x80000000u;  // list value: a bucket's newest
// workspace words: the barrier, the done counter, then the tile masks
// (8-byte words from WS_MASKS on)
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_MASKS = 4;

// Ring position of the j-th live lane; start = appended0 % C, j < C.
__device__ __forceinline__ int ring_pos(int start, int C, int j) {
  const int pos = start + j;
  return pos >= C ? pos - C : pos;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A key row's rank among the equal digits (`width` bits) before it in its
// warp (lane order), with the warp's digit counts in wrow. The equal
// digits come from one ballot a bit (__match_any_sync costs a round per
// distinct value: up to 32 at 8 bits). Dead lanes are never counted.
__device__ __forceinline__ unsigned warp_rank(unsigned* wrow, unsigned d,
                                              bool live, int width) {
  unsigned peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
  for (int b = 0; b < RADIX_BITS; ++b) {
    if (b < width) {
      const bool bit = (d >> b) & 1u;
      const unsigned x = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? x : ~x;
    }
  }
  const unsigned below = peers & lanemask_lt();
  const unsigned before = live ? wrow[d] : 0u;
  __syncwarp();
  if (live && below == 0u) wrow[d] = before + __popc(peers);
  __syncwarp();
  return before + __popc(below);
}

struct Stage {
  unsigned* key;  // [ATILE] hashes: staged in r order, then sorted
  unsigned* val;  // [ATILE] r, moved with the keys
  unsigned* aux;  // [ATILE] the sort's per-warp digit counts, then links
  unsigned* tb;   // [ATILE] the tiles' bases in j
};

// Stages the live lanes of [l0, l1) (at most ATILE) in shared memory in
// lane order, key[r] = hash and val[r] = r for the r-th; returns their
// count.
__device__ int stage_tile(const uint32_t* __restrict__ hashes,
                          const bool* __restrict__ live, int l0, int l1,
                          Stage s, int* scan) {
  const int tid = threadIdx.x;
  // a thread's AITEMS lanes, hashes and flags read together
  const int i0 = l0 + tid * AITEMS;
  unsigned hv[AITEMS];
  unsigned lv = 0u;
#pragma unroll
  for (int q = 0; q < AITEMS; ++q) {
    hv[q] = 0u;
    if (i0 + q < l1) {
      hv[q] = hashes[i0 + q];
      if (live[i0 + q]) lv |= 1u << q;
    }
  }
  int n;
  int r = block_exclusive_sum<ABLOCK>(__popc(lv), scan, &n);
#pragma unroll
  for (int q = 0; q < AITEMS; ++q)
    if (lv >> q & 1u) {
      s.key[r] = hv[q];
      s.val[r] = static_cast<unsigned>(r);
      ++r;
    }
  __syncthreads();
  return n;
}

// Sorts the n pairs (key[], val[]) in shared memory stably by key & kmask;
// wcnt ([ANW][R]) is scratch. Only the bits below the highest one that
// differs run, in passes of at most RADIX_BITS; a pass whose bits are all
// the same is skipped, so one key sorts in no pass.
__device__ void sort_pairs(unsigned* key, unsigned* val, unsigned* wcnt,
                           int n, unsigned kmask, int* scan, unsigned* bits) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    bits[0] = 0u;   // OR of the keys
    bits[1] = ~0u;  // AND of the keys
  }
  __syncthreads();
  // a warp's rows: elements row0 + 32 i, in element order
  const int row0 = warp * (32 * AITEMS) + lane;
  unsigned k[AITEMS], v[AITEMS];
  unsigned o = 0u, a = ~0u;
#pragma unroll
  for (int i = 0; i < AITEMS; ++i) {
    const int e = row0 + i * 32;
    k[i] = e < n ? key[e] : 0u;
    v[i] = e < n ? val[e] : 0u;
    if (e < n) {
      o |= k[i] & kmask;
      a &= k[i] & kmask;
    }
  }
  o = __reduce_or_sync(0xffffffffu, o);
  a = __reduce_and_sync(0xffffffffu, a);
  if (lane == 0) {
    atomicOr(bits, o);
    atomicAnd(bits + 1, a);
  }
  __syncthreads();
  const unsigned differ = n ? (bits[0] ^ bits[1]) & kmask : 0u;
  const int top = 32 - __clz(static_cast<int>(differ));
  const int passes = (top + RADIX_BITS - 1) / RADIX_BITS;
  const int width = passes ? (top + passes - 1) / passes : 0;
  const unsigned dmask = (1u << width) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * width;
    if (((differ >> shift) & dmask) == 0u) continue;
    for (int j = lane; j <= static_cast<int>(dmask); j += 32)
      wcnt[warp * R + j] = 0u;
    __syncwarp();
    unsigned rk[AITEMS];
#pragma unroll
    for (int i = 0; i < AITEMS; ++i)
      rk[i] = warp_rank(wcnt + warp * R, ((k[i] & kmask) >> shift) & dmask,
                        row0 + i * 32 < n, width);
    __syncthreads();
    // digit d's base, then each warp's offset inside the digit
    const bool digit = tid <= static_cast<int>(dmask);
    int tot = 0;
    if (digit)
      for (int w = 0; w < ANW; ++w) tot += static_cast<int>(wcnt[w * R + tid]);
    int all;
    const int base = block_exclusive_sum<ABLOCK>(tot, scan, &all);
    if (digit) {
      unsigned acc = static_cast<unsigned>(base);
      for (int w = 0; w < ANW; ++w) {
        const unsigned c = wcnt[w * R + tid];
        wcnt[w * R + tid] = acc;
        acc += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      if (row0 + i * 32 >= n) continue;
      const unsigned d = ((k[i] & kmask) >> shift) & dmask;
      const unsigned at = wcnt[warp * R + d] + rk[i];
      key[at] = k[i];
      val[at] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      const int e = row0 + i * 32;
      if (e < n) {
        k[i] = key[e];
        v[i] = val[e];
      }
    }
  }
  __syncthreads();
}

// Bucket share of a bucket among 2^pbits.
__device__ __forceinline__ unsigned share_of(unsigned b, int pbits) {
  return pbits ? (b * 0x9E3779B1u) >> (32 - pbits) : 0u;
}

// Up to ATILE lanes: block p takes the live lanes whose bucket falls in
// share p, so a bucket's lanes meet in one block and no block waits for
// another. Every block reads the whole batch's flags and hashes (L2) and
// ranks the live lanes (r = j), stages its own in r order, and links
// them: up to SMALL_SHARE by a scan of the share (the nearest earlier lane
// of the bucket, and whether a later one exists), past it by sort_pairs
// and the sorted neighbours. Old heads are read before a block barrier
// and new ones written after it; rows are written where they land.
__global__ void __launch_bounds__(ABLOCK)
    k10_append_parts(const uint32_t* __restrict__ hashes,
                     const bool* __restrict__ live, int B, int H, int C,
                     const int64_t* __restrict__ appended0,
                     int32_t* __restrict__ heads, int32_t* __restrict__ nexts,
                     uint32_t* __restrict__ slot_hash,
                     uint32_t* __restrict__ slot_seq, int pbits) {
  extern __shared__ __align__(16) unsigned stage_raw[];
  __shared__ int scan[ANW];
  __shared__ unsigned bits[2];
  unsigned* key = stage_raw;          // the share's hashes, r order
  unsigned* val = key + ATILE;        // their r
  unsigned* wcnt = val + ATILE;       // the sort's digit counts
  const long long a0 = appended0[0];
  const int start = static_cast<int>(a0 % C);
  const unsigned seq0 = static_cast<unsigned>(a0);
  const unsigned bmask = static_cast<unsigned>(H - 1);
  const unsigned p = blockIdx.x;
  const int tid = threadIdx.x;
  const int i0 = tid * AITEMS;
  unsigned hv[AITEMS];
  unsigned lv = 0u, mine = 0u;
#pragma unroll
  for (int q = 0; q < AITEMS; ++q) {
    hv[q] = 0u;
    if (i0 + q < B) {
      hv[q] = hashes[i0 + q];
      if (live[i0 + q]) {
        lv |= 1u << q;
        if (share_of(hv[q] & bmask, pbits) == p) mine |= 1u << q;
      }
    }
  }
  int n, m;
  int r = block_exclusive_sum<ABLOCK>(__popc(lv), scan, &n);
  int e = block_exclusive_sum<ABLOCK>(__popc(mine), scan, &m);
#pragma unroll
  for (int q = 0; q < AITEMS; ++q) {
    if (!(lv >> q & 1u)) continue;
    if (mine >> q & 1u) {
      key[e] = hv[q];
      val[e] = static_cast<unsigned>(r);
      ++e;
    }
    ++r;
  }
  __syncthreads();
  if (m == 0) return;
  int newest[AITEMS];  // ring position of a bucket's last lane, or -1
  unsigned nb[AITEMS];
  if (m <= SMALL_SHARE) {
    newest[0] = -1;
    nb[0] = 0u;
    if (tid < m) {
      const unsigned b = key[tid] & bmask;
      const int rr = static_cast<int>(val[tid]);
      int pred = -1;
      bool later = false;
      for (int x = 0; x < m; ++x) {
        if ((key[x] & bmask) != b) continue;
        const int rx = static_cast<int>(val[x]);
        if (rx < rr) pred = max(pred, rx);
        later |= rx > rr;
      }
      const int pos = ring_pos(start, C, rr);
      nexts[pos] = pred >= 0 ? ring_pos(start, C, pred) : heads[b];
      slot_hash[pos] = key[tid];
      slot_seq[pos] = seq0 + static_cast<unsigned>(rr);
      nb[0] = b;
      if (!later) newest[0] = pos;
    }
    __syncthreads();  // every old head is read
    if (newest[0] >= 0) heads[nb[0]] = newest[0];
    return;
  }
  sort_pairs(key, val, wcnt, m, bmask, scan, bits);
  int link[AITEMS], pos[AITEMS];
#pragma unroll
  for (int i = 0; i < AITEMS; ++i) {
    const int k = tid + i * ABLOCK;
    link[i] = newest[i] = pos[i] = -1;
    nb[i] = 0u;
    if (k >= m) continue;
    nb[i] = key[k] & bmask;
    pos[i] = ring_pos(start, C, static_cast<int>(val[k]));
    if (k > 0 && (key[k - 1] & bmask) == nb[i])
      link[i] = ring_pos(start, C, static_cast<int>(val[k - 1]));
    if (k == m - 1 || (key[k + 1] & bmask) != nb[i]) newest[i] = pos[i];
  }
#pragma unroll
  for (int i = 0; i < AITEMS; ++i) {
    const int k = tid + i * ABLOCK;
    if (k >= m) continue;
    if (link[i] < 0) link[i] = heads[nb[i]];  // the old heads, together
    nexts[pos[i]] = link[i];
    slot_hash[pos[i]] = key[k];
    slot_seq[pos[i]] = seq0 + val[k];
  }
  __syncthreads();  // every old head is read
#pragma unroll
  for (int i = 0; i < AITEMS; ++i)
    if (newest[i] >= 0) heads[nb[i]] = newest[i];
}

// The highest tile below t and whether a tile above t has its bit set in
// a bucket's mask of W words; x0 is the mask's word of t, read already.
__device__ __forceinline__ int tile_before(const unsigned long long* m,
                                           unsigned long long x0, int t) {
  unsigned long long x = x0 & ((1ull << (t & 63)) - 1ull);
  for (int w = t >> 6;;) {
    if (x) return w * 64 + 63 - __clzll(static_cast<long long>(x));
    if (--w < 0) return -1;
    x = __ldcg(m + w);
  }
}

__device__ __forceinline__ bool tile_after(const unsigned long long* m,
                                           unsigned long long x0, int t,
                                           int W) {
  if (x0 & ~((2ull << (t & 63)) - 1ull)) return true;
  for (int w = (t >> 6) + 1; w < W; ++w)
    if (__ldcg(m + w)) return true;
  return false;
}

// The append past ATILE lanes (see the file's comment), a cooperative
// grid. Scratch: the tiles' live counts [tpad], then their sorted hashes
// and values [T][tile] each. A thread's elements of a tile are k = tid +
// i * ABLOCK; their loads are issued together.
__global__ void __launch_bounds__(ABLOCK)
    k10_append(const uint32_t* __restrict__ hashes,
               const bool* __restrict__ live, int B, int H, int C,
               const int64_t* __restrict__ appended0,
               int32_t* __restrict__ heads, int32_t* __restrict__ nexts,
               uint32_t* __restrict__ slot_hash,
               uint32_t* __restrict__ slot_seq, unsigned* ws,
               uint32_t* scratch, int tile, int tpad) {
  extern __shared__ __align__(16) unsigned stage_raw[];
  __shared__ int scan[ANW];
  __shared__ unsigned bits[2];
  const Stage s{stage_raw, stage_raw + ATILE, stage_raw + 2 * ATILE,
                stage_raw + 3 * ATILE};
  const long long a0 = appended0[0];
  const int start = static_cast<int>(a0 % C);
  const unsigned seq0 = static_cast<unsigned>(a0);
  const unsigned bmask = static_cast<unsigned>(H - 1);
  const int T = (B + tile - 1) / tile;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int W = (T + 63) / 64;
  uint32_t* cnt = scratch;
  uint32_t* lkey = scratch + tpad;
  uint32_t* lval = lkey + static_cast<size_t>(T) * tile;
  unsigned long long* masks =
      reinterpret_cast<unsigned long long*>(ws + WS_MASKS);
  unsigned phase = 0;
  // A: sort each tile, publish its list and count, mark its buckets
  for (int t = blockIdx.x; t < T; t += G) {
    const int l0 = t * tile;
    const int n = stage_tile(hashes, live, l0, min(B, l0 + tile), s, scan);
    sort_pairs(s.key, s.val, s.aux, n, bmask, scan, bits);
    uint32_t* tk = lkey + static_cast<size_t>(t) * tile;
    uint32_t* tv = lval + static_cast<size_t>(t) * tile;
    for (int k = tid; k < n; k += ABLOCK) {
      const unsigned h = s.key[k];
      tk[k] = h;
      tv[k] = s.val[k];
      if (k == 0 || (s.key[k - 1] & bmask) != (h & bmask))
        atomicOr(masks + static_cast<size_t>(h & bmask) * W + (t >> 6),
                 1ull << (t & 63));
    }
    if (tid == 0) cnt[t] = static_cast<uint32_t>(n);
    __syncthreads();  // the stage is reused by the next tile
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  // every tile's base in j
  {
    int carry = 0;
    for (int c = 0; c < T; c += ABLOCK) {
      const int x = c + tid < T ? static_cast<int>(__ldcg(cnt + c + tid)) : 0;
      int tot;
      const int ex = block_exclusive_sum<ABLOCK>(x, scan, &tot);
      if (c + tid < T) s.tb[c + tid] = static_cast<unsigned>(carry + ex);
      carry += tot;
    }
    __syncthreads();
  }
  // B: links (staged by r, written coalesced), rows, the newest flags
  for (int t = blockIdx.x; t < T; t += G) {
    const int n = static_cast<int>(__ldcg(cnt + t));
    const int base = static_cast<int>(s.tb[t]);
    uint32_t* tv = lval + static_cast<size_t>(t) * tile;
    for (int k = tid; k < n; k += ABLOCK) {
      s.key[k] = __ldcg(lkey + static_cast<size_t>(t) * tile + k);
      s.val[k] = __ldcg(tv + k);
    }
    __syncthreads();
    unsigned b[AITEMS];
    int link[AITEMS];  // ring position of the previous row, or -1
    int tp[AITEMS];    // the tile holding it, when it is in another
    bool first[AITEMS], last[AITEMS];
    unsigned long long x0[AITEMS];
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      const int k = tid + i * ABLOCK;
      b[i] = 0u;
      link[i] = tp[i] = -1;
      first[i] = last[i] = false;
      if (k >= n) continue;
      b[i] = s.key[k] & bmask;
      first[i] = k == 0 || (s.key[k - 1] & bmask) != b[i];
      last[i] = k == n - 1 || (s.key[k + 1] & bmask) != b[i];
      if (!first[i])
        link[i] = ring_pos(start, C,
                           base + static_cast<int>(s.val[k - 1]));
    }
#pragma unroll
    for (int i = 0; i < AITEMS; ++i)  // the masks' words of t, together
      x0[i] = first[i] || last[i]
                  ? __ldcg(masks + static_cast<size_t>(b[i]) * W + (t >> 6))
                  : 0ull;
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      const unsigned long long* m = masks + static_cast<size_t>(b[i]) * W;
      if (first[i]) tp[i] = tile_before(m, x0[i], t);
      if (last[i]) last[i] = !tile_after(m, x0[i], t, W);
    }
    // the last entry of the bucket in tile tp: binary searches in step
    int lo[AITEMS], len[AITEMS];
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      lo[i] = 0;
      len[i] = tp[i] >= 0 ? static_cast<int>(__ldcg(cnt + tp[i])) : 0;
    }
    for (int step = 0; step < SEARCH_STEPS; ++step) {
#pragma unroll
      for (int i = 0; i < AITEMS; ++i) {
        if (len[i] <= 0) continue;
        const int half = len[i] >> 1;
        const unsigned y = __ldcg(lkey + static_cast<size_t>(tp[i]) * tile +
                                  lo[i] + half);
        if ((y & bmask) <= b[i]) {
          lo[i] += half + 1;
          len[i] -= half + 1;
        } else {
          len[i] = half;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      if (tp[i] >= 0)
        link[i] = ring_pos(
            start, C,
            static_cast<int>(s.tb[tp[i]]) +
                static_cast<int>(__ldcg(lval + static_cast<size_t>(tp[i]) *
                                                   tile + lo[i] - 1) &
                                 ~NEWEST));
      else if (first[i])
        link[i] = heads[b[i]];
    }
    unsigned r[AITEMS], h[AITEMS];
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      const int k = tid + i * ABLOCK;
      r[i] = k < n ? s.val[k] : 0u;
      h[i] = k < n ? s.key[k] : 0u;
      if (k < n && last[i]) tv[k] = r[i] | NEWEST;
    }
    __syncthreads();  // the sorted stage is read
#pragma unroll
    for (int i = 0; i < AITEMS; ++i)
      if (tid + i * ABLOCK < n) {
        s.key[r[i]] = h[i];
        s.aux[r[i]] = static_cast<unsigned>(link[i]);
      }
    __syncthreads();
    for (int j = tid; j < n; j += ABLOCK) {
      const int pos = ring_pos(start, C, base + j);
      nexts[pos] = static_cast<int32_t>(s.aux[j]);
      slot_hash[pos] = s.key[j];
      slot_seq[pos] = seq0 + static_cast<unsigned>(base + j);
    }
    __syncthreads();
  }
  siddhi_grid_sync(ws + WS_BAR, phase);  // every old head and mask is read
  // C: the new heads; the masks are zeroed for the next launch
  for (int t = blockIdx.x; t < T; t += G) {
    const int n = static_cast<int>(__ldcg(cnt + t));
    const int base = static_cast<int>(s.tb[t]);
    const uint32_t* tk = lkey + static_cast<size_t>(t) * tile;
    const uint32_t* tv = lval + static_cast<size_t>(t) * tile;
    unsigned v[AITEMS];
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      const int k = tid + i * ABLOCK;
      v[i] = k < n ? __ldcg(tv + k) : 0u;
    }
#pragma unroll
    for (int i = 0; i < AITEMS; ++i) {
      if (!(v[i] & NEWEST)) continue;
      const unsigned b = __ldcg(tk + tid + i * ABLOCK) & bmask;
      heads[b] = ring_pos(start, C, base + static_cast<int>(v[i] & ~NEWEST));
      for (int w = 0; w < W; ++w) masks[static_cast<size_t>(b) * W + w] = 0ull;
    }
  }
  siddhi_grid_last(ws + WS_BAR, ws + WS_DONE);
}

__global__ void probe(const uint32_t* __restrict__ probe_hash,
                      const uint8_t* __restrict__ probe_valid, int B, int K,
                      int H, const int32_t* __restrict__ heads,
                      const int32_t* __restrict__ nexts,
                      const uint32_t* __restrict__ slot_hash,
                      const uint32_t* __restrict__ slot_seq,
                      const int64_t* __restrict__ appended,
                      const int64_t* __restrict__ window_len,
                      int32_t* __restrict__ cand_pos,
                      uint8_t* __restrict__ cand_ok,
                      int* __restrict__ truncated) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= B) return;
  const uint32_t app = static_cast<uint32_t>(appended[0]);
  const uint32_t wlen = static_cast<uint32_t>(window_len[0]);
  const uint32_t ph = probe_hash[i];
  bool alive = probe_valid[i] != 0;
  int pos = alive ? heads[ph & static_cast<uint32_t>(H - 1)] : -1;
  uint32_t prev_age = 0;
  const long long row = static_cast<long long>(i) * K;
  for (int s = 0; s < K; ++s) {
    bool match = false;
    int p = 0;
    if (alive && pos >= 0) {
      p = pos;
      const uint32_t age = app - slot_seq[p];
      alive = age > prev_age && age <= wlen;
      match = alive && slot_hash[p] == ph;
      prev_age = age;
      pos = nexts[p];
    } else {
      alive = false;
    }
    cand_pos[row + (K - 1 - s)] = match ? p : 0;
    cand_ok[row + (K - 1 - s)] = match;
  }
  if (alive && pos >= 0) {
    const uint32_t age = app - slot_seq[pos];
    if (age > prev_age && age <= wlen) atomicAdd(truncated, 1);
  }
}

// Zero p[from, to) of 4-byte elements, 16 bytes a store where aligned
// (p itself 16-byte aligned), by the whole block.
__device__ __forceinline__ void zero_words(int32_t* p, int from, int to) {
  const int a = min(to, (from + 3) & ~3);
  const int b = max(a, to & ~3);
  for (int j = from + threadIdx.x; j < a; j += blockDim.x) p[j] = 0;
  for (int j = a / 4 + threadIdx.x; j < b / 4; j += blockDim.x)
    reinterpret_cast<int4*>(p)[j] = make_int4(0, 0, 0, 0);
  for (int j = b + threadIdx.x; j < to; j += blockDim.x) p[j] = 0;
}

// The same for bytes, 16 a store.
__device__ __forceinline__ void zero_bytes(uint8_t* p, int from, int to) {
  const int a = min(to, (from + 15) & ~15);
  const int b = max(a, to & ~15);
  for (int j = from + threadIdx.x; j < a; j += blockDim.x) p[j] = 0;
  for (int j = a / 16 + threadIdx.x; j < b / 16; j += blockDim.x)
    reinterpret_cast<uint4*>(p)[j] = make_uint4(0u, 0u, 0u, 0u);
  for (int j = b + threadIdx.x; j < to; j += blockDim.x) p[j] = 0;
}

// Lane i's walk (i < B): its matches' ring positions by step in m (-1
// where the step matched nothing), their count, and whether its chain
// still had a live entry after K steps.
template <int KM>
__device__ __forceinline__ void walk(
    int i, const uint32_t* __restrict__ probe_hash,
    const uint8_t* __restrict__ probe_valid, int B, int K, int H,
    const int32_t* __restrict__ heads, const int32_t* __restrict__ nexts,
    const uint32_t* __restrict__ slot_hash,
    const uint32_t* __restrict__ slot_seq, uint32_t app, uint32_t wlen,
    int (&m)[KM], int& cnt, int& trunc) {
#pragma unroll
  for (int s = 0; s < KM; ++s) m[s] = -1;
  cnt = 0;
  trunc = 0;
  if (i >= B || !probe_valid[i]) return;
  const uint32_t ph = probe_hash[i];
  int pos = heads[ph & static_cast<uint32_t>(H - 1)];
  uint32_t prev_age = 0;
  bool walking = true;
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    if (s >= K) break;
    if (pos < 0) {
      walking = false;
      break;
    }
    const uint32_t seq = slot_seq[pos];
    const uint32_t h = slot_hash[pos];
    const int nx = nexts[pos];
    const uint32_t age = app - seq;
    if (!(age > prev_age && age <= wlen)) {
      walking = false;
      break;
    }
    if (h == ph) {
      m[s] = pos;
      ++cnt;
    }
    prev_age = age;
    pos = nx;
  }
  if (walking && pos >= 0) {
    const uint32_t age = app - slot_seq[pos];
    trunc = age > prev_age && age <= wlen;
  }
}

// The sum of `cnt[j]` over j in [j0, j1), by the whole block.
__device__ __forceinline__ int block_sum(const unsigned* cnt, int j0, int j1,
                                         int* smem) {
  int s = 0;
  for (int j = j0 + threadIdx.x; j < j1; j += PB)
    s += static_cast<int>(__ldcg(cnt + j));
  int total;
  block_exclusive_sum<PB>(s, smem, &total);
  return total;
}

template <int KM>
__global__ void __launch_bounds__(PB)
    probe_compact(const uint32_t* __restrict__ probe_hash,
                  const uint8_t* __restrict__ probe_valid, int B, int K,
                  int H, const int32_t* __restrict__ heads,
                  const int32_t* __restrict__ nexts,
                  const uint32_t* __restrict__ slot_hash,
                  const uint32_t* __restrict__ slot_seq,
                  const int64_t* __restrict__ appended,
                  const int64_t* __restrict__ window_len, int cap,
                  int32_t* __restrict__ lane_out,
                  int32_t* __restrict__ row_out,
                  uint8_t* __restrict__ pv_out, int* __restrict__ counts,
                  unsigned* ws) {
  __shared__ int smem[PB / 32];
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const int T = (B + PB - 1) / PB;
  const uint32_t app = static_cast<uint32_t>(appended[0]);
  const uint32_t wlen = static_cast<uint32_t>(window_len[0]);
  unsigned* tiles = ws + WP_TILES;
  int m[KM];
  int cnt, trunc, n_trunc = 0;
  for (int t = g; t < T; t += G) {
    walk<KM>(t * PB + threadIdx.x, probe_hash, probe_valid, B, K, H, heads,
             nexts, slot_hash, slot_seq, app, wlen, m, cnt, trunc);
    int n_tile, t_tile;
    block_exclusive_sum<PB>(cnt, smem, &n_tile);
    block_exclusive_sum<PB>(trunc, smem, &t_tile);
    if (threadIdx.x == 0) tiles[t] = static_cast<unsigned>(n_tile);
    n_trunc += t_tile;
  }
  if (threadIdx.x == 0 && n_trunc)
    atomicAdd(ws + WP_TRUNC, static_cast<unsigned>(n_trunc));
  {  // this block's share of the pair block, zeroed
    const int z0 = static_cast<int>(static_cast<long long>(cap) * g / G);
    const int z1 = static_cast<int>(static_cast<long long>(cap) * (g + 1) / G);
    zero_words(lane_out, z0, z1);
    zero_words(row_out, z0, z1);
    zero_bytes(pv_out, z0, z1);
  }
  unsigned phase = 0;
  siddhi_grid_sync(ws + WS_BAR, phase);
  const int total = block_sum(tiles, 0, T, smem);
  int before = block_sum(tiles, 0, g < T ? g : T, smem);
  const bool kept = g + G >= T;  // one tile: its walk is in registers
  for (int t = g; t < T; t += G) {
    if (t != g) before += block_sum(tiles, t - G, t, smem);
    if (!kept)  // more tiles than blocks: walk this one again
      walk<KM>(t * PB + threadIdx.x, probe_hash, probe_valid, B, K, H,
               heads, nexts, slot_hash, slot_seq, app, wlen, m, cnt, trunc);
    int n_tile;
    int w = before + block_exclusive_sum<PB>(cnt, smem, &n_tile);
    const int i = t * PB + threadIdx.x;
    // oldest first: the walk found them newest first
#pragma unroll
    for (int s = KM - 1; s >= 0; --s) {
      if (m[s] >= 0) {
        if (w < cap) {
          lane_out[w] = i;
          row_out[w] = m[s];
          pv_out[w] = 1;
        }
        ++w;
      }
    }
  }
  if (g == 0 && threadIdx.x == 0) {
    counts[0] = total;
    counts[1] = total > cap ? total - cap : 0;
    counts[2] = static_cast<int>(__ldcg(ws + WP_TRUNC));
  }
  if (siddhi_grid_last(ws + WS_BAR, ws + WS_DONE)) {
    for (int j = threadIdx.x; j < T; j += PB) tiles[j] = 0u;
    if (threadIdx.x == 0) ws[WP_TRUNC] = 0u;
  }
}

__global__ void compact_count(const uint8_t* __restrict__ pv, int n,
                              int* __restrict__ block_cnt) {
  __shared__ int smem[CBLOCK / 32];
  const int i = blockIdx.x * CBLOCK + threadIdx.x;
  int total;
  block_exclusive_sum<CBLOCK>((i < n && pv[i]) ? 1 : 0, smem, &total);
  if (threadIdx.x == 0) block_cnt[blockIdx.x] = total;
}

// One block: block_cnt[b] becomes the kept lanes before block b;
// count[0] receives the total.
__global__ void compact_scan(int* __restrict__ block_cnt, int nblocks,
                             int* __restrict__ count) {
  __shared__ int smem[CBLOCK / 32];
  int carry = 0;
  for (int base = 0; base < nblocks; base += CBLOCK) {
    const int j = base + threadIdx.x;
    const int v = j < nblocks ? block_cnt[j] : 0;
    int total;
    const int ex = block_exclusive_sum<CBLOCK>(v, smem, &total);
    if (j < nblocks) block_cnt[j] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) count[0] = carry;
}

__global__ void compact_scatter(const int32_t* __restrict__ lane,
                                const int32_t* __restrict__ brow,
                                const uint8_t* __restrict__ pv, int P,
                                int cap, const int* __restrict__ block_off,
                                const int* __restrict__ count,
                                int32_t* __restrict__ lane_out,
                                int32_t* __restrict__ row_out,
                                uint8_t* __restrict__ pv_out) {
  __shared__ int smem[CBLOCK / 32];
  const int i = blockIdx.x * CBLOCK + threadIdx.x;
  const int v = (i < P && pv[i]) ? 1 : 0;
  int total;
  const int ex = block_exclusive_sum<CBLOCK>(v, smem, &total);
  const int n = min(count[0], cap);
  if (v) {
    const int dest = block_off[blockIdx.x] + ex;
    if (dest < cap) {
      lane_out[dest] = lane[i];
      row_out[dest] = brow[i];
    }
  }
  // lanes past n: zero, as the JAX zeros-initialised scatter leaves them
  if (i < cap) {
    pv_out[i] = i < n;
    if (i >= n) {
      lane_out[i] = 0;
      row_out[i] = 0;
    }
  }
}

// Sets the two append kernels' shared memory once; the grid kernel's
// co-resident blocks in *cap.
int append_setup(int* cap) {
  static int capacity = -1;
  if (capacity < 0) {
    cudaError_t e = cudaFuncSetAttribute(
        k10_append, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ASMEM));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k10_append_parts,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(PSMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    capacity = siddhi_coop_capacity(k10_append, ABLOCK, ASMEM);
  }
  *cap = capacity;
  return 0;
}

// The tiles of an append of more than ATILE lanes: *tile lanes each,
// about one a co-resident block, *T of them; *cap the co-resident blocks.
int plan(int B, int* tile, int* T, int* cap) {
  const int rc = append_setup(cap);
  if (rc) return rc;
  const int per = (B + (*cap > 0 ? *cap : 1) - 1) / (*cap > 0 ? *cap : 1);
  const int t = (per + MIN_TILE - 1) / MIN_TILE * MIN_TILE;
  *tile = t < MIN_TILE ? MIN_TILE : (t > ATILE ? ATILE : t);
  *T = (B + *tile - 1) / *tile;
  return 0;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Bytes of the append's workspace (zero when first allocated and after
// every launch) for B lanes into H buckets; 0 up to ATILE lanes.
SIDDHI_API long long k10_append_workspace_bytes(int B, int H) {
  int tile, T, cap;
  if (B <= ATILE || plan(B, &tile, &T, &cap)) return 0;
  return 4ll * WS_MASKS + 8ll * H * ((T + 63) / 64);
}

// Bytes of the append's scratch for B lanes; 0 up to ATILE lanes.
SIDDHI_API long long k10_append_scratch_bytes(int B) {
  int tile, T, cap;
  if (B <= ATILE || plan(B, &tile, &T, &cap)) return 0;
  return 4ll * (((T + 3) & ~3) + 2ll * T * tile);
}

// hashes: u32[B]; live: bool[B]; appended0: int64[1]; heads int32[H],
// nexts int32[C], slot_hash/slot_seq u32[C], updated in place; ws and
// scratch as the two functions above size them (null up to ATILE lanes).
SIDDHI_API int k10_multimap_append(const uint32_t* hashes, const bool* live,
                                   int B, int H, int C,
                                   const int64_t* appended0, int32_t* heads,
                                   int32_t* nexts, uint32_t* slot_hash,
                                   uint32_t* slot_seq, unsigned* ws,
                                   uint32_t* scratch, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > C || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  int tile, T, cap;
  const int rc = plan(B, &tile, &T, &cap);
  if (rc) return rc;
  if (B <= ATILE) {  // bucket shares, one a block, about PART_LANES lanes
    int pbits = 0;
    while (pbits < 31 && (2 << pbits) <= MAX_PARTS &&
           (2 << pbits) * PART_LANES <= B)
      ++pbits;
    k10_append_parts<<<1u << pbits, ABLOCK, PSMEM, stream>>>(
        hashes, live, B, H, C, appended0, heads, nexts, slot_hash, slot_seq,
        pbits);
    return siddhi_launch_status();
  }
  if (T > ATILE || ws == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  int tpad = (T + 3) & ~3;
  const int grid = T < cap ? T : cap;
  void* args[] = {&hashes,   &live,   &B,     &H,         &C,
                  &appended0, &heads, &nexts, &slot_hash, &slot_seq,
                  &ws,       &scratch, &tile, &tpad};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k10_append), dim3(grid), dim3(ABLOCK),
      args, ASMEM, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}

// probe_hash: u32[B]; probe_valid: bool[B]; appended, window_len:
// int64[1]; cand_pos int32[B, K], cand_ok bool[B, K]; truncated: int32[1],
// zeroed by the caller.
SIDDHI_API int k10_multimap_probe(const uint32_t* probe_hash,
                                  const uint8_t* probe_valid, int B, int K,
                                  int H, const int32_t* heads,
                                  const int32_t* nexts,
                                  const uint32_t* slot_hash,
                                  const uint32_t* slot_seq,
                                  const int64_t* appended,
                                  const int64_t* window_len,
                                  int32_t* cand_pos, uint8_t* cand_ok,
                                  int* truncated, cudaStream_t stream) {
  if (B <= 0) return 0;
  probe<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(
      probe_hash, probe_valid, B, K, H, heads, nexts, slot_hash, slot_seq,
      appended, window_len, cand_pos, cand_ok, truncated);
  return siddhi_launch_status();
}

// Bytes of the fused probe's workspace for B lanes (zero when first
// allocated and after every launch).
SIDDHI_API long long k10_probe_compact_workspace_bytes(int B) {
  return 4ll * (WP_TILES + siddhi_blocks(B, PB));
}

namespace {

template <int KM>
int launch_probe_compact(const void* const* args, int T, cudaStream_t stream) {
  static int cap = -1;
  if (cap < 0) cap = siddhi_coop_capacity(probe_compact<KM>, PB);
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  const int grid = T < cap ? T : cap;
  // one block waits for no other: a plain launch (cheaper on the card)
  const cudaError_t e =
      grid == 1
          ? cudaLaunchKernel(reinterpret_cast<const void*>(probe_compact<KM>),
                             dim3(1), dim3(PB), const_cast<void**>(args), 0,
                             stream)
          : cudaLaunchCooperativeKernel(
                reinterpret_cast<const void*>(probe_compact<KM>), dim3(grid),
                dim3(PB), const_cast<void**>(args), 0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}

}  // namespace

// multimap_probe then compact_pairs of its [B, K] block into cap pairs,
// as one launch in tiles of PB lanes. Inputs as k10_multimap_probe;
// 0 < cap <= B * K < 2^31, K <= PROBE_MAX_K. lane_out, row_out
// int32[cap], pv_out bool[cap]; counts int32[3]: the candidates, those
// past cap, the truncated lanes; ws the workspace
// (k10_probe_compact_workspace_bytes).
SIDDHI_API int k10_multimap_probe_compact(
    const uint32_t* probe_hash, const uint8_t* probe_valid, int B, int K,
    int H, const int32_t* heads, const int32_t* nexts,
    const uint32_t* slot_hash, const uint32_t* slot_seq,
    const int64_t* appended, const int64_t* window_len, int cap,
    int32_t* lane_out, int32_t* row_out, uint8_t* pv_out, int* counts,
    unsigned* ws, cudaStream_t stream) {
  if (B <= 0 || K < 1 || K > PROBE_MAX_K || cap <= 0 ||
      static_cast<long long>(B) * K > 0x7fffffffll || cap > B * K)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* args[] = {&probe_hash, &probe_valid, &B,        &K,
                        &H,          &heads,       &nexts,    &slot_hash,
                        &slot_seq,   &appended,    &window_len, &cap,
                        &lane_out,   &row_out,     &pv_out,   &counts,
                        &ws};
  const int T = static_cast<int>(siddhi_blocks(B, PB));
  if (K <= 4) return launch_probe_compact<4>(args, T, stream);
  if (K <= 16) return launch_probe_compact<16>(args, T, stream);
  return launch_probe_compact<64>(args, T, stream);
}

// lane, brow: int32[P]; pv: bool[P]; cap <= P; scratch: int32[nblocks + 1]
// with nblocks = ceil(P / 1024), scratch[nblocks] receives sum(pv);
// lane_out, row_out: int32[cap]; pv_out: bool[cap].
SIDDHI_API int k10_compact_pairs(const int32_t* lane, const int32_t* brow,
                                 const uint8_t* pv, int P, int cap,
                                 int32_t* scratch, int32_t* lane_out,
                                 int32_t* row_out, uint8_t* pv_out,
                                 cudaStream_t stream) {
  if (P <= 0 || cap <= 0) return 0;
  if (cap > P) return static_cast<int>(cudaErrorInvalidValue);
  const int nblocks = static_cast<int>(siddhi_blocks(P, CBLOCK));
  int* block_cnt = scratch;
  int* count = scratch + nblocks;
  compact_count<<<nblocks, CBLOCK, 0, stream>>>(pv, P, block_cnt);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  compact_scan<<<1, CBLOCK, 0, stream>>>(block_cnt, nblocks, count);
  rc = siddhi_launch_status();
  if (rc) return rc;
  compact_scatter<<<nblocks, CBLOCK, 0, stream>>>(
      lane, brow, pv, P, cap, block_cnt, count, lane_out, row_out, pv_out);
  return siddhi_launch_status();
}
