// K7 — stable LSD radix argsort of bounded integer keys.
//
// Replaces the stable argsorts of the JAX package that order a chunk or a
// ring by an integer key:
//   siddhi_tpu/ops/windows.py `_sort_chunk` (int64 emission keys, invalid
//     lanes last, trimmed to the chunk width) for session(gap) and sort(N);
//   siddhi_tpu/ops/windows.py `SortWindow._rank_key` (successive stable
//     argsorts of float64 keys, here mapped to order-preserving int64 keys
//     by ops/search.py `float64_sort_key`);
//   siddhi_tpu/ops/windows_extra.py `KeyedSessionWindow.step` (arrivals
//     grouped by key slot, keys <= K; the oldest-first top-E of the ring,
//     keys <= C), and the int64 sorts of the frequent windows, the
//     time-first limiter, ORDER BY and the table index.
// The result is the permutation jnp.argsort(keys, stable=True) gives, bit
// for bit: equal keys keep their lane order.
//
// Entry points (plain C, int32 order out):
//   k7_argsort_u32: non-negative int32 keys <= a static bound; the caller
//     passes the bound's bit count, so a 20-bit chunk key takes 3 passes;
//   k7_argsort_i32: int32 keys in signed order (sign bit flipped), 4 passes;
//   k7_argsort_i64: int64 keys in signed order, 8 passes.
//
// A onesweep sort (Adinets & Merrill, "Onesweep: A Faster Least Significant
// Digit Radix Sort for GPUs", 2022) of 8-bit digits in ONE launch:
//   k7_sweep  a cooperative launch of no more blocks than fit the card at
//             once (so blocks may wait for each other), each walking tiles of
//             256 threads x 4 keys in order: small tiles, so that every SM
//             ranks keys at these widths (ranking is the pass's largest cost). One read of the keys counts every
//             pass's digits (warp-uniform digits pooled into one shared
//             atomic, then one global atomic a non-empty bin). Then, per
//             pass, a tile ranks its keys in shared memory in lane order: a
//             warp walks its 8 key rows, a key's rank among the equal digits
//             of its row comes from __match_any_sync and a popcount below
//             the lane, per-warp digit counts carry the rows, and a scan over
//             the warps places each warp (one thread a digit). The offset of (tile, digit) among
//             the tiles before it comes by a decoupled look-back (8
//             predecessors a read) over per-(tile, digit) counts: positions
//             are integers and do not depend on the order the look-back meets
//             them, so the sort is stable and deterministic. The digit's base
//             is an exclusive scan of the pass's histogram. A grid barrier
//             separates the passes.
//   k7_small  n <= 2,048: every pass in one block, keys and ids in
//             registers between passes and in shared memory while they move
//             (no look-back, no barrier). Above that the sweep's blocks on
//             several SMs rank faster than one block.
// A pass whose digit is the same for every key (one bin of its histogram
// holds n) is skipped on the device: every block reads the histogram and
// runs only the other passes; the last pass that runs writes the order (the
// lane ids when none runs). Scratch (the caller's, sized from the shapes
// alone): ping-pong keys and ids, the histogram and a look-back region a
// pass, which the launch zeroes before its first barrier. The workspace
// (the grid barrier's counter and a done counter) is zero on entry; the last
// block to finish zeroes it again. Nothing is read back to the host.
//
// Bound on the H100: bytes, the keys read once and the order written once
// (e.g. 393,216 4-byte keys and a 262,144-lane order, ~2.6 MB, under 1 us at
// 3.35 TB/s). Each pass reads and writes keys and ids once more (L2
// resident at these widths); a pass is bound by its latency (ranking, the
// look-back, the barrier). One launch instead of one a pass removes the
// launch latency and the prologue of each pass, and a skipped pass costs
// nothing.

#include "common.cuh"

namespace {

constexpr int RADIX_BITS = 8;
constexpr int R = 1 << RADIX_BITS;
constexpr int MAX_PASSES = 8;
constexpr int BLOCK = 256;  // one thread a digit in the look-back
constexpr int NW = BLOCK / 32;
constexpr int ITEMS = 4;
constexpr int TILE = BLOCK * ITEMS;
constexpr int LB_WINDOW = 8;  // look-back: predecessors read at once
constexpr int SBLOCK = 512;   // the one-block path
constexpr int SNW = SBLOCK / 32;
constexpr int SITEMS = 4;
constexpr int SMALL_N = SBLOCK * SITEMS;
constexpr unsigned FLAG_A = 1u << 30;  // look-back: this tile's count
constexpr unsigned FLAG_P = 2u << 30;  // look-back: inclusive prefix
constexpr unsigned COUNT_MASK = FLAG_A - 1u;
// workspace: the grid barrier's counter, the done counter
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_WORDS = 2;

template <typename U>
__device__ __forceinline__ unsigned digit_of(U key, U bias, int shift) {
  return static_cast<unsigned>(((key ^ bias) >> shift) & (R - 1));
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Add one key's digit to a shared histogram row: a warp whose live lanes
// share the digit adds once.
__device__ __forceinline__ void hist_add(unsigned* row, unsigned d, bool live) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned live_mask = __ballot_sync(0xffffffffu, live);
  if (live_mask == 0u) return;
  const unsigned d0 = __shfl_sync(0xffffffffu, d, __ffs(live_mask) - 1);
  if (__all_sync(0xffffffffu, !live || d == d0)) {
    if (lane == static_cast<unsigned>(__ffs(live_mask) - 1))
      atomicAdd(&row[d0], static_cast<unsigned>(__popc(live_mask)));
  } else if (live) {
    atomicAdd(&row[d], 1u);
  }
}

// The block's rank of each of its key rows among the equal digits before it
// in its warp (lane order), with the warp's digit counts in wcnt[warp][d].
// Dead lanes match only each other and are never counted.
__device__ __forceinline__ unsigned warp_rank(unsigned* wrow, unsigned d,
                                              bool live) {
  const unsigned peers = __match_any_sync(0xffffffffu, live ? d : 0xffffffffu);
  const unsigned below = peers & lanemask_lt();
  const unsigned before = live ? wrow[d] : 0u;
  __syncwarp();
  if (live && below == 0u) wrow[d] = before + __popc(peers);
  __syncwarp();
  return before + __popc(below);
}

// Tile t of one pass: rank its keys in lane order, place the tile by
// look-back in `lb` (this pass's [T][R] rows), scatter keys and ids to the
// next buffers, or the order (first `width` lanes) on the last pass.
template <typename U>
__device__ __forceinline__ void sort_tile(int t, const U* kin,
                                          const int32_t* iin, int n,
                                          int shift, U bias,
                                          const unsigned* base, unsigned* lb,
                                          U* kout, int32_t* iout,
                                          int32_t* order, int width,
                                          bool last, unsigned* wcnt,
                                          unsigned* start) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = lane; j < R; j += 32) wcnt[warp * R + j] = 0u;
  __syncwarp();
  const long long row0 =
      static_cast<long long>(t) * TILE + warp * (32 * ITEMS) + lane;
  U k[ITEMS];
  int32_t id[ITEMS];
  unsigned rank[ITEMS], dig[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long e = row0 + r * 32;
    const bool live = e < n;
    k[r] = live ? kin[e] : U(0);
    id[r] = live ? (iin == nullptr ? static_cast<int32_t>(e) : iin[e]) : 0;
    dig[r] = digit_of(k[r], bias, shift);
    rank[r] = warp_rank(wcnt + warp * R, dig[r], live);
  }
  __syncthreads();
  if (tid < R) {
    // the warps' offsets inside the tile, then the tile's among tiles
    unsigned acc = 0u;
    for (int w = 0; w < NW; ++w) {
      const unsigned c = wcnt[w * R + tid];
      wcnt[w * R + tid] = acc;
      acc += c;
    }
    volatile unsigned* mine = lb + static_cast<size_t>(t) * R + tid;
    unsigned excl = 0u;
    if (t == 0) {
      *mine = FLAG_P | acc;
    } else {
      *mine = FLAG_A | acc;
      // LB_WINDOW predecessors a read, nearest first, up to an inclusive
      // prefix; a tile not yet published is polled again
      for (int j = t - 1;;) {
        unsigned v[LB_WINDOW];
#pragma unroll
        for (int q = 0; q < LB_WINDOW; ++q) {
          v[q] = FLAG_P | 0u;  // before tile 0: a prefix of 0 (never read)
          if (j - q >= 0)
            v[q] = *(volatile unsigned*)(lb + static_cast<size_t>(j - q) * R +
                                         tid);
        }
        int used = 0;
        bool found = false;
#pragma unroll
        for (int q = 0; q < LB_WINDOW; ++q) {
          if (found || used < q || v[q] == 0u) continue;
          excl += v[q] & COUNT_MASK;
          used = q + 1;
          found = (v[q] & FLAG_P) != 0u;
        }
        if (found) break;
        j -= used;
      }
      *mine = FLAG_P | (excl + acc);
    }
    start[tid] = base[tid] + excl;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (row0 + r * 32 >= n) continue;
    const unsigned pos = start[dig[r]] + wcnt[warp * R + dig[r]] + rank[r];
    if (last) {
      if (pos < static_cast<unsigned>(width)) order[pos] = id[r];
    } else {
      kout[pos] = k[r];
      iout[pos] = id[r];
    }
  }
  __syncthreads();  // wcnt and start are reused by the next tile
}

// Every pass in one cooperative launch (see the file's comment).
template <typename U>
__global__ void __launch_bounds__(BLOCK, 4)
    k7_sweep(const U* __restrict__ keys, U* kbuf0, U* kbuf1, int32_t* ibuf0,
             int32_t* ibuf1, int n, int passes, U bias, int width,
             int ntiles, unsigned* hist, unsigned* lookback, unsigned* ws,
             int32_t* __restrict__ order) {
  __shared__ unsigned wcnt[NW * R];
  __shared__ unsigned tot[MAX_PASSES * R];  // the block's counts, then all
  __shared__ unsigned base[R];
  __shared__ unsigned start[R];
  __shared__ int scan_smem[BLOCK / 32];
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  unsigned phase = 0;
  // zero this block's look-back rows of every pass and (block 0) the
  // histogram before any block counts into it
  for (int t = blockIdx.x; t < ntiles; t += G)
    for (int p = 0; p < passes; ++p)
      for (int d = tid; d < R; d += BLOCK)
        lookback[(static_cast<size_t>(p) * ntiles + t) * R + d] = 0u;
  for (int j = tid; j < passes * R; j += BLOCK) {
    tot[j] = 0u;
    if (blockIdx.x == 0) hist[j] = 0u;
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  for (int t = blockIdx.x; t < ntiles; t += G)
    for (int r = 0; r < ITEMS; ++r) {
      const long long e = static_cast<long long>(t) * TILE + r * BLOCK + tid;
      const bool live = e < n;
      const U k = live ? keys[e] : U(0);
      for (int p = 0; p < passes; ++p)
        hist_add(tot + p * R, digit_of(k, bias, p * RADIX_BITS), live);
    }
  __syncthreads();
  for (int j = tid; j < passes * R; j += BLOCK)
    if (tot[j] != 0u) atomicAdd(&hist[j], tot[j]);
  siddhi_grid_sync(ws + WS_BAR, phase);
  for (int j = tid; j < passes * R; j += BLOCK) tot[j] = __ldcg(hist + j);
  __syncthreads();
  // the passes that run: those whose digit is not the same for every key
  unsigned run = 0u;
  for (int p = 0; p < passes; ++p)
    if (!__syncthreads_or(tid < R && tot[p * R + tid] ==
                                         static_cast<unsigned>(n)))
      run |= 1u << p;
  const int lastp = run ? 31 - __clz(run) : -1;
  const U* kin = keys;
  const int32_t* iin = nullptr;  // lane ids
  int dst = 0;
  for (int p = 0; p < passes; ++p) {
    if (!(run & (1u << p))) continue;
    int all;
    const int b = block_exclusive_sum<BLOCK>(
        tid < R ? static_cast<int>(tot[p * R + tid]) : 0, scan_smem, &all);
    if (tid < R) base[tid] = static_cast<unsigned>(b);
    __syncthreads();
    U* kout = dst == 0 ? kbuf0 : kbuf1;
    int32_t* iout = dst == 0 ? ibuf0 : ibuf1;
    for (int t = blockIdx.x; t < ntiles; t += G)
      sort_tile<U>(t, kin, iin, n, p * RADIX_BITS, bias, base,
                   lookback + static_cast<size_t>(p) * ntiles * R, kout, iout,
                   order, width, p == lastp, wcnt, start);
    if (p == lastp) break;
    siddhi_grid_sync(ws + WS_BAR, phase);
    kin = kout;
    iin = iout;
    dst ^= 1;
  }
  if (lastp < 0)  // every digit the same: the order is the lane ids
    for (long long e = static_cast<long long>(blockIdx.x) * BLOCK + tid;
         e < width; e += static_cast<long long>(G) * BLOCK)
      order[e] = static_cast<int32_t>(e);
  // the last block to finish leaves the workspace zeroed
  siddhi_grid_last(ws + WS_BAR, ws + WS_DONE);
}

// Every pass in one block: keys and ids in registers between passes and in
// shared memory while they move.
template <typename U>
__global__ void __launch_bounds__(SBLOCK)
    k7_small(const U* __restrict__ keys, int n, int passes, U bias, int width,
             int32_t* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* skey = reinterpret_cast<U*>(smem_raw);
  int32_t* sid = reinterpret_cast<int32_t*>(skey + SMALL_N);
  unsigned* wcnt = reinterpret_cast<unsigned*>(sid + SMALL_N);  // [SNW][R]
  unsigned* hist = wcnt + SNW * R;                              // [P][R]
  int* scan_smem = reinterpret_cast<int*>(hist + MAX_PASSES * R);
  __shared__ unsigned base[R];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * (32 * SITEMS) + lane;
  for (int j = tid; j < passes * R; j += SBLOCK) hist[j] = 0u;
  __syncthreads();
  U k[SITEMS];
  int32_t id[SITEMS];
#pragma unroll
  for (int r = 0; r < SITEMS; ++r) {
    const int e = row0 + r * 32;
    const bool live = e < n;
    k[r] = live ? keys[e] : U(0);
    id[r] = e;
    for (int p = 0; p < passes; ++p)
      hist_add(hist + p * R, digit_of(k[r], bias, p * RADIX_BITS), live);
  }
  __syncthreads();
  bool placed = false;  // the order is written
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    const unsigned total = tid < R ? hist[p * R + tid] : 0u;
    if (__syncthreads_or(tid < R && total == static_cast<unsigned>(n)))
      continue;
    int all;
    const int b = block_exclusive_sum<SBLOCK>(static_cast<int>(total),
                                              scan_smem, &all);
    if (tid < R) base[tid] = static_cast<unsigned>(b);
    for (int j = lane; j < R; j += 32) wcnt[warp * R + j] = 0u;
    __syncwarp();
    unsigned pos[SITEMS];
#pragma unroll
    for (int r = 0; r < SITEMS; ++r)
      pos[r] = warp_rank(wcnt + warp * R, digit_of(k[r], bias, p * RADIX_BITS),
                         row0 + r * 32 < n);
    __syncthreads();
    if (tid < R) {
      unsigned acc = base[tid];
      for (int w = 0; w < SNW; ++w) {
        const unsigned c = wcnt[w * R + tid];
        wcnt[w * R + tid] = acc;
        acc += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SITEMS; ++r) {
      if (row0 + r * 32 >= n) continue;
      const unsigned d = digit_of(k[r], bias, p * RADIX_BITS);
      const unsigned at = wcnt[warp * R + d] + pos[r];
      if (last) {
        if (at < static_cast<unsigned>(width)) order[at] = id[r];
      } else {
        skey[at] = k[r];
        sid[at] = id[r];
      }
    }
    placed = last;
    if (last) break;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SITEMS; ++r) {
      const int e = row0 + r * 32;
      if (e < n) {
        k[r] = skey[e];
        id[r] = sid[e];
      }
    }
    __syncthreads();
  }
  if (!placed) {  // the last pass was skipped: the order is the ids
#pragma unroll
    for (int r = 0; r < SITEMS; ++r) {
      const int e = row0 + r * 32;
      if (e < width) order[e] = id[r];
    }
  }
}

template <typename U>
size_t small_smem_bytes() {
  return static_cast<size_t>(SMALL_N) * (sizeof(U) + 4) +
         static_cast<size_t>(SNW + MAX_PASSES) * R * 4 + (SBLOCK / 32) * 4;
}

inline int tiles_of(int n) { return static_cast<int>(siddhi_blocks(n, TILE)); }

// Blocks of k7_sweep<U> that fit the card at once, 0 without cooperative
// launches.
template <typename U>
int sweep_capacity() {
  static int cap = -1;
  if (cap < 0) {
    const int c = siddhi_coop_capacity(k7_sweep<U>, BLOCK);
    if (c <= 0) return 0;
    cap = c;
  }
  return cap;
}

// scratch layout: kbuf[2][n] (U), ibuf[2][n], hist[P][R], lookback[P][T][R]
template <typename U>
int k7_argsort(const U* keys, int n, int passes, U bias, int width,
               int32_t* order, void* scratch, unsigned* ws,
               cudaStream_t stream) {
  if (n <= 0) return 0;
  if (passes < 1 || passes > MAX_PASSES || n >= static_cast<int>(COUNT_MASK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= SMALL_N) {
    static bool attr_set = false;
    const size_t bytes = small_smem_bytes<U>();
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          k7_small<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      attr_set = true;
    }
    k7_small<U><<<1, SBLOCK, bytes, stream>>>(keys, n, passes, bias, width,
                                              order);
    return siddhi_launch_status();
  }
  const int cap = sweep_capacity<U>();
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  int ntiles = tiles_of(n);
  const int grid = ntiles < cap ? ntiles : cap;
  uint8_t* s = static_cast<uint8_t*>(scratch);
  U* kbuf0 = reinterpret_cast<U*>(s);
  U* kbuf1 = kbuf0 + n;
  int32_t* ibuf0 = reinterpret_cast<int32_t*>(kbuf1 + n);
  int32_t* ibuf1 = ibuf0 + n;
  unsigned* hist = reinterpret_cast<unsigned*>(ibuf1 + n);
  unsigned* lookback = hist + MAX_PASSES * R;
  void* args[] = {&keys,  &kbuf0, &kbuf1,  &ibuf0, &ibuf1,    &n,
                  &passes, &bias, &width, &ntiles, &hist, &lookback,
                  &ws,    &order};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k7_sweep<U>), dim3(grid), dim3(BLOCK),
      args, 0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k7_radix_bits() { return RADIX_BITS; }

// Keys a tile of a pass.
SIDDHI_API int k7_tile_keys() { return TILE; }

// Blocks of the sweep the card holds at once for keys of key_bytes (4 or
// 8): more tiles than this and a block walks several.
SIDDHI_API int k7_grid_capacity(int key_bytes) {
  return key_bytes == 8 ? sweep_capacity<uint64_t>()
                        : sweep_capacity<uint32_t>();
}

// Largest n sorted by the one-block path.
SIDDHI_API int k7_small_max() { return SMALL_N; }

// Bytes of the workspace: zero when first allocated, zero after every sort.
SIDDHI_API int k7_workspace_bytes() { return WS_WORDS * 4; }

// keys: int32[n], each in [0, 2^bits); order: int32[width].
SIDDHI_API int k7_argsort_u32(const uint32_t* keys, int n, int bits,
                              int width, int32_t* order, void* scratch,
                              unsigned* ws, cudaStream_t stream) {
  return k7_argsort<uint32_t>(keys, n, (bits + RADIX_BITS - 1) / RADIX_BITS,
                              0u, width, order, scratch, ws, stream);
}

// keys: int32[n] sorted as signed (bias flips the sign bit), 32 bits.
SIDDHI_API int k7_argsort_i32(const uint32_t* keys, int n, int width,
                              int32_t* order, void* scratch, unsigned* ws,
                              cudaStream_t stream) {
  return k7_argsort<uint32_t>(keys, n, 4, 0x80000000u, width, order, scratch,
                              ws, stream);
}

// keys: int64[n] sorted as signed (bias flips the sign bit), 64 bits.
SIDDHI_API int k7_argsort_i64(const uint64_t* keys, int n, int width,
                              int32_t* order, void* scratch, unsigned* ws,
                              cudaStream_t stream) {
  return k7_argsort<uint64_t>(keys, n, 8, 0x8000000000000000ull, width,
                              order, scratch, ws, stream);
}
