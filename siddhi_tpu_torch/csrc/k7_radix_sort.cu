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
//     keys <= C).
// The result is the permutation jnp.argsort(keys, stable=True) gives, bit
// for bit: equal keys keep their lane order.
//
// Entry points (plain C, int32 order out):
//   k7_argsort_u32: non-negative int32 keys <= a static bound; the caller
//     passes the bound's bit count, so a 20-bit chunk key takes 3 passes;
//   k7_argsort_i64: int64 keys in signed order (the sign bit is flipped
//     into the digits), 8 passes.
//
// One pass of 8 bits is three launches:
//   hist    — per-tile digit counts (warp-aggregated shared-memory atomics;
//             counts do not depend on order), stored digit-major:
//             counts[d * T + t], T <= 256 tiles;
//   scan    — one block per digit turns its T counts into exclusive
//             offsets over the tiles and writes the digit's total;
//   scatter — each tile first scans the 256 digit totals into the digits'
//             bases, so (digit d, tile t) starts at base[d] + counts[d * T
//             + t]; then it walks its lanes 1024 at a time, in lane order. A
//             lane's rank among the equal digits of its warp comes from
//             __match_any_sync and a popcount below the lane; per-warp digit
//             counts in shared memory, scanned over the warps, place the
//             warp; a running per-digit base carries the sub-tiles. No
//             atomic decides a position, which is what makes it stable.
// The last pass writes only the order (and only its first `width` lanes);
// earlier passes ping-pong keys and lane ids through caller scratch sized
// from the static L, so nothing is read back to the host.
//
// Bound on the H100: bytes. Each pass reads the keys (and lane ids after the
// first) and writes them again; the least work is the keys read once and the
// order written once (e.g. 393,216 4-byte keys and a 262,144-lane order,
// ~2.6 MB, under 1 us at 3.35 TB/s). At these widths the kernel is bound by
// its launches (3 a pass); a onesweep design with decoupled look-back would
// fuse the passes, in a later change.

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;
constexpr int NW = BLOCK / 32;
constexpr int RADIX_BITS = 8;
constexpr int R = 1 << RADIX_BITS;
constexpr int MAX_TILES = 256;  // one scan block of 256 threads a digit

template <typename U>
__device__ __forceinline__ unsigned digit_of(U key, U bias, int shift) {
  return static_cast<unsigned>(((key ^ bias) >> shift) & (R - 1));
}

template <typename U>
__global__ void k7_hist(const U* __restrict__ keys, int n, int shift, U bias,
                        int tile_items, int ntiles, int* __restrict__ counts) {
  __shared__ int h[R];
  for (int d = threadIdx.x; d < R; d += BLOCK) h[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * tile_items;
  const int end = min(base + tile_items, n);
  // every lane runs every round (the bounds are the block's), so the
  // warp can pool equal digits into one atomic
  for (int sub = base; sub < end; sub += BLOCK) {
    const int i = sub + threadIdx.x;
    const unsigned d = i < end ? digit_of(keys[i], bias, shift)
                               : 0xffffffffu;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (i < end && (peers & ((1u << lane) - 1u)) == 0)
      atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < R; d += BLOCK)
    counts[d * ntiles + blockIdx.x] = h[d];
}

// Block d: exclusive prefix sum of digit d's tile counts in place, and the
// digit's total into totals[d].
__global__ void k7_scan(int* __restrict__ counts, int ntiles,
                        int* __restrict__ totals) {
  __shared__ int smem[MAX_TILES / 32];
  const int t = threadIdx.x;
  int* row = counts + blockIdx.x * ntiles;
  const int v = t < ntiles ? row[t] : 0;
  int total;
  const int ex = block_exclusive_sum<MAX_TILES>(v, smem, &total);
  if (t < ntiles) row[t] = ex;
  if (t == 0) totals[blockIdx.x] = total;
}

// keys_out may be null (last pass); idx_in null means lane ids (first pass).
template <typename U>
__global__ void k7_scatter(const U* __restrict__ keys_in,
                           const int32_t* __restrict__ idx_in, int n,
                           int shift, U bias, int tile_items, int ntiles,
                           const int* __restrict__ offsets,
                           const int* __restrict__ totals,
                           U* __restrict__ keys_out,
                           int32_t* __restrict__ idx_out, int width) {
  __shared__ int warp_cnt[NW * R];
  __shared__ int run[R];
  __shared__ int sub_total[R];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the digits' bases: an exclusive scan of their totals (R <= BLOCK)
  int all;
  const int digit_base =
      block_exclusive_sum<BLOCK>(tid < R ? totals[tid] : 0, warp_cnt, &all);
  if (tid < R) run[tid] = digit_base + offsets[tid * ntiles + blockIdx.x];
  const int base = blockIdx.x * tile_items;
  const int end = min(base + tile_items, n);
  for (int sub = base; sub < end; sub += BLOCK) {
    for (int j = tid; j < NW * R; j += BLOCK) warp_cnt[j] = 0;
    __syncthreads();
    const int i = sub + tid;
    const bool live = i < end;
    U k = 0;
    unsigned d = 0xffffffffu;  // dead lanes match only each other
    if (live) {
      k = keys_in[i];
      d = digit_of(k, bias, shift);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned below = peers & ((1u << lane) - 1u);
    if (live && below == 0) warp_cnt[warp * R + d] = __popc(peers);
    __syncthreads();
    // per digit: exclusive scan over the warps, in warp (= lane) order
    for (int dd = tid; dd < R; dd += BLOCK) {
      int acc = 0;
      for (int w = 0; w < NW; ++w) {
        const int c = warp_cnt[w * R + dd];
        warp_cnt[w * R + dd] = acc;
        acc += c;
      }
      sub_total[dd] = acc;
    }
    __syncthreads();
    if (live) {
      const int pos = run[d] + warp_cnt[warp * R + d] + __popc(below);
      if (keys_out != nullptr) keys_out[pos] = k;
      if (pos < width) idx_out[pos] = idx_in != nullptr ? idx_in[i] : i;
    }
    __syncthreads();
    for (int dd = tid; dd < R; dd += BLOCK) run[dd] += sub_total[dd];
    __syncthreads();
  }
}

template <typename U>
int k7_argsort(const U* keys, int n, int bits, U bias, int width,
               int tile_items, int32_t* order, U* key_scratch,
               int32_t* idx_scratch, int* counts, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int ntiles = static_cast<int>(siddhi_blocks(n, tile_items));
  if (ntiles > MAX_TILES || tile_items % BLOCK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int* totals = counts + R * ntiles;
  const int passes = (bits + RADIX_BITS - 1) / RADIX_BITS;
  const U* kin = keys;
  const int32_t* iin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    const int shift = p * RADIX_BITS;
    U* kout = last ? nullptr : key_scratch + static_cast<size_t>(p & 1) * n;
    int32_t* iout =
        last ? order : idx_scratch + static_cast<size_t>(p & 1) * n;
    k7_hist<U><<<ntiles, BLOCK, 0, stream>>>(kin, n, shift, bias, tile_items,
                                             ntiles, counts);
    int rc = siddhi_launch_status();
    if (rc) return rc;
    k7_scan<<<R, MAX_TILES, 0, stream>>>(counts, ntiles, totals);
    rc = siddhi_launch_status();
    if (rc) return rc;
    k7_scatter<U><<<ntiles, BLOCK, 0, stream>>>(
        kin, iin, n, shift, bias, tile_items, ntiles, counts, totals, kout,
        iout, last ? width : n);
    rc = siddhi_launch_status();
    if (rc) return rc;
    kin = kout;
    iin = iout;
  }
  return 0;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k7_radix_bits() { return RADIX_BITS; }

// keys: int32[n], each in [0, 2^bits); order: int32[width]. key_scratch,
// idx_scratch: 2n entries each (unused with one pass); counts: 256 * (T + 1)
// ints, T = ceil(n / tile_items) <= 256; tile_items a multiple of 1024.
SIDDHI_API int k7_argsort_u32(const uint32_t* keys, int n, int bits,
                              int width, int tile_items, int32_t* order,
                              uint32_t* key_scratch, int32_t* idx_scratch,
                              int* counts, cudaStream_t stream) {
  return k7_argsort<uint32_t>(keys, n, bits, 0u, width, tile_items, order,
                              key_scratch, idx_scratch, counts, stream);
}

// keys: int64[n] sorted as signed (bias flips the sign bit), 64 bits.
SIDDHI_API int k7_argsort_i64(const uint64_t* keys, int n, int width,
                              int tile_items, int32_t* order,
                              uint64_t* key_scratch, int32_t* idx_scratch,
                              int* counts, cudaStream_t stream) {
  return k7_argsort<uint64_t>(keys, n, 64, 0x8000000000000000ull, width,
                              tile_items, order, key_scratch, idx_scratch,
                              counts, stream);
}
