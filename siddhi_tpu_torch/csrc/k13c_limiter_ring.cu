// K13c — the output rate limiters' ring: append and gather.
//
// Replaces the ring scatter and ring gather of siddhi_tpu/ops/ratelimit.py:
//   BufferedLimiter.step (`output all every N events`, `output all|last
//   every T`), :111-131 and :152-170:
//     order = stable_partition_order(live); p = arange(B)
//     slot = where(p < n_new, (appended % C + p) % C, C)
//     ring.<field>.at[slot].set(out.<field>[order], mode="drop")
//     emitted.<field> = ring.<field>[(emit_from % C + i) % C]
//     emitted.valid = (i < n_emit) & ring.valid[...]
//   WindowedSnapshotLimiter.step (`output snapshot every T` on a FIFO
//   window), :307-313 and :326-339: the same append of the CURRENT lanes'
//   projected columns, ranked by a cumsum, and the same gather of the
//   window as of the boundary (valid = i < winlen where the tick fires).
//
// append: the selected lanes (CURRENT and valid) are ranked in lane order;
// lane i of rank r writes every column at slot (appended % C + r) % C of a
// C-slot ring, and the count of selected lanes is written to a device
// scalar. The rank never reaches C (C >= 2B for the buffered ring, Cap >=
// the chunk width for the snapshot ring), so no two lanes share a slot and
// the writes do not conflict. Three launches, the shape of K1: per-tile
// counts, one block scanning the tile counts (and writing the total), and a
// scatter in which each tile re-ranks its lanes with a block scan.
//
// gather: out[i] = ring[(lo % C + i) % C] for i < W, every column, and
// valid_out[i] = (i < n) & ring_valid[slot] (ring_valid may be null). `lo`
// and `n` are int64 device scalars, so the caller reads nothing back.
//
// Columns are 1-, 4- or 8-byte, passed by value as a table of pointers (at
// most MAX_COLS a launch). Both match the plain PyTorch versions
// (ops/ratelimit.py) bit for bit: they only move bytes.
//
// Bound on the H100: bytes. The append reads the selection (B bytes) and
// the selected lanes' rows and writes them once; the gather reads W rows
// of the ring and writes W rows. At B = 131072 lanes of ts + 3 columns +
// valid + type (22 bytes) that is ~5.9 MB for the append (all selected)
// and ~11.5 MB for a C = 262144 gather: 1.8 and 3.4 us at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;
constexpr int MAX_COLS = 32;

struct Columns {
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];  // bytes a value: 1, 4 or 8
  int n;
};

__device__ __forceinline__ void copy_value(const void* src, long long si,
                                           void* dst, long long di,
                                           int size) {
  switch (size) {
    case 1:
      static_cast<uint8_t*>(dst)[di] = static_cast<const uint8_t*>(src)[si];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[di] = static_cast<const uint32_t*>(src)[si];
      break;
    default:
      static_cast<unsigned long long*>(dst)[di] =
          static_cast<const unsigned long long*>(src)[si];
  }
}

__device__ __forceinline__ long long floor_mod(long long a, long long c) {
  const long long m = a % c;
  return m < 0 ? m + c : m;
}

__global__ void k13c_count(const uint8_t* __restrict__ sel, int B,
                           int* __restrict__ tile_count) {
  __shared__ int smem[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int v = (i < B && sel[i]) ? 1 : 0;
  int total;
  block_exclusive_sum<BLOCK>(v, smem, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

// One block: tile_count[t] becomes the selected lanes before tile t;
// n_out receives the total.
__global__ void k13c_scan_tiles(int* __restrict__ tile_count, int ntiles,
                                long long* __restrict__ n_out) {
  __shared__ int smem[BLOCK / 32];
  int carry = 0;
  for (int base = 0; base < ntiles; base += BLOCK) {
    const int j = base + threadIdx.x;
    const int v = j < ntiles ? tile_count[j] : 0;
    int total;
    const int ex = block_exclusive_sum<BLOCK>(v, smem, &total);
    if (j < ntiles) tile_count[j] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) n_out[0] = carry;
}

__global__ void k13c_scatter(const uint8_t* __restrict__ sel, int B,
                             const int* __restrict__ tile_off,
                             const long long* __restrict__ appended,
                             long long C, Columns cols) {
  __shared__ int smem[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int v = (i < B && sel[i]) ? 1 : 0;
  int total;
  const int ex = block_exclusive_sum<BLOCK>(v, smem, &total);
  if (!v) return;
  const long long rank = tile_off[blockIdx.x] + ex;
  const long long slot = (floor_mod(appended[0], C) + rank) % C;
  for (int c = 0; c < cols.n; ++c)
    copy_value(cols.src[c], i, cols.dst[c], slot, cols.size[c]);
}

__global__ void k13c_gather(Columns cols, const uint8_t* __restrict__ ring_valid,
                            const long long* __restrict__ lo,
                            const long long* __restrict__ n, long long C,
                            int W, uint8_t* __restrict__ valid_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= W) return;
  const long long slot = (floor_mod(lo[0], C) + i) % C;
  for (int c = 0; c < cols.n; ++c)
    copy_value(cols.src[c], slot, cols.dst[c], i, cols.size[c]);
  if (valid_out != nullptr) {
    const bool live = i < n[0] && (ring_valid == nullptr || ring_valid[slot]);
    valid_out[i] = live ? 1 : 0;
  }
}

int fill_columns(Columns* cols, const void* const* src, void* const* dst,
                 const int* sizes, int n_cols) {
  if (n_cols < 0 || n_cols > MAX_COLS) return 1;
  cols->n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (sizes[c] != 1 && sizes[c] != 4 && sizes[c] != 8) return 1;
    cols->src[c] = src[c];
    cols->dst[c] = dst[c];
    cols->size[c] = sizes[c];
  }
  return 0;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k13c_max_cols() { return MAX_COLS; }

SIDDHI_API int k13c_block_size() { return BLOCK; }

// k13c_rank: the count and scan launches of the append. sel: uint8[B]
// (torch.bool storage); scratch: int32[ceil(B / BLOCK)] (the tiles'
// offsets, read by k13c_scatter); n_out: int64 device scalar.
SIDDHI_API int k13c_rank(const uint8_t* sel, int B, int* scratch,
                         long long* n_out, cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = static_cast<int>(siddhi_blocks(B, BLOCK));
  k13c_count<<<ntiles, BLOCK, 0, stream>>>(sel, B, scratch);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k13c_scan_tiles<<<1, BLOCK, 0, stream>>>(scratch, ntiles, n_out);
  return siddhi_launch_status();
}

// k13c_scatter_cols: the scatter launch of the append for up to MAX_COLS
// columns. src[c]: the batch's column [B]; dst[c]: the ring's column [C];
// appended: int64 device scalar (the ring's count before this append).
SIDDHI_API int k13c_scatter_cols(const uint8_t* sel, int B,
                                 const int* scratch,
                                 const long long* appended, long long C,
                                 const void* const* src, void* const* dst,
                                 const int* sizes, int n_cols,
                                 cudaStream_t stream) {
  if (B < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  if (fill_columns(&cols, src, dst, sizes, n_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  k13c_scatter<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(
      sel, B, scratch, appended, C, cols);
  return siddhi_launch_status();
}

// k13c_gather_cols: W output lanes of up to MAX_COLS columns from a C-slot
// ring starting at slot lo % C. ring_valid/valid_out may be null (then the
// valid mask is not written; with valid_out alone it is i < n).
SIDDHI_API int k13c_gather_cols(const void* const* src, void* const* dst,
                                const int* sizes, int n_cols,
                                const uint8_t* ring_valid,
                                const long long* lo, const long long* n,
                                long long C, int W, uint8_t* valid_out,
                                cudaStream_t stream) {
  if (C < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  if (fill_columns(&cols, src, dst, sizes, n_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  k13c_gather<<<siddhi_blocks(W, BLOCK), BLOCK, 0, stream>>>(
      cols, ring_valid, lo, n, C, W, valid_out);
  return siddhi_launch_status();
}
