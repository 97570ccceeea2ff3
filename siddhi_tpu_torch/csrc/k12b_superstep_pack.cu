// K12b — superstep pack: one emitting slot's K iterations into one buffer.
//
// Replaces the compaction at the end of siddhi_tpu/core/superstep.py
// `SuperstepRunner._make_jit` (:417-428): per-iteration valid counts
// `jnp.sum(valid, axis=1)`, one `stable_partition_order` of the flattened
// [K*W] lanes and one gather per column, fetched by one `device_get`. Here
// the valid lanes of every iteration, compacted in (iteration, lane) order,
// go into ONE device buffer (layout in siddhi_tpu_torch/ops/superstep_pack.py):
// a header {total, K, W, 0}, the K counts, then per region K*W entries of
// which the first `total` hold the compacted lanes — timestamps and the
// 8-byte columns, then the 4-, 2- and 1-byte columns. Entries past `total`
// are left as they were. One device-to-host copy then moves the buffer.
//
// Bound on the H100: bytes. Each lane is read once (valid, ts, the columns)
// and each kept entry written once, with the K counts: for app AG's
// lengthBatch slot (int32 code + 2 x float32) at K = 8 and W = 141,087,
// 23.7 MB read and 14.4 MB written at 64% valid, ~11 us at 3.35 TB/s.
// Design: K12a's count, header and scatter scheme over K segments — three
// launches and no host sync. Tiles of 1024 lanes never cross an iteration
// (a 2-D grid: x the tile within the iteration, y the iteration); one block
// scans the tile counts in (iteration, tile) order and writes the header
// and the per-iteration counts; then each block ranks its valid lanes with
// a warp-shuffle block scan and scatters the timestamp and every column.

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;
constexpr int MAX_COLS = 64;

struct Cols {
  const uint8_t* src[MAX_COLS];
  long long off[MAX_COLS];
  int width[MAX_COLS];
  int n;
};

__global__ void k12b_count(const uint8_t* __restrict__ valid, int W, int T,
                           long long* __restrict__ tile_cnt) {
  __shared__ int smem[BLOCK / 32];
  const int k = blockIdx.y;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const int v =
      (lane < W && valid[static_cast<long long>(k) * W + lane]) ? 1 : 0;
  int total;
  block_exclusive_sum<BLOCK>(v, smem, &total);
  if (threadIdx.x == 0)
    tile_cnt[static_cast<long long>(k) * T + blockIdx.x] = total;
}

// One block: tile_cnt becomes each tile's exclusive offset in (iteration,
// tile) order; the header receives {total, K, W, 0} and counts[k] the
// valid lanes of iteration k.
__global__ void k12b_header(long long* __restrict__ tile_cnt, int K, int W,
                            int T, long long* __restrict__ header,
                            long long* __restrict__ counts) {
  __shared__ int smem[BLOCK / 32];
  const long long n = static_cast<long long>(K) * T;
  long long carry = 0;
  for (long long base = 0; base < n; base += BLOCK) {
    const long long j = base + threadIdx.x;
    const int v = j < n ? static_cast<int>(tile_cnt[j]) : 0;
    int total;
    const int ex = block_exclusive_sum<BLOCK>(v, smem, &total);
    if (j < n) tile_cnt[j] = carry + ex;
    carry += total;
  }
  __syncthreads();  // every offset is written before it is read below
  for (int k = threadIdx.x; k < K; k += BLOCK) {
    if (T == 0) {
      counts[k] = 0;
      continue;
    }
    const long long lo = tile_cnt[static_cast<long long>(k) * T];
    const long long hi =
        k + 1 < K ? tile_cnt[static_cast<long long>(k + 1) * T] : carry;
    counts[k] = hi - lo;
  }
  if (threadIdx.x == 0) {
    header[0] = carry;
    header[1] = K;
    header[2] = W;
    header[3] = 0;
  }
}

__global__ void k12b_scatter(const long long* __restrict__ ts,
                             const uint8_t* __restrict__ valid, int W, int T,
                             const Cols cols,
                             const long long* __restrict__ tile_off,
                             long long ts_off, uint8_t* __restrict__ buf) {
  __shared__ int smem[BLOCK / 32];
  const int k = blockIdx.y;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const long long i = static_cast<long long>(k) * W + lane;
  const int v = (lane < W && valid[i]) ? 1 : 0;
  int total;
  const int ex = block_exclusive_sum<BLOCK>(v, smem, &total);
  if (!v) return;
  const long long pos =
      tile_off[static_cast<long long>(k) * T + blockIdx.x] + ex;
  reinterpret_cast<long long*>(buf + ts_off)[pos] = ts[i];
  for (int c = 0; c < cols.n; ++c) {
    const int w = cols.width[c];
    siddhi_copy_lane(buf + cols.off[c] + pos * w, cols.src[c] + i * w, w);
  }
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// ts int64[K * W], valid uint8[K * W] (torch.bool storage), both row-major
// by iteration; ncols columns of K * W lanes given by host arrays of device
// pointers, byte widths (1, 2, 4, 8) and byte offsets into buf; ts_off the
// timestamp region's offset; buf uint8 of the layout's size (header at 0,
// counts at 32); scratch int64[K * ceil(W / 1024)].
SIDDHI_API int k12b_superstep_pack(const long long* ts, const uint8_t* valid,
                                   int K, int W, int ncols,
                                   const void* const* col_ptrs,
                                   const int* col_widths,
                                   const long long* col_offsets,
                                   long long ts_off, uint8_t* buf,
                                   long long* scratch, cudaStream_t stream) {
  if (ncols < 0 || ncols > MAX_COLS || K < 1 || K > 65535 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  cols.n = ncols;
  for (int c = 0; c < ncols; ++c) {
    const int w = col_widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.src[c] = static_cast<const uint8_t*>(col_ptrs[c]);
    cols.off[c] = col_offsets[c];
    cols.width[c] = w;
  }
  const int T = static_cast<int>(siddhi_blocks(W, BLOCK));
  long long* header = reinterpret_cast<long long*>(buf);
  long long* counts = header + 4;
  const dim3 grid(T, K);
  if (T > 0) {
    k12b_count<<<grid, BLOCK, 0, stream>>>(valid, W, T, scratch);
    const int rc = siddhi_launch_status();
    if (rc) return rc;
  }
  k12b_header<<<1, BLOCK, 0, stream>>>(scratch, K, W, T, header, counts);
  int rc = siddhi_launch_status();
  if (rc || T == 0) return rc;
  k12b_scatter<<<grid, BLOCK, 0, stream>>>(ts, valid, W, T, cols, scratch,
                                           ts_off, buf);
  return siddhi_launch_status();
}
