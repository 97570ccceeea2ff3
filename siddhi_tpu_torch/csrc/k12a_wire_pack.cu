// K12a — wire packing of a step's output for the host.
//
// Replaces siddhi_tpu/core/stream.py `_wire_pack` (with the host
// compaction `np.nonzero(valid)` its readers do, stream.py:157 and
// event.py:474): ts0 = the least valid timestamp (0 if none, with the JAX
// function's 2^62 sentinel), dts = uint32(ts - ts0), flags = types << 1 |
// valid, `over` = a delta past 2^32 - 1 or below 0, the columns unchanged.
// Here the valid lanes are compacted in lane order into ONE buffer (layout
// in siddhi_tpu_torch/ops/wire.py): a header {count, ts0, over, 0}, then
// per region `n` entries of which the first `count` hold the compacted
// lanes — the columns, dts, the high words of the delta (so an `over` batch
// still reads back exactly, from this buffer alone) and flags. Entries past
// `count` are left as they were: no reader looks at them. One
// device-to-host copy then moves the whole buffer.
//
// Bound on the H100: bytes. Each lane is read once (ts, valid, types, the
// columns) and each compacted entry written once: for app A's output
// (int32 code + 2 x float32) at B = 131072, half the lanes valid, about
// 2.8 MB read and 1.1 MB written (plus 0.26 MB of high words the function
// needs only on an `over` batch), ~1.2 us at 3.35 TB/s; launch latency
// dominates. Design: three launches and no host sync — per-block valid
// counts and minimum valid ts; one block that scans the block counts,
// folds the minimum and writes the header; then each block ranks its valid
// lanes with a warp-shuffle block scan, writes them at their compacted
// positions and ORs its out-of-range flag into the header.

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;
constexpr int MAX_COLS = 64;
constexpr long long BIG = 1LL << 62;

struct Cols {
  const uint8_t* src[MAX_COLS];
  long long off[MAX_COLS];
  int width[MAX_COLS];
  int n;
};

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// Block-wide minimum; every thread receives it.
__device__ __forceinline__ long long block_min(long long x, long long* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_min(x);
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < BLOCK / 32 ? smem[lane] : BIG;
    w = warp_min(w);
    if (lane == 0) smem[0] = w;
  }
  __syncthreads();
  const long long r = smem[0];
  __syncthreads();
  return r;
}

__global__ void k12a_count(const long long* __restrict__ ts,
                           const uint8_t* __restrict__ valid, int n,
                           long long* __restrict__ block_cnt,
                           long long* __restrict__ block_min_ts) {
  __shared__ int smem[BLOCK / 32];
  __shared__ long long smin[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int v = (i < n && valid[i]) ? 1 : 0;
  int total;
  block_exclusive_sum<BLOCK>(v, smem, &total);
  const long long m = block_min(v ? ts[i] : BIG, smin);
  if (threadIdx.x == 0) {
    block_cnt[blockIdx.x] = total;
    block_min_ts[blockIdx.x] = m;
  }
}

// One block: block_cnt[b] becomes the valid lanes before block b; the
// header receives count, ts0 (0 when the minimum is the sentinel), over = 0.
__global__ void k12a_header(long long* __restrict__ block_cnt,
                            const long long* __restrict__ block_min_ts,
                            int nblocks, long long* __restrict__ header) {
  __shared__ int smem[BLOCK / 32];
  __shared__ long long smin[BLOCK / 32];
  long long carry = 0;
  long long m = BIG;
  for (int base = 0; base < nblocks; base += BLOCK) {
    const int j = base + threadIdx.x;
    const int v = j < nblocks ? static_cast<int>(block_cnt[j]) : 0;
    int total;
    const int ex = block_exclusive_sum<BLOCK>(v, smem, &total);
    if (j < nblocks) block_cnt[j] = carry + ex;
    carry += total;
    const long long bm = block_min(j < nblocks ? block_min_ts[j] : BIG, smin);
    m = bm < m ? bm : m;
  }
  if (threadIdx.x == 0) {
    header[0] = carry;
    header[1] = m == BIG ? 0 : m;
    header[2] = 0;
    header[3] = 0;
  }
}

__global__ void k12a_scatter(const long long* __restrict__ ts,
                             const uint8_t* __restrict__ valid,
                             const int8_t* __restrict__ types, int n,
                             const Cols cols,
                             const long long* __restrict__ block_off,
                             long long dts_off, long long hi_off,
                             long long flags_off, uint8_t* __restrict__ buf) {
  __shared__ int smem[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int v = (i < n && valid[i]) ? 1 : 0;
  int total;
  const int ex = block_exclusive_sum<BLOCK>(v, smem, &total);
  const unsigned long long ts0 = static_cast<unsigned long long>(
      reinterpret_cast<const long long*>(buf)[1]);
  uint32_t* dts = reinterpret_cast<uint32_t*>(buf + dts_off);
  uint32_t* hi = reinterpret_cast<uint32_t*>(buf + hi_off);
  uint8_t* flags = buf + flags_off;
  int out_of_range = 0;
  if (v) {
    const long long pos = block_off[blockIdx.x] + ex;
    // the int64 subtraction of _wire_pack, wrapping
    const unsigned long long d = static_cast<unsigned long long>(ts[i]) - ts0;
    const long long ds = static_cast<long long>(d);
    out_of_range = (ds < 0 || ds > 0xFFFFFFFFLL) ? 1 : 0;
    dts[pos] = static_cast<uint32_t>(d);
    hi[pos] = static_cast<uint32_t>(d >> 32);
    flags[pos] = static_cast<uint8_t>(
        (static_cast<uint8_t>(types[i]) << 1) | 1);
    for (int c = 0; c < cols.n; ++c) {
      const int w = cols.width[c];
      siddhi_copy_lane(buf + cols.off[c] + pos * w,
                       cols.src[c] + (long long)i * w, w);
    }
  }
  if (__syncthreads_or(out_of_range) && threadIdx.x == 0)
    atomicOr(reinterpret_cast<unsigned long long*>(buf) + 2, 1ULL);
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// ts int64[n], valid uint8[n] (torch.bool storage), types int8[n]; ncols
// columns given by host arrays of device pointers, byte widths (1, 2, 4, 8)
// and byte offsets into buf; buf uint8 of the layout's size; scratch
// int64[2 * ceil(n / 1024)].
SIDDHI_API int k12a_wire_pack(const long long* ts, const uint8_t* valid,
                              const int8_t* types, int n, int ncols,
                              const void* const* col_ptrs,
                              const int* col_widths,
                              const long long* col_offsets, long long dts_off,
                              long long hi_off, long long flags_off,
                              uint8_t* buf, long long* scratch,
                              cudaStream_t stream) {
  if (ncols < 0 || ncols > MAX_COLS || n < 0)
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
  const int nblocks = static_cast<int>(siddhi_blocks(n, BLOCK));
  long long* block_cnt = scratch;
  long long* block_min_ts = scratch + nblocks;
  if (nblocks > 0) {
    k12a_count<<<nblocks, BLOCK, 0, stream>>>(ts, valid, n, block_cnt,
                                              block_min_ts);
    const int rc = siddhi_launch_status();
    if (rc) return rc;
  }
  k12a_header<<<1, BLOCK, 0, stream>>>(block_cnt, block_min_ts, nblocks,
                                       reinterpret_cast<long long*>(buf));
  int rc = siddhi_launch_status();
  if (rc || nblocks == 0) return rc;
  k12a_scatter<<<nblocks, BLOCK, 0, stream>>>(ts, valid, types, n, cols,
                                              block_cnt, dts_off, hi_off,
                                              flags_off, buf);
  return siddhi_launch_status();
}
