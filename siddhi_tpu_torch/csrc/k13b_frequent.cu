// K13b — the last lane per slot of the frequent windows.
//
// Replaces the conflicting scatter of siddhi_tpu/ops/windows_extra.py
// `FrequentWindow.step` (the remembered latest event per tracked slot):
//   last_lane = full((N + 1,), -1).at[scat_slot].max(lane)[:N]
//   has_new = last_lane >= 0
//   cols1[k] = where(has_new, comp_cols[k][last_lane], slot_cols[k])
//   ts1      = where(has_new, comp_ts[last_lane], slot_ts)
// Many lanes of one key land on one slot, so the scatter is a max over
// conflicting writes: one atomicMax of the lane index per lane into an
// int32[N + 1] table whose last row takes the untracked lanes (the JAX
// "drop" index). A max does not depend on the order the atomics land in,
// so the result is exact. A second launch then writes each slot's row:
// the new lane's values where one arrived, the remembered ones otherwise.
//
// Launches: init (last = -1), scatter (one thread a lane), gather (one
// thread a slot, every column). Columns are 1-, 4- or 8-byte, passed as
// one table of pointers by value (no upload).
//
// Bound on the H100: bytes — the slot ids read once (4B bytes), the old
// rows and the new rows (N rows each), the new lanes' rows (at most N).
// At B = 131072 and N = 10,000 that is ~0.7 MB, well under a microsecond
// at 3.35 TB/s; the three launches dominate.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_COLS = 32;

struct Columns {
  const void* src[MAX_COLS];  // the batch's compacted columns [B]
  const void* old[MAX_COLS];  // the slots' remembered rows [N]
  void* dst[MAX_COLS];        // the new remembered rows [N]
  int size[MAX_COLS];         // bytes a value: 1, 4 or 8
  int n;
};

__global__ void k13b_init(int* __restrict__ last, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) last[i] = -1;
}

__global__ void k13b_scatter(const int* __restrict__ slot, int B, int N,
                             int* __restrict__ last) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= B) return;
  const int s = slot[i];
  if (s >= 0 && s <= N) atomicMax(&last[s], i);
}

template <typename T>
__device__ __forceinline__ void copy_one(const void* src, const void* old,
                                         void* dst, int lane, int n) {
  const T v = lane >= 0 ? static_cast<const T*>(src)[lane]
                        : static_cast<const T*>(old)[n];
  static_cast<T*>(dst)[n] = v;
}

__global__ void k13b_gather(Columns cols, const int* __restrict__ last,
                            int N) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= N) return;
  const int lane = last[n];
  for (int c = 0; c < cols.n; ++c) {
    switch (cols.size[c]) {
      case 1:
        copy_one<uint8_t>(cols.src[c], cols.old[c], cols.dst[c], lane, n);
        break;
      case 4:
        copy_one<uint32_t>(cols.src[c], cols.old[c], cols.dst[c], lane, n);
        break;
      default:
        copy_one<unsigned long long>(cols.src[c], cols.old[c], cols.dst[c],
                                     lane, n);
    }
  }
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k13b_max_cols() { return MAX_COLS; }

// k13b_last_lane: init and scatter. slot: int32[B] device (N = untracked);
// last: int32[N + 1] device, out.
SIDDHI_API int k13b_last_lane(const int* slot, int B, int N, int* last,
                              cudaStream_t stream) {
  if (B < 0 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  k13b_init<<<siddhi_blocks(N + 1, BLOCK), BLOCK, 0, stream>>>(last, N + 1);
  int rc = siddhi_launch_status();
  if (rc || B == 0) return rc;
  k13b_scatter<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(slot, B, N,
                                                              last);
  return siddhi_launch_status();
}

// k13b_gather_rows: the new rows of up to MAX_COLS columns a launch.
// src/old/dst/sizes: n_cols host entries (device pointers, byte sizes).
SIDDHI_API int k13b_gather_rows(const int* last, int N,
                                const void* const* src,
                                const void* const* old, void* const* dst,
                                const int* sizes, int n_cols,
                                cudaStream_t stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (sizes[c] != 1 && sizes[c] != 4 && sizes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.src[c] = src[c];
    cols.old[c] = old[c];
    cols.dst[c] = dst[c];
    cols.size[c] = sizes[c];
  }
  k13b_gather<<<siddhi_blocks(N, BLOCK), BLOCK, 0, stream>>>(cols, last, N);
  return siddhi_launch_status();
}
