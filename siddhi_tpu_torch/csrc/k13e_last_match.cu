// K13e — the last matching event of each table row, in one pass over the
// [B, C] condition mask.
//
// Replaces the reductions of siddhi_tpu/core/table.py
// `TableOutputExecutor._make` (:361-383) and `contains_probe` (:258-261):
//   has[c]        = mask.any(axis=0)
//   b_star[c]     = (B - 1) - argmax(mask[::-1, :], axis=0)
//                   (the last b with mask[b, c]; B - 1 where none)
//   ev_matched[b] = mask.any(axis=1)
// The update applies the last matching event per row, delete clears the
// rows with `has`, update-or-insert inserts the events with no match, and
// a non-indexed `in` probe is `ev_matched`.
//
// k13e_scan: one thread a column, a 2-D grid (columns x chunks of ROWS
// events). Each thread walks its chunk from the last event down; the first
// true it meets is its chunk's last match, folded into last[c] with one
// atomicMax (a max does not depend on the order the chunks land in, so the
// result is exact). A warp ballot per event stores 1 into ev_matched[b]
// once a warp (every writer stores the same value). k13e_finish turns
// last[c] (-1 where none) into has and b_star.
//
// Bound on the H100: bytes — the mask read once (B x C bytes: 512 MiB at
// app AD's B = 8,192, C = 65,536, 0.16 ms at 3.35 TB/s) and the three
// outputs written once. Neighbouring threads read neighbouring columns of
// one event, so each warp load is one 32-byte sector.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;  // columns a block
constexpr int ROWS = 256;   // events a block walks

__global__ void k13e_scan(const bool* __restrict__ mask, int B, long long C,
                          int* __restrict__ last, bool* __restrict__ ev) {
  const long long c = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool live = c < C;
  const int b_lo = blockIdx.y * ROWS;
  const int b_hi = min(B, b_lo + ROWS) - 1;
  int found = -1;
#pragma unroll 8
  for (int b = b_hi; b >= b_lo; --b) {  // the same trip count warp-wide
    const bool m = live && mask[static_cast<long long>(b) * C + c];
    if (m && found < 0) found = b;
    if (__ballot_sync(0xffffffffu, m) && (threadIdx.x & 31) == 0)
      ev[b] = true;
  }
  if (found >= 0) atomicMax(&last[c], found);
}

__global__ void k13e_finish(const int* __restrict__ last, int B, long long C,
                            bool* __restrict__ has, int* __restrict__ b_star) {
  const long long c = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (c >= C) return;
  const int l = last[c];
  has[c] = l >= 0;
  b_star[c] = l >= 0 ? l : B - 1;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// k13e_last_match: mask bool[B, C] row-major; last int32[C] scratch filled
// with -1 and ev bool[B] zeroed by the caller; has bool[C], b_star
// int32[C] out.
SIDDHI_API int k13e_last_match(const bool* mask, int B, long long C,
                               int* last, bool* has, int* b_star, bool* ev,
                               cudaStream_t stream) {
  if (B < 1 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  dim3 grid(siddhi_blocks(C, BLOCK), siddhi_blocks(B, ROWS));
  k13e_scan<<<grid, BLOCK, 0, stream>>>(mask, B, C, last, ev);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k13e_finish<<<siddhi_blocks(C, BLOCK), BLOCK, 0, stream>>>(last, B, C, has,
                                                             b_star);
  return siddhi_launch_status();
}
