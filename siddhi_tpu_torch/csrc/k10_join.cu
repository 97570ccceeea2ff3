// K10 — the stream-stream join's multimap and pair block.
//
// Replaces three functions of siddhi_tpu/ops/join.py:
//   multimap_append  (stage 3: the duplicate-free chained scatters) as
//                    k10_multimap_append — two launches, link then heads;
//   multimap_probe   as k10_multimap_probe — one thread per probe lane;
//   compact_pairs    as k10_compact_pairs — K1's three-launch compaction.
// The multimap indexes a window ring by ring position: heads i32[H] (the
// newest entry per bucket), nexts i32[C] (the next-older entry), slot_hash
// and slot_seq u32[C] (the row's key hash and arrival index mod 2^32).
// Every entry point is bit for bit with the JAX function.
//
// multimap_append: the wrapper gives the lanes in bucket order (K1's
// live-first order, then a stable torch.sort by bucket; dead lanes carry
// bucket H and sort last). Lane i of the sorted order is row j = run[i] of
// the live-first order, which the window stores at ring position
// (appended0 % C + j) wrapped once (B <= C), arrival index appended0 + j.
// It links to the previous lane of its bucket run, or, first in its run,
// to the bucket's old head; the run's last lane becomes the head. The old
// head is read by the link launch and the new one written by the heads
// launch, so no thread reads a head another thread writes. appended0 is
// read on the device.
//
// multimap_probe: walk heads[bucket], then nexts, k_max steps plus one
// truncation probe. An entry is live when 0 < appended - slot_seq <=
// window_len in u32 (wraparound ages), and ages must strictly increase
// along the walk, or it stops: a chain diverted through an overwritten
// slot jumps to a newer row. A hash mismatch keeps walking; a non-match
// writes position 0. Candidates come out reversed, oldest first.
// `truncated` counts lanes whose (k_max+1)-th entry is live (atomicAdd).
//
// compact_pairs: order-preserving compaction of P candidate lanes into
// pair_cap: per-block counts, one block scans the block totals (and keeps
// the total on the device), then a stable scatter with warp-shuffle ranks
// that also writes pv = lane < n and zeros lanes n..pair_cap.
//
// Bound on the H100: bytes, all three. append reads 3 words a lane and
// writes 3 words a live row plus a head per run; probe reads one head and
// up to k_max + 1 chain entries (12 bytes each) a lane, with no locality
// between steps (a dependent load chain: latency, not bandwidth, sets its
// pace), and writes 5 bytes per candidate; compact reads 9 bytes a lane
// twice and writes 9 bytes per kept lane.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int CBLOCK = 1024;

__device__ __forceinline__ int ring_pos(long long appended0, int C, int j) {
  int pos = static_cast<int>(appended0 % C) + j;
  return pos >= C ? pos - C : pos;
}

__global__ void append_link(const int32_t* __restrict__ b_s,
                            const int64_t* __restrict__ run,
                            const uint32_t* __restrict__ h_live_first,
                            int B, int H, int C,
                            const int64_t* __restrict__ appended0,
                            const int32_t* __restrict__ heads,
                            int32_t* __restrict__ nexts,
                            uint32_t* __restrict__ slot_hash,
                            uint32_t* __restrict__ slot_seq) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= B) return;
  const int b = b_s[i];
  if (b >= H) return;
  const long long a0 = appended0[0];
  const int j = static_cast<int>(run[i]);
  const int pos = ring_pos(a0, C, j);
  const int next = (i > 0 && b_s[i - 1] == b)
                       ? ring_pos(a0, C, static_cast<int>(run[i - 1]))
                       : heads[b];
  nexts[pos] = next;
  slot_hash[pos] = h_live_first[j];
  slot_seq[pos] = static_cast<uint32_t>(a0) + static_cast<uint32_t>(j);
}

__global__ void append_heads(const int32_t* __restrict__ b_s,
                             const int64_t* __restrict__ run, int B, int H,
                             int C, const int64_t* __restrict__ appended0,
                             int32_t* __restrict__ heads) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= B) return;
  const int b = b_s[i];
  if (b >= H || (i + 1 < B && b_s[i + 1] == b)) return;
  heads[b] = ring_pos(appended0[0], C, static_cast<int>(run[i]));
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

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// b_s: int32[B] sorted bucket keys (H = dead lane); run: int64[B] their
// positions in the live-first order; h_live_first: u32[B] the hashes in
// live-first order; appended0: int64[1]; heads int32[H], nexts int32[C],
// slot_hash/slot_seq u32[C], updated in place.
SIDDHI_API int k10_multimap_append(const int32_t* b_s, const int64_t* run,
                                   const uint32_t* h_live_first, int B,
                                   int H, int C, const int64_t* appended0,
                                   int32_t* heads, int32_t* nexts,
                                   uint32_t* slot_hash, uint32_t* slot_seq,
                                   cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > C) return static_cast<int>(cudaErrorInvalidValue);
  append_link<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(
      b_s, run, h_live_first, B, H, C, appended0, heads, nexts, slot_hash,
      slot_seq);
  const int rc = siddhi_launch_status();
  if (rc) return rc;
  append_heads<<<siddhi_blocks(B, BLOCK), BLOCK, 0, stream>>>(
      b_s, run, B, H, C, appended0, heads);
  return siddhi_launch_status();
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
