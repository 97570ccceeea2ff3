// K9 HLL — the hll:distinctCount sketch: register update and per-group
// estimate.
//
// Replaces the `custom_scan` of siddhi_tpu/ops/aggregators.py
// `_make_hll_distinct_count` (:299-345) with its `_estimate` (:289-297).
// Each lane takes K3's 64-bit hash of its value (the K3 kernel, bit-exact
// with the JAX package), mixes it with murmur3's fmix64 in unsigned 64-bit
// arithmetic, picks register j = h & (M - 1) and the rank rho = clz of the
// LOW 32 bits of h >> log2(M), plus one (a zero word gives 33), and
// max-updates regs[slot * M + j] for CURRENT lanes whose group slot is
// below G (`dropped` counts the valid CURRENT lanes past G on the device).
// RESET lanes split the chunk as the JAX code does: lanes before the first
// reset update the incoming registers and read their estimate (est_a);
// after a reset the registers start from zero, lanes from the last reset on
// update them and every other lane reads that estimate (est_b). An integer
// max commutes, so the registers are bit-exact whatever the order of the
// atomics.
//
// The estimate: alpha * M^2 / sum(2^-R) with the small-range linear
// counting correction, in float32, rounded half to even (rintf, as
// jnp.round). Only the groups that some lane of the chunk reads are
// estimated: one block a group reduces its M registers. The float32 sum
// runs in another order than XLA's, so an estimate may differ from the
// JAX package's by rounding; the registers and `dropped` do not.
//
// Bound on the H100: bytes. A call must read the lanes' hashes, slots,
// signs, valid and reset flags and write L estimates; the registers it
// touches (at most G * M = 4096 * 1024 int32) are read once for each
// estimate and, after a reset, rewritten. Launches: the reset bounds (one
// block), the update before the first reset, est_a plus the register reset
// (a block a group, both skipped without a reset), the update from the last
// reset on (`k9_hll_update`, four); est_b and the per-lane gather
// (`k9_hll_estimate`, two). No host sync: whether the chunk holds a reset
// is read on the device.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;

// bounds[0] = first reset lane (n without one), bounds[1] = last (-1).
__global__ void k9_bounds(const uint8_t* __restrict__ resets, int n,
                          int* __restrict__ bounds) {
  __shared__ int smin[32], smax[32];
  int lo = n, hi = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (resets[i]) {
      lo = min(lo, i);
      hi = max(hi, i);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smin[warp] = lo;
    smax[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    lo = lane < nw ? smin[lane] : n;
    hi = lane < nw ? smax[lane] : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_down_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_down_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      bounds[0] = lo;
      bounds[1] = hi;
    }
  }
}

// pass 0: lanes before the first reset (every lane without one); marks the
// group of every lane below G as read and counts the drops. pass 1: lanes
// from the last reset on, only when the chunk holds a reset.
__global__ void k9_update(const int64_t* __restrict__ hash,
                          const int32_t* __restrict__ slots,
                          const int32_t* __restrict__ sign,
                          const uint8_t* __restrict__ valid,
                          const int* __restrict__ bounds, int n, int G, int M,
                          int p_bits, int pass, int* __restrict__ regs,
                          uint8_t* __restrict__ touched,
                          unsigned long long* __restrict__ dropped) {
  __shared__ int sdrop[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int first = bounds[0], last = bounds[1];
  if (pass == 1 && first >= n) return;  // block-uniform
  int drop = 0;
  if (i < n) {
    const int s = slots[i];
    const bool in_cap = s >= 0 && s < G;
    const bool adds = valid[i] && sign[i] > 0;
    if (pass == 0) {
      if (in_cap) touched[s] = 1;
      drop = adds && !in_cap;
    }
    const bool sel = pass == 0 ? i < first : i >= last;
    if (adds && in_cap && sel) {
      uint64_t h = static_cast<uint64_t>(hash[i]);
      h ^= h >> 33;
      h *= 0xFF51AFD7ED558CCDull;
      h ^= h >> 33;
      h *= 0xC4CEB9FE1A85EC53ull;
      h ^= h >> 33;
      const int j = static_cast<int>(h & static_cast<uint64_t>(M - 1));
      const unsigned w = static_cast<unsigned>(h >> p_bits);
      const int rho = __clz(static_cast<int>(w)) + 1;
      atomicMax(&regs[static_cast<size_t>(s) * M + j], rho);
    }
  }
  if (pass == 0) {
    int total;
    block_exclusive_sum<BLOCK>(drop, sdrop, &total);
    if (threadIdx.x == 0 && total > 0) {
      atomicAdd(dropped, static_cast<unsigned long long>(total));
    }
  }
}

// One block a group. pass 0 (only with a reset): est_a of the groups read,
// then the group's registers are zeroed. pass 1: est_b of the groups read.
__global__ void k9_estimate(int* __restrict__ regs,
                            const uint8_t* __restrict__ touched,
                            const int* __restrict__ bounds, int n, int M,
                            int pass, float alpha_mm,
                            long long* __restrict__ est) {
  __shared__ float sinv[BLOCK / 32];
  __shared__ int szero[BLOCK / 32];
  const int g = blockIdx.x;
  if (pass == 0 && bounds[0] >= n) return;
  int* r = regs + static_cast<size_t>(g) * M;
  if (touched[g]) {
    float inv = 0.0f;
    int zeros = 0;
    for (int t = threadIdx.x; t < M; t += BLOCK) {
      const int R = r[t];
      inv += __int_as_float((127 - R) << 23);  // 2^-R, R in [0, 33]
      zeros += R == 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      inv += __shfl_down_sync(0xffffffffu, inv, o);
      zeros += __shfl_down_sync(0xffffffffu, zeros, o);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      sinv[warp] = inv;
      szero[warp] = zeros;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      inv = 0.0f;
      zeros = 0;
      for (int w = 0; w < BLOCK / 32; ++w) {
        inv += sinv[w];
        zeros += szero[w];
      }
      float E = alpha_mm / inv;
      const float Mf = static_cast<float>(M);
      const float lin = Mf * logf(Mf / static_cast<float>(max(zeros, 1)));
      if (E <= 2.5f * Mf && zeros > 0) E = lin;
      est[g] = static_cast<long long>(rintf(E));
    }
    __syncthreads();
  }
  if (pass == 0) {
    for (int t = threadIdx.x; t < M; t += BLOCK) r[t] = 0;
  }
}

__global__ void k9_emit(const int32_t* __restrict__ slots,
                        const int* __restrict__ bounds,
                        const long long* __restrict__ est_a,
                        const long long* __restrict__ est_b, int n, int G,
                        long long* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int s = slots[i];
  const int first = bounds[0];  // n when the chunk holds no reset
  long long v = 0;
  if (s >= 0 && s < G) v = (first < n && i < first) ? est_a[s] : est_b[s];
  out[i] = v;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// hash int64[n] (K3), slots/sign int32[n], valid/resets uint8[n]
// (torch.bool); regs int32[G * M] and dropped int64 updated in place;
// touched uint8[G] zeroed by the caller; bounds int32[2] and est_a
// int64[G] are left for k9_hll_estimate.
SIDDHI_API int k9_hll_update(const int64_t* hash, const int32_t* slots,
                             const int32_t* sign, const uint8_t* valid,
                             const uint8_t* resets, int n, int G, int M,
                             int p_bits, float alpha_mm, int* regs,
                             uint8_t* touched, int* bounds, long long* est_a,
                             long long* dropped, cudaStream_t stream) {
  if (n <= 0) return 0;
  k9_bounds<<<1, 1024, 0, stream>>>(resets, n, bounds);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  auto dropped_u = reinterpret_cast<unsigned long long*>(dropped);
  k9_update<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(
      hash, slots, sign, valid, bounds, n, G, M, p_bits, 0, regs, touched,
      dropped_u);
  rc = siddhi_launch_status();
  if (rc) return rc;
  k9_estimate<<<G, BLOCK, 0, stream>>>(regs, touched, bounds, n, M, 0,
                                       alpha_mm, est_a);
  rc = siddhi_launch_status();
  if (rc) return rc;
  k9_update<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(
      hash, slots, sign, valid, bounds, n, G, M, p_bits, 1, regs, touched,
      dropped_u);
  return siddhi_launch_status();
}

// est_b of the groups read, then out int64[n]: est_a for lanes before the
// first reset of a chunk that holds one, est_b otherwise, 0 past G.
SIDDHI_API int k9_hll_estimate(const int32_t* slots, int* regs,
                               const uint8_t* touched, const int* bounds,
                               const long long* est_a, long long* est_b,
                               int n, int G, int M, float alpha_mm,
                               long long* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  k9_estimate<<<G, BLOCK, 0, stream>>>(regs, touched, bounds, n, M, 1,
                                       alpha_mm, est_b);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k9_emit<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(
      slots, bounds, est_a, est_b, n, G, out);
  return siddhi_launch_status();
}
