// K5 / K5b — segmented scans with carry-in (the aggregate step).
//
// K5 replaces siddhi_tpu/ops/groupby.py `_segment_plan` + `grouped_scan_fused`
// (+ `invert_permutation`): many sum components sharing one sort, one plan
// and one epoch table; without GROUP BY, `ungrouped_scan_fused` (the same
// over one slot, no sort). K5b replaces `grouped_scan` / `_scan_component`
// (op sum, min or max, one component with its own epoch table) and
// `ungrouped_scan` (one slot, lanes in arrival order, no sort). All three
// run the same machinery:
//   k5_plan            after the wrapper's stable torch.sort of the
//                      sentinel-masked slots, one pass over the sorted lanes:
//                      segment starts on a (slot, epoch) change, the
//                      slot-run ends that write state, and the epoch-live
//                      flag against the epoch table;
//   k5_ungrouped_plan  the same arrays for the single-slot case: lanes stay
//                      in order, a segment starts at lane 0 and at each lane
//                      epoch change, the last lane writes the state cell;
//   k5_pass1           per component: block-local segmented inclusive scan
//                      of the deltas under the op, carrying the stored value
//                      of the segment start (live epochs only, else the op's
//                      identity) along the segment;
//   k5_pass2           one thread chains the block aggregates into block
//                      carries;
//   k5_pass3           applies the block carry, writes each lane's
//                      post-update value op(carry, scan) in lane order
//                      (through the sort permutation when there is one),
//                      scatters the last value of each slot run into the
//                      state table and, when asked, the lane epochs into the
//                      epoch table.
// Integer components and min/max are exact. Float sums add in another order
// than XLA's associative_scan tree (warp-shuffle tree inside a block, block
// carry added in front), which the numeric-parity tolerance covers.
//
// Bound on the H100: bytes. Per lane and component it reads the delta and
// the sort permutation and writes one output; the gathers of the state table
// (K = 2^20 entries) at segment starts are random but sparse. Design: one
// element per thread and shared plan arrays, so the sort and the plan are
// paid once for every component; three short launches per component keep
// the block-carry chain simple and exact.

#include "common.cuh"

namespace {

constexpr int BLOCK = 512;

template <typename T>
struct Seg {
  int f;  // a segment start lies in the combined range
  T s;    // op-scan since the last segment start
  T c;    // carry-in of the last segment start
};

template <typename Op, typename T>
__device__ __forceinline__ Seg<T> seg_identity() {
  Seg<T> r;
  r.f = 0;
  r.s = Op::template identity<T>();
  r.c = Op::template identity<T>();
  return r;
}

template <typename Op, typename T>
__device__ __forceinline__ Seg<T> seg_combine(const Seg<T>& a,
                                              const Seg<T>& b) {
  Seg<T> r;
  r.f = a.f | b.f;
  r.s = b.f ? b.s : Op::apply(a.s, b.s);
  r.c = b.f ? b.c : a.c;
  return r;
}

template <typename T>
__device__ __forceinline__ Seg<T> seg_shfl_up(const Seg<T>& x, int o) {
  Seg<T> y;
  y.f = __shfl_up_sync(0xffffffffu, x.f, o);
  y.s = __shfl_up_sync(0xffffffffu, x.s, o);
  y.c = __shfl_up_sync(0xffffffffu, x.c, o);
  return y;
}

template <typename Op, typename T>
__device__ __forceinline__ Seg<T> block_seg_scan(Seg<T> x, Seg<T>* smem,
                                                 Seg<T>* total) {
  constexpr int NW = BLOCK / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg<T> y = seg_shfl_up(x, o);
    if (lane >= o) x = seg_combine<Op>(y, x);
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Seg<T> w = lane < NW ? smem[lane] : seg_identity<Op, T>();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Seg<T> y = seg_shfl_up(w, o);
      if (lane >= o) w = seg_combine<Op>(y, w);
    }
    if (lane < NW) smem[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = seg_combine<Op>(smem[warp - 1], x);
  *total = smem[NW - 1];
  return x;
}

__global__ void k5_plan(const int32_t* __restrict__ slots_v,
                        const int32_t* __restrict__ lane_epoch,
                        const int64_t* __restrict__ order,
                        const int32_t* __restrict__ shared_epoch, int K, int n,
                        int32_t* __restrict__ s_slot,
                        int32_t* __restrict__ s_epoch,
                        uint8_t* __restrict__ seg_start,
                        int32_t* __restrict__ write_slot,
                        uint8_t* __restrict__ epoch_live) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int64_t lane = order[i];
  const int s = slots_v[lane];
  const int e = lane_epoch[lane];
  int ps = -1, pe = -1, ns = -1;
  if (i > 0) {
    const int64_t pl = order[i - 1];
    ps = slots_v[pl];
    pe = lane_epoch[pl];
  }
  if (i + 1 < n) ns = slots_v[order[i + 1]];
  s_slot[i] = s;
  s_epoch[i] = e;
  seg_start[i] = (s != ps) || (e != pe);
  write_slot[i] = (s < K && s != ns) ? s : K;
  epoch_live[i] = s < K && shared_epoch[min(s, K - 1)] == e;
}

// Single slot (K = 1): the last lane writes the state cell.
__global__ void k5_ungrouped_plan(const int32_t* __restrict__ lane_epoch,
                                  const int32_t* __restrict__ epoch_cell,
                                  int n, int32_t* __restrict__ s_slot,
                                  int32_t* __restrict__ s_epoch,
                                  uint8_t* __restrict__ seg_start,
                                  int32_t* __restrict__ write_slot,
                                  uint8_t* __restrict__ epoch_live) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int e = lane_epoch[i];
  s_slot[i] = 0;
  s_epoch[i] = e;
  seg_start[i] = i == 0 || e != lane_epoch[i - 1];
  write_slot[i] = i == n - 1 ? 0 : 1;
  epoch_live[i] = epoch_cell[0] == e;
}

// `order` null: lanes are already in scan order (ungrouped).
template <typename Op, typename T>
__global__ void k5_pass1(const T* __restrict__ deltas,
                         const uint8_t* __restrict__ valid,
                         const int64_t* __restrict__ order,
                         const int32_t* __restrict__ s_slot,
                         const uint8_t* __restrict__ seg_start,
                         const uint8_t* __restrict__ epoch_live,
                         const T* __restrict__ values, int K, int n,
                         T* __restrict__ within, T* __restrict__ cseg,
                         uint8_t* __restrict__ pref_flag,
                         int* __restrict__ agg_f, T* __restrict__ agg_s,
                         T* __restrict__ agg_c) {
  __shared__ Seg<T> smem[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  Seg<T> x = seg_identity<Op, T>();
  if (i < n) {
    const int64_t lane = order != nullptr ? order[i] : i;
    x.f = seg_start[i];
    if (valid[lane]) x.s = deltas[lane];
    if (x.f && epoch_live[i]) x.c = values[min(s_slot[i], K - 1)];
  }
  Seg<T> total;
  x = block_seg_scan<Op>(x, smem, &total);
  if (i < n) {
    within[i] = x.s;
    cseg[i] = x.c;
    pref_flag[i] = x.f;
  }
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = total.f;
    agg_s[blockIdx.x] = total.s;
    agg_c[blockIdx.x] = total.c;
  }
}

// Exclusive chain of the block aggregates, in place: afterwards agg_s/agg_c
// hold what flows into each block from the blocks before it.
template <typename Op, typename T>
__global__ void k5_pass2(int* __restrict__ agg_f, T* __restrict__ agg_s,
                         T* __restrict__ agg_c, int nblocks) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  Seg<T> run = seg_identity<Op, T>();
  for (int b = 0; b < nblocks; ++b) {
    Seg<T> cur;
    cur.f = agg_f[b];
    cur.s = agg_s[b];
    cur.c = agg_c[b];
    agg_f[b] = run.f;
    agg_s[b] = run.s;
    agg_c[b] = run.c;
    run = seg_combine<Op>(run, cur);
  }
}

template <typename Op, typename T>
__global__ void k5_pass3(const T* __restrict__ within,
                         const T* __restrict__ cseg,
                         const uint8_t* __restrict__ pref_flag,
                         const T* __restrict__ carry_s,
                         const T* __restrict__ carry_c,
                         const int64_t* __restrict__ order,
                         const int32_t* __restrict__ write_slot,
                         const int32_t* __restrict__ s_epoch, int K, int n,
                         T* __restrict__ out, T* __restrict__ values,
                         int32_t* __restrict__ epoch_table) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  T w = within[i];
  T c = cseg[i];
  if (!pref_flag[i]) {  // the lane's segment started in an earlier block
    w = Op::apply(carry_s[blockIdx.x], w);
    c = carry_c[blockIdx.x];
  }
  const T v = Op::apply(c, w);
  out[order != nullptr ? order[i] : i] = v;
  const int ws = write_slot[i];
  if (ws < K) {
    values[ws] = v;
    if (epoch_table != nullptr) epoch_table[ws] = s_epoch[i];
  }
}

template <typename Op, typename T>
int run_component(const T* deltas, const uint8_t* valid, const int64_t* order,
                  const int32_t* s_slot, const uint8_t* seg_start,
                  const uint8_t* epoch_live, const int32_t* write_slot,
                  const int32_t* s_epoch, T* values, int32_t* epoch_table,
                  T* out, void* scratch, int K, int n, cudaStream_t stream) {
  const int nb = static_cast<int>(siddhi_blocks(n, BLOCK));
  // scratch layout: within[n] cseg[n] agg_s[nb] agg_c[nb] (T), agg_f[nb]
  // (int), pref_flag[n] (uint8)
  T* within = static_cast<T*>(scratch);
  T* cseg = within + n;
  T* agg_s = cseg + n;
  T* agg_c = agg_s + nb;
  int* agg_f = reinterpret_cast<int*>(agg_c + nb);
  uint8_t* pref_flag = reinterpret_cast<uint8_t*>(agg_f + nb);
  k5_pass1<Op, T><<<nb, BLOCK, 0, stream>>>(
      deltas, valid, order, s_slot, seg_start, epoch_live, values, K, n,
      within, cseg, pref_flag, agg_f, agg_s, agg_c);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k5_pass2<Op, T><<<1, 32, 0, stream>>>(agg_f, agg_s, agg_c, nb);
  rc = siddhi_launch_status();
  if (rc) return rc;
  k5_pass3<Op, T><<<nb, BLOCK, 0, stream>>>(within, cseg, pref_flag, agg_s,
                                            agg_c, order, write_slot, s_epoch,
                                            K, n, out, values, epoch_table);
  return siddhi_launch_status();
}

template <typename Op>
int run_typed(int dtype, const void* deltas, const uint8_t* valid,
              const int64_t* order, const int32_t* s_slot,
              const uint8_t* seg_start, const uint8_t* epoch_live,
              const int32_t* write_slot, const int32_t* s_epoch, void* values,
              int32_t* epoch_table, void* out, void* scratch, int K, int n,
              cudaStream_t stream) {
#define SIDDHI_K5_CASE(code, T)                                              \
  case code:                                                                 \
    return run_component<Op, T>(                                             \
        static_cast<const T*>(deltas), valid, order, s_slot, seg_start,      \
        epoch_live, write_slot, s_epoch, static_cast<T*>(values),            \
        epoch_table, static_cast<T*>(out), scratch, K, n, stream);
  switch (dtype) {
    SIDDHI_K5_CASE(0, float)
    SIDDHI_K5_CASE(1, double)
    SIDDHI_K5_CASE(2, long long)
    SIDDHI_K5_CASE(3, int)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIDDHI_K5_CASE
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k5_block_size() { return BLOCK; }

SIDDHI_API int k5_segment_plan(const int32_t* slots_v,
                               const int32_t* lane_epoch,
                               const int64_t* order,
                               const int32_t* shared_epoch, int K, int n,
                               int32_t* s_slot, int32_t* s_epoch,
                               uint8_t* seg_start, int32_t* write_slot,
                               uint8_t* epoch_live, cudaStream_t stream) {
  if (n <= 0) return 0;
  k5_plan<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(
      slots_v, lane_epoch, order, shared_epoch, K, n, s_slot, s_epoch,
      seg_start, write_slot, epoch_live);
  return siddhi_launch_status();
}

// The plan of `ungrouped_scan` and `ungrouped_scan_fused`: lane_epoch
// int32[n], epoch_cell int32[1].
SIDDHI_API int k5_ungrouped_segment_plan(const int32_t* lane_epoch,
                                         const int32_t* epoch_cell, int n,
                                         int32_t* s_slot, int32_t* s_epoch,
                                         uint8_t* seg_start,
                                         int32_t* write_slot,
                                         uint8_t* epoch_live,
                                         cudaStream_t stream) {
  if (n <= 0) return 0;
  k5_ungrouped_plan<<<siddhi_blocks(n, BLOCK), BLOCK, 0, stream>>>(
      lane_epoch, epoch_cell, n, s_slot, s_epoch, seg_start, write_slot,
      epoch_live);
  return siddhi_launch_status();
}

// op: 0 = sum, 1 = min, 2 = max. dtype: 0 = float32, 1 = float64,
// 2 = int64, 3 = int32. `order` is null for an ungrouped plan (lanes in
// order). `epoch_table` is null when this component does not write the
// epochs (all but the last of a fused step). Scratch must hold 2n + 2nb
// elements of the component type, nb ints and n bytes.
SIDDHI_API int k5_scan_component(int op, int dtype, const void* deltas,
                                 const uint8_t* valid, const int64_t* order,
                                 const int32_t* s_slot,
                                 const uint8_t* seg_start,
                                 const uint8_t* epoch_live,
                                 const int32_t* write_slot,
                                 const int32_t* s_epoch, void* values,
                                 int32_t* epoch_table, void* out,
                                 void* scratch, int K, int n,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (op) {
    case 0:
      return run_typed<OpSum>(dtype, deltas, valid, order, s_slot, seg_start,
                              epoch_live, write_slot, s_epoch, values,
                              epoch_table, out, scratch, K, n, stream);
    case 1:
      return run_typed<OpMin>(dtype, deltas, valid, order, s_slot, seg_start,
                              epoch_live, write_slot, s_epoch, values,
                              epoch_table, out, scratch, K, n, stream);
    case 2:
      return run_typed<OpMax>(dtype, deltas, valid, order, s_slot, seg_start,
                              epoch_live, write_slot, s_epoch, values,
                              epoch_table, out, scratch, K, n, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
