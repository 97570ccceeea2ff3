// K5 / K5b — segmented scans with carry-in (the aggregate step).
//
// K5 replaces siddhi_tpu/ops/groupby.py `_segment_plan` + `grouped_scan_fused`
// (+ `invert_permutation`): many sum components sharing one sort and one
// epoch table; without GROUP BY, `ungrouped_scan_fused` (the same over one
// slot, no sort). K5b replaces `grouped_scan` / `_scan_component` (op sum,
// min or max, one component with its own epoch table) and `ungrouped_scan`
// (one slot, lanes in arrival order, no sort); `running_count` is K5b's
// ungrouped sum of a bool mask onto a base.
//
// One launch scans every component it is given over one plan: K5b one
// component of its type under its op (tiles of 256 threads x 8 lanes), K5
// up to four sum components of any of the four types at once (256 x 4
// lanes; the plan is read once for all of them). Lanes are thread-blocked
// (a thread scans its lanes in series):
//   grouped    the wrapper's stable sort of the sentinel-masked slots (K7,
//              int32) gives `order`; each lane reads its slot and epoch (the
//              thread's neighbours across its ends once): a segment starts
//              on a (slot, epoch) change, a slot run's last lane writes the
//              state, a segment start under a live epoch carries the stored
//              value in;
//   ungrouped  lanes in order; a segment starts at lane 0 and at each reset,
//              the lane epochs are the current epoch plus the running count
//              of the resets, the live epoch is read from the cell, the last
//              lane writes the cell.
// The segmented scan runs in registers (a thread's lanes in series, then a
// warp-shuffle scan over the threads, then over the warps); a tile's
// aggregate goes to the aggregates buffer under a flag (release / acquire).
// Tiles are claimed in launch order through an atomic counter, so every
// earlier tile has started and publishes its aggregate without waiting: a
// tile then waits for all the aggregates before it and folds them in a
// fixed tree order (never another tile's running prefix). The association
// of every float sum is therefore a function of the inputs alone: the same
// inputs give the same bits on every run. Integer sums, min and max are
// exact in any order.
// State safety without a second launch: the stored value and epoch of a slot
// are read only at its segment starts, in tiles at or before the tile of the
// slot run's end, before they publish; the run end writes after its tile
// has seen every earlier tile's flag. The workspace (tile counter, done
// counter, flags) is zero on entry, and the last tile to finish zeroes it
// again, so no launch clears it; the wrapper keeps one per stream. The
// tile aggregates live in a buffer of their own: a small launch's
// aggregates must never sit where a larger launch expects zero flags.
//
// Bound on the H100: bytes. Per lane it reads the valid byte and, grouped,
// the sort permutation and the slot and epoch of the lane; per lane and
// component the delta in and one output out. The state gathers at segment
// starts are sparse. The design reads every input once, writes no lane
// array between launches, and pays its fixed latency (tile claim, flag,
// fold, done count) once for all of a plan's sum components.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int NWARP = BLOCK / 32;
constexpr int MAX_FUSED = 4;

// One component of type T under Op (K5b, running counts).
template <typename Op, typename T>
struct Typed {
  static constexpr int N = 1;
  static constexpr int ITEMS = 8;
  using V = T;
  const T* deltas;     // null: 1 for each valid lane (running count)
  const T* values_in;  // null: the op's identity
  T* values_out;
  T* out;
  __device__ __forceinline__ V identity(int) const {
    return Op::template identity<T>();
  }
  __device__ __forceinline__ V apply(int, V a, V b) const {
    return Op::apply(a, b);
  }
  __device__ __forceinline__ V delta(int, int64_t lane) const {
    return deltas != nullptr ? deltas[lane] : T(1);
  }
  __device__ __forceinline__ V stored(int, int slot) const {
    return values_in != nullptr ? values_in[slot] : identity(0);
  }
  __device__ __forceinline__ void put(int, int64_t lane, V y) const {
    out[lane] = y;
  }
  __device__ __forceinline__ void keep(int, int slot, V y) const {
    values_out[slot] = y;
  }
};

// C sum components (K5), each float32 (0), float64 (1), int64 (2) or int32
// (3), added in its own type; a value travels as its 64 bits (an int32 as
// an int64, cut back when stored: the same sum modulo 2^32).
template <int C>
struct FusedSum {
  static constexpr int N = C;
  static constexpr int ITEMS = 4;
  using V = unsigned long long;
  int dtype[C];
  const void* deltas[C];
  void* values[C];  // read at segment starts, written at slot-run ends
  void* out[C];
  __device__ __forceinline__ V identity(int) const { return 0ull; }
  __device__ __forceinline__ V apply(int i, V a, V b) const {
    switch (dtype[i]) {
      case 0:
        return __float_as_uint(__uint_as_float(static_cast<unsigned>(a)) +
                               __uint_as_float(static_cast<unsigned>(b)));
      case 1:
        return static_cast<V>(__double_as_longlong(
            __longlong_as_double(static_cast<long long>(a)) +
            __longlong_as_double(static_cast<long long>(b))));
      default:
        return a + b;
    }
  }
  __device__ __forceinline__ V load(int i, const void* base,
                                    int64_t at) const {
    switch (dtype[i]) {
      case 0:
        return __float_as_uint(static_cast<const float*>(base)[at]);
      case 1:
        return static_cast<V>(
            __double_as_longlong(static_cast<const double*>(base)[at]));
      case 2:
        return static_cast<V>(static_cast<const long long*>(base)[at]);
      default:
        return static_cast<V>(
            static_cast<long long>(static_cast<const int*>(base)[at]));
    }
  }
  __device__ __forceinline__ void store(int i, void* base, int64_t at,
                                        V y) const {
    switch (dtype[i]) {
      case 0:
        static_cast<float*>(base)[at] =
            __uint_as_float(static_cast<unsigned>(y));
        break;
      case 1:
        static_cast<double*>(base)[at] =
            __longlong_as_double(static_cast<long long>(y));
        break;
      case 2:
        static_cast<long long*>(base)[at] = static_cast<long long>(y);
        break;
      default:
        static_cast<int*>(base)[at] = static_cast<int>(y);
    }
  }
  __device__ __forceinline__ V delta(int i, int64_t lane) const {
    return load(i, deltas[i], lane);
  }
  __device__ __forceinline__ V stored(int i, int slot) const {
    return load(i, values[i], slot);
  }
  __device__ __forceinline__ void put(int i, int64_t lane, V y) const {
    store(i, out[i], lane, y);
  }
  __device__ __forceinline__ void keep(int i, int slot, V y) const {
    store(i, values[i], slot, y);
  }
};

template <typename P>
struct Seg {
  int f;                  // a segment start lies in the combined range
  int r;                  // resets in the range (ungrouped lane epochs)
  typename P::V s[P::N];  // op-scan since the last segment start
  typename P::V c[P::N];  // carry-in of the last segment start (grouped)
};

template <typename P>
__device__ __forceinline__ Seg<P> seg_identity(const P& pol) {
  Seg<P> x;
  x.f = 0;
  x.r = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) x.s[i] = x.c[i] = pol.identity(i);
  return x;
}

template <typename P>
__device__ __forceinline__ Seg<P> seg_combine(const P& pol, const Seg<P>& a,
                                              const Seg<P>& b) {
  Seg<P> x;
  x.f = a.f | b.f;
  x.r = static_cast<int>(static_cast<unsigned>(a.r) +
                         static_cast<unsigned>(b.r));
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    x.s[i] = b.f ? b.s[i] : pol.apply(i, a.s[i], b.s[i]);
    x.c[i] = b.f ? b.c[i] : a.c[i];
  }
  return x;
}

template <typename P>
__device__ __forceinline__ Seg<P> seg_shfl_up(const Seg<P>& x, int o) {
  Seg<P> y;
  y.f = __shfl_up_sync(0xffffffffu, x.f, o);
  y.r = __shfl_up_sync(0xffffffffu, x.r, o);
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    y.s[i] = __shfl_up_sync(0xffffffffu, x.s[i], o);
    y.c[i] = __shfl_up_sync(0xffffffffu, x.c[i], o);
  }
  return y;
}

// Exclusive scan of one Seg a thread over the block, in thread order;
// `*total` gets the block's combination. A fixed tree: the same inputs give
// the same association.
template <typename P>
__device__ __forceinline__ Seg<P> block_exclusive(const P& pol, Seg<P> x,
                                                  Seg<P>* smem,
                                                  Seg<P>* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg<P> y = seg_shfl_up(x, o);
    if (lane >= o) x = seg_combine(pol, y, x);
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Seg<P> w = lane < NWARP ? smem[lane] : seg_identity(pol);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Seg<P> y = seg_shfl_up(w, o);
      if (lane >= o) w = seg_combine(pol, y, w);
    }
    if (lane < NWARP) smem[lane] = w;
  }
  __syncthreads();
  // exclusive: the warps before, then the lanes before in this warp
  const Seg<P> before = seg_shfl_up(x, 1);
  Seg<P> ex = warp > 0 ? smem[warp - 1] : seg_identity(pol);
  if (lane > 0) ex = seg_combine(pol, ex, before);
  *total = smem[NWARP - 1];
  __syncthreads();  // smem is reused by the next call
  return ex;
}

// Publish a flag after this thread's writes (and what the block's barrier
// ordered before them); read one before the writes it guards.
__device__ __forceinline__ void store_release(unsigned* a, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(a), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a)
               : "memory");
  return v;
}

template <typename P>
struct Args {
  int n, K;
  const uint8_t* valid;  // null: every lane valid
  // grouped: the sort permutation and each lane's slot and epoch
  const int32_t* order;
  const int32_t* slots_v;
  const int32_t* lane_epoch;
  // ungrouped: resets (kind 0 none, 1 bytes, 2 int32), current epoch
  const void* resets;
  int resets_kind;
  const int32_t* cur_epoch;  // 0-d; null: 0
  const int32_t* epoch_in;   // epoch table / cell; null: always live
  int32_t* epoch_out;        // null: this launch leaves the epochs
  unsigned* ws;              // [0] tile counter, [1] done, [2..] flags
  // the tile aggregates: s[N][T], c[N][T] (V), then f[T], r[T] (int)
  typename P::V* agg;
  P pol;
};

template <typename P, bool GROUPED>
__global__ void __launch_bounds__(BLOCK) k5_scan(Args<P> a) {
  using V = typename P::V;
  constexpr int N = P::N;
  constexpr int ITEMS = P::ITEMS;
  constexpr int TILE = BLOCK * ITEMS;
  __shared__ Seg<P> smem[NWARP];
  __shared__ unsigned s_tile;
  __shared__ int s_last;
  const P pol = a.pol;  // in registers, not the parameter space
  const int tid = threadIdx.x;
  const int tiles = gridDim.x;
  unsigned* flags = a.ws + 2;
  V* agg_s = a.agg;
  V* agg_c = agg_s + static_cast<size_t>(N) * tiles;
  int* agg_f = reinterpret_cast<int*>(agg_c + static_cast<size_t>(N) * tiles);
  int* agg_r = agg_f + tiles;
  if (tid == 0) s_tile = atomicAdd(&a.ws[0], 1u);
  // ungrouped: the cell and the epochs, read before this tile publishes
  V cell[N];
  int cell_e = 0, cur = 0;
  if (!GROUPED) {
#pragma unroll
    for (int i = 0; i < N; ++i) cell[i] = pol.stored(i, 0);
    if (a.epoch_in != nullptr) cell_e = a.epoch_in[0];
    if (a.cur_epoch != nullptr) cur = a.cur_epoch[0];
  }
  __syncthreads();
  const int t = static_cast<int>(s_tile);
  const long long first = static_cast<long long>(t) * TILE + tid * ITEMS;

  Seg<P> x[ITEMS];
  int64_t lane[ITEMS];
  int wslot[ITEMS], lep[ITEMS], slot[ITEMS];
  // grouped: the thread's lanes in sort order, their slots and epochs, and
  // the neighbours across the thread's ends (-1 past the batch's ends)
  int ps = -1, pe = -1, ns = -1;
  if (GROUPED) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = first + k;
      lane[k] = i;
      slot[k] = -1;
      lep[k] = -1;
      if (i < a.n) {
        lane[k] = a.order[i];
        slot[k] = a.slots_v[lane[k]];
        lep[k] = a.lane_epoch[lane[k]];
      }
    }
    if (first > 0 && first <= a.n) {
      const int64_t pl = a.order[first - 1];
      ps = a.slots_v[pl];
      pe = a.lane_epoch[pl];
    }
    if (first + ITEMS < a.n) ns = a.slots_v[a.order[first + ITEMS]];
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = first + k;
    x[k] = seg_identity(pol);
    wslot[k] = a.K;
    if (!GROUPED) lane[k] = i;
    if (i >= a.n) continue;
    if (GROUPED) {
      const int s = slot[k];
      const int e = lep[k];
      const int prev_s = k > 0 ? slot[k - 1] : ps;
      const int prev_e = k > 0 ? lep[k - 1] : pe;
      const int next_s = k + 1 < ITEMS ? slot[k + 1] : ns;
      x[k].f = (s != prev_s) || (e != prev_e);
      wslot[k] = (s < a.K && s != next_s) ? s : a.K;
      if (x[k].f && s < a.K && a.epoch_in[s] == e) {
#pragma unroll
        for (int c = 0; c < N; ++c) x[k].c[c] = pol.stored(c, s);
      }
    } else {
      int r = 0;
      if (a.resets_kind == 1)
        r = static_cast<const uint8_t*>(a.resets)[i];
      else if (a.resets_kind == 2)
        r = static_cast<const int32_t*>(a.resets)[i];
      x[k].r = r;
      x[k].f = i == 0 || r != 0;
    }
    if (a.valid == nullptr || a.valid[lane[k]]) {
#pragma unroll
      for (int c = 0; c < N; ++c) x[k].s[c] = pol.delta(c, lane[k]);
    }
  }
  // the thread's lanes in series, then the threads of the tile
#pragma unroll
  for (int k = 1; k < ITEMS; ++k) x[k] = seg_combine(pol, x[k - 1], x[k]);
  Seg<P> tile_total;
  const Seg<P> thread_ex = block_exclusive(pol, x[ITEMS - 1], smem,
                                           &tile_total);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      agg_s[c * tiles + t] = tile_total.s[c];
      agg_c[c * tiles + t] = tile_total.c[c];
    }
    agg_f[t] = tile_total.f;
    agg_r[t] = tile_total.r;
    store_release(flags + t, 1u);
  }
  // every earlier tile's aggregate, folded in a fixed tree order
  Seg<P> prefix = seg_identity(pol);
  for (int c0 = 0; c0 < t; c0 += BLOCK) {
    const int j = c0 + tid;
    Seg<P> g = seg_identity(pol);
    if (j < t) {
      while (load_acquire(flags + j) == 0u) {
      }
#pragma unroll
      for (int c = 0; c < N; ++c) {
        g.s[c] = __ldcg(agg_s + c * tiles + j);
        g.c[c] = __ldcg(agg_c + c * tiles + j);
      }
      g.f = __ldcg(agg_f + j);
      g.r = __ldcg(agg_r + j);
    }
    Seg<P> chunk;
    block_exclusive(pol, g, smem, &chunk);
    prefix = seg_combine(pol, prefix, chunk);
  }
  const Seg<P> head = seg_combine(pol, prefix, thread_ex);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = first + k;
    if (i >= a.n) continue;
    const Seg<P> v = seg_combine(pol, head, x[k]);
    if (GROUPED) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const V y = pol.apply(c, v.c[c], v.s[c]);
        pol.put(c, lane[k], y);
        if (wslot[k] < a.K) pol.keep(c, wslot[k], y);
      }
      if (wslot[k] < a.K && a.epoch_out != nullptr)
        a.epoch_out[wslot[k]] = lep[k];
    } else {
      const int e = static_cast<int>(static_cast<unsigned>(cur) +
                                     static_cast<unsigned>(v.r));
      const bool live = a.epoch_in == nullptr || cell_e == e;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const V y = pol.apply(c, live ? cell[c] : pol.identity(c), v.s[c]);
        pol.put(c, i, y);
        if (i == a.n - 1) pol.keep(c, 0, y);
      }
      if (i == a.n - 1 && a.epoch_out != nullptr) a.epoch_out[0] = e;
    }
  }
  // the last tile to finish leaves the workspace zeroed
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&a.ws[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (unsigned j = tid; j < gridDim.x; j += BLOCK) flags[j] = 0u;
    if (tid == 0) {
      a.ws[0] = 0u;
      a.ws[1] = 0u;
    }
  }
}

template <typename P, bool GROUPED>
int launch(Args<P> a, void* ws, void* agg, cudaStream_t stream) {
  if (a.n <= 0) return 0;
  const int tiles = static_cast<int>(siddhi_blocks(a.n, BLOCK * P::ITEMS));
  a.ws = static_cast<unsigned*>(ws);
  a.agg = static_cast<typename P::V*>(agg);
  k5_scan<P, GROUPED><<<tiles, BLOCK, 0, stream>>>(a);
  return siddhi_launch_status();
}

// The same arguments under op 0 (sum), 1 (min) or 2 (max).
template <typename T, bool GROUPED>
int launch_op(int op, const Args<Typed<OpSum, T>>& a, void* ws, void* agg,
              cudaStream_t stream) {
  auto as = [&](auto op_tag) {
    using Op = decltype(op_tag);
    Args<Typed<Op, T>> b{};
    b.n = a.n;
    b.K = a.K;
    b.valid = a.valid;
    b.order = a.order;
    b.slots_v = a.slots_v;
    b.lane_epoch = a.lane_epoch;
    b.resets = a.resets;
    b.resets_kind = a.resets_kind;
    b.cur_epoch = a.cur_epoch;
    b.epoch_in = a.epoch_in;
    b.epoch_out = a.epoch_out;
    b.pol.deltas = a.pol.deltas;
    b.pol.values_in = a.pol.values_in;
    b.pol.values_out = a.pol.values_out;
    b.pol.out = a.pol.out;
    return launch<Typed<Op, T>, GROUPED>(b, ws, agg, stream);
  };
  switch (op) {
    case 0:
      return as(OpSum{});
    case 1:
      return as(OpMin{});
    case 2:
      return as(OpMax{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
Args<Typed<OpSum, T>> typed_args(int n, int K, const void* deltas,
                                 const uint8_t* valid,
                                 const int32_t* epoch_in, int32_t* epoch_out,
                                 const void* values_in, void* values_out,
                                 void* out) {
  Args<Typed<OpSum, T>> a{};
  a.n = n;
  a.K = K;
  a.valid = valid;
  a.epoch_in = epoch_in;
  a.epoch_out = epoch_out;
  a.pol.deltas = static_cast<const T*>(deltas);
  a.pol.values_in = static_cast<const T*>(values_in);
  a.pol.values_out = static_cast<T*>(values_out);
  a.pol.out = static_cast<T*>(out);
  return a;
}

// A fused launch of `count` (1..4) sum components: `fill` sets the plan
// arguments, the host arrays the components.
template <bool GROUPED, typename Fill>
int fused(int count, Fill fill, const int* dtypes, const void* const* deltas,
          void* const* values, void* const* out, void* ws, void* agg,
          cudaStream_t stream) {
  for (int i = 0; i < count; ++i)
    if (dtypes[i] < 0 || dtypes[i] > 3)
      return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto a) {
    for (int i = 0; i < decltype(a.pol)::N; ++i) {
      a.pol.dtype[i] = dtypes[i];
      a.pol.deltas[i] = deltas[i];
      a.pol.values[i] = values[i];
      a.pol.out[i] = out[i];
    }
    fill(a);
    return launch<decltype(a.pol), GROUPED>(a, ws, agg, stream);
  };
  switch (count) {
    case 1:
      return go(Args<FusedSum<1>>{});
    case 2:
      return go(Args<FusedSum<2>>{});
    case 3:
      return go(Args<FusedSum<3>>{});
    case 4:
      return go(Args<FusedSum<4>>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Lanes a tile: one component (K5b, running counts), or a fused launch.
SIDDHI_API int k5_tile_lanes(int fused_launch) {
  return BLOCK * (fused_launch ? FusedSum<1>::ITEMS
                               : Typed<OpSum, int>::ITEMS);
}

// Most sum components one fused launch takes.
SIDDHI_API int k5_max_fused() { return MAX_FUSED; }

// One grouped component (K5b grouped). op: 0 = sum, 1 = min, 2 = max.
// dtype: 0 = float32, 1 = float64, 2 = int64, 3 = int32. order: int32[n],
// the stable sort of slots_v (int32[n], invalid lanes at K); lane_epoch
// int32[n]; epoch_in int32[K]; epoch_out: the same table, or null to leave
// it; values [K] read and written in place; out [n] in lane order. ws: the
// zeroed workspace; agg: the aggregates buffer.
SIDDHI_API int k5_grouped_component(int op, int dtype, const void* deltas,
                                    const uint8_t* valid,
                                    const int32_t* order,
                                    const int32_t* slots_v,
                                    const int32_t* lane_epoch,
                                    const int32_t* epoch_in,
                                    int32_t* epoch_out, void* values,
                                    void* out, void* ws, void* agg, int K,
                                    int n, cudaStream_t stream) {
#define SIDDHI_K5_GROUPED(code, T)                                          \
  case code: {                                                              \
    auto a = typed_args<T>(n, K, deltas, valid, epoch_in, epoch_out,        \
                           values, values, out);                            \
    a.order = order;                                                        \
    a.slots_v = slots_v;                                                    \
    a.lane_epoch = lane_epoch;                                              \
    return launch_op<T, true>(op, a, ws, agg, stream);                      \
  }
  switch (dtype) {
    SIDDHI_K5_GROUPED(0, float)
    SIDDHI_K5_GROUPED(1, double)
    SIDDHI_K5_GROUPED(2, long long)
    SIDDHI_K5_GROUPED(3, int)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIDDHI_K5_GROUPED
}

// One ungrouped component (K5b ungrouped): lanes in order; resets: null
// (kind 0), bytes (kind 1) or int32 (kind 2) [n]; cur_epoch int32 0-d;
// epoch_cell int32[1] read; epoch_out the same cell, or null to leave it;
// values [1] in place.
SIDDHI_API int k5_ungrouped_component(int op, int dtype, const void* deltas,
                                      const uint8_t* valid,
                                      const void* resets, int resets_kind,
                                      const int32_t* cur_epoch,
                                      const int32_t* epoch_cell,
                                      int32_t* epoch_out, void* values,
                                      void* out, void* ws, void* agg, int n,
                                      cudaStream_t stream) {
  if (resets_kind < 0 || resets_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define SIDDHI_K5_UNGROUPED(code, T)                                        \
  case code: {                                                              \
    auto a = typed_args<T>(n, 1, deltas, valid, epoch_cell, epoch_out,      \
                           values, values, out);                            \
    a.resets = resets;                                                      \
    a.resets_kind = resets_kind;                                            \
    a.cur_epoch = cur_epoch;                                                \
    return launch_op<T, false>(op, a, ws, agg, stream);                     \
  }
  switch (dtype) {
    SIDDHI_K5_UNGROUPED(0, float)
    SIDDHI_K5_UNGROUPED(1, double)
    SIDDHI_K5_UNGROUPED(2, long long)
    SIDDHI_K5_UNGROUPED(3, int)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIDDHI_K5_UNGROUPED
}

// K5: `count` (1..4) sum components over one grouped plan in one launch.
// dtypes, deltas, values, out: host arrays of `count` (a dtype code, the
// component's deltas [n], its values [K] in place, its outputs [n]). The
// plan arguments are those of k5_grouped_component.
SIDDHI_API int k5_grouped_fused(int count, const int* dtypes,
                                const void* const* deltas,
                                const uint8_t* valid, const int32_t* order,
                                const int32_t* slots_v,
                                const int32_t* lane_epoch,
                                const int32_t* epoch_in, int32_t* epoch_out,
                                void* const* values, void* const* out,
                                void* ws, void* agg, int K, int n,
                                cudaStream_t stream) {
  return fused<true>(
      count,
      [&](auto& a) {
        a.n = n;
        a.K = K;
        a.valid = valid;
        a.order = order;
        a.slots_v = slots_v;
        a.lane_epoch = lane_epoch;
        a.epoch_in = epoch_in;
        a.epoch_out = epoch_out;
      },
      dtypes, deltas, values, out, ws, agg, stream);
}

// K5 without GROUP BY: `count` (1..4) sum components over one ungrouped
// plan in one launch; the plan arguments are those of
// k5_ungrouped_component, the components those of k5_grouped_fused (values
// [1] each).
SIDDHI_API int k5_ungrouped_fused(int count, const int* dtypes,
                                  const void* const* deltas,
                                  const uint8_t* valid, const void* resets,
                                  int resets_kind, const int32_t* cur_epoch,
                                  const int32_t* epoch_cell,
                                  int32_t* epoch_out, void* const* values,
                                  void* const* out, void* ws, void* agg,
                                  int n, cudaStream_t stream) {
  if (resets_kind < 0 || resets_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return fused<false>(
      count,
      [&](auto& a) {
        a.n = n;
        a.K = 1;
        a.valid = valid;
        a.resets = resets;
        a.resets_kind = resets_kind;
        a.cur_epoch = cur_epoch;
        a.epoch_in = epoch_cell;
        a.epoch_out = epoch_out;
      },
      dtypes, deltas, values, out, ws, agg, stream);
}

// Running count of a bool mask [n] onto a base (`base` 0-d of the count
// type, null: 0): counts [n] inclusive, total 0-d the count after the last
// lane. dtype 2 = int64, 3 = int32.
SIDDHI_API int k5_running_count(const uint8_t* mask, const void* base,
                                int dtype, void* counts, void* total,
                                void* ws, void* agg, int n,
                                cudaStream_t stream) {
  switch (dtype) {
    case 2:
      return launch<Typed<OpSum, long long>, false>(
          typed_args<long long>(n, 1, nullptr, mask, nullptr, nullptr, base,
                                total, counts),
          ws, agg, stream);
    case 3:
      return launch<Typed<OpSum, int>, false>(
          typed_args<int>(n, 1, nullptr, mask, nullptr, nullptr, base, total,
                          counts),
          ws, agg, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
