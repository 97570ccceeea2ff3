// K8 — removal-capable sliding min/max: for each chunk lane, the extremum
// of the window's arrival-order range [l, r) after that lane's add or
// remove.
//
// Replaces siddhi_tpu/ops/extrema.py `sliding_extrema_lanes` (:38) and
// `grouped_sliding_extrema_lanes` (:96). A FIFO window's contents at any
// lane are a contiguous range of the arrival sequence V: the ring rotated
// to the expiry frontier (V[p] = ring[(expired + p) % C] for p < C, the
// identity past C) with the chunk's k-th CURRENT value written at
// V[winlen0 + k]. Lane i's range is [#EXPIRED lanes <= i, winlen0 +
// #CURRENT lanes <= i). Grouped, the wrapper stably sorts the positions by
// their 64-bit group hash (one torch.sort), so each group's rows form a run
// in position order; the lane's range is then two lower-bound searches on
// (hash, position) into that order. Only "same group contiguous, positions
// ascending" matters, not which total order of groups the sort uses.
//
// The JAX version materialises a ceil(log2 N) + 1 level sparse table over
// all N = C + L positions (20 levels, 7.9 M entries at C = 131072 and
// L = 262144). This one has three levels:
//   tiles of 32 positions (one warp): prefix and suffix extrema P, S;
//   superblocks of 32 tiles (1024 positions, one block): the tile extrema
//   TE and their prefix and suffix TP, TS within the superblock;
//   a sparse table over the superblock extrema only (log2(N / 1024) + 1
//   levels, built by one block).
// A range inside one tile is scanned (at most 32 values); otherwise it is
// op(S[l], P[r - 1]) and the tiles between: scanned when they lie in one
// superblock (at most 30), else TS, TP and two sparse-table probes. The
// structure holds about 2N + 3N/32 values, a few reads a lane.
//
// Bound on the H100: bytes. A call must read the ring values (C), the
// chunk's values, valid flags and types (L) and write L results; grouped,
// also the C + L 64-bit group hashes. The structure's own traffic (V, P, S,
// and grouped the sort) is a few times that. Six launches a call: fill +
// per-block lane counts, one block scanning the block counts, the lane pass
// (prefix counts, ranges, the CURRENT scatter), the tile/superblock build,
// the sparse table, the queries. No host sync: `expired` and `appended`
// are read from device memory and the ring rotation is index arithmetic.
// min and max propagate NaN as jnp.minimum / jnp.maximum do.

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;  // threads a block; positions a superblock
constexpr int TILE_SHIFT = 5;  // 32 positions a tile, 32 tiles a superblock
constexpr int8_t KIND_CURRENT = 0;
constexpr int8_t KIND_EXPIRED = 1;

__device__ __forceinline__ void lane_kinds(const uint8_t* valid,
                                           const int8_t* types, int i, int L,
                                           int* cur, int* exp) {
  *cur = 0;
  *exp = 0;
  if (i < L && valid[i]) {
    *cur = types[i] == KIND_CURRENT;
    *exp = types[i] == KIND_EXPIRED;
  }
}

// V (and grouped the position keys) from the rotated ring; per-block
// CURRENT / EXPIRED counts of the chunk's lanes (blocks past the lanes
// write nothing).
template <typename Op, typename T>
__global__ void k8_fill_count(const T* __restrict__ ring, int C,
                              const int64_t* __restrict__ ring_key,
                              const int64_t* __restrict__ expired, int N,
                              const uint8_t* __restrict__ valid,
                              const int8_t* __restrict__ types, int L,
                              T* __restrict__ V, int64_t* __restrict__ key,
                              int* __restrict__ blk_cur,
                              int* __restrict__ blk_exp) {
  __shared__ int smem[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < N) {
    if (i < C) {
      const int src = static_cast<int>((expired[0] % C + i) % C);
      V[i] = ring[src];
      if (key != nullptr) key[i] = ring_key[src];
    } else {
      V[i] = Op::template identity<T>();
      if (key != nullptr) key[i] = 0;
    }
  }
  int cur, exp, tc, te;
  lane_kinds(valid, types, i, L, &cur, &exp);
  block_exclusive_sum<BLOCK>(cur, smem, &tc);
  block_exclusive_sum<BLOCK>(exp, smem, &te);
  if (threadIdx.x == 0 && blockIdx.x * BLOCK < L) {
    blk_cur[blockIdx.x] = tc;
    blk_exp[blockIdx.x] = te;
  }
}

// One block: both block-count arrays become exclusive prefixes in place.
__global__ void k8_scan_blocks(int* __restrict__ blk_cur,
                               int* __restrict__ blk_exp, int nbl) {
  __shared__ int smem[BLOCK / 32];
  int carry_c = 0, carry_e = 0;
  for (int base = 0; base < nbl; base += BLOCK) {
    const int j = base + threadIdx.x;
    const int vc = j < nbl ? blk_cur[j] : 0;
    const int ve = j < nbl ? blk_exp[j] : 0;
    int tc, te;
    const int xc = block_exclusive_sum<BLOCK>(vc, smem, &tc);
    const int xe = block_exclusive_sum<BLOCK>(ve, smem, &te);
    if (j < nbl) {
      blk_cur[j] = carry_c + xc;
      blk_exp[j] = carry_e + xe;
    }
    carry_c += tc;
    carry_e += te;
  }
}

// Per lane: inclusive CURRENT / EXPIRED counts, the range [lo, hi) in
// positions, and the CURRENT scatter into V (and the keys).
template <typename T>
__global__ void k8_lanes(const uint8_t* __restrict__ valid,
                         const int8_t* __restrict__ types,
                         const T* __restrict__ cur_vals,
                         const int64_t* __restrict__ cur_key, int L, int N,
                         const int* __restrict__ blk_cur,
                         const int* __restrict__ blk_exp,
                         const int64_t* __restrict__ expired,
                         const int64_t* __restrict__ appended,
                         T* __restrict__ V, int64_t* __restrict__ key,
                         int* __restrict__ lo, int* __restrict__ hi) {
  __shared__ int smem[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int cur, exp, tc, te;
  lane_kinds(valid, types, i, L, &cur, &exp);
  const int cc = blk_cur[blockIdx.x] + block_exclusive_sum<BLOCK>(cur, smem,
                                                                  &tc) + cur;
  const int ce = blk_exp[blockIdx.x] + block_exclusive_sum<BLOCK>(exp, smem,
                                                                  &te) + exp;
  if (i >= L) return;
  const int winlen0 = static_cast<int>(appended[0] - expired[0]);
  lo[i] = ce;  // expired lanes include their own removal
  hi[i] = winlen0 + cc;  // current lanes include their own arrival
  if (cur) {
    // past N only when the window overflowed its ring (the JAX scatter
    // drops those writes too)
    const long long d = static_cast<long long>(winlen0) + cc - 1;
    if (d >= 0 && d < N) {
      V[d] = cur_vals[i];
      if (key != nullptr) key[d] = cur_key[i];
    }
  }
}

// One block a superblock, one warp a tile: P and S within each tile, the
// tile extrema with their prefix and suffix within the superblock, and the
// superblock's extremum (level 0 of the sparse table). With a permutation,
// X receives the values in sorted order and the structure is built over it.
template <typename Op, typename T>
__global__ void k8_build(const T* __restrict__ V,
                         const int64_t* __restrict__ perm, int N,
                         T* __restrict__ X, T* __restrict__ P,
                         T* __restrict__ S, T* __restrict__ TE,
                         T* __restrict__ TP, T* __restrict__ TS,
                         T* __restrict__ SB) {
  __shared__ T tile_ext[32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = Op::template identity<T>();
  if (i < N) {
    x = perm != nullptr ? V[perm[i]] : V[i];
    if (perm != nullptr) X[i] = x;
  }
  T p = x, s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, p, o);
    if (lane >= o) p = Op::apply(y, p);
    const T z = __shfl_down_sync(0xffffffffu, s, o);
    if (lane + o < 32) s = Op::apply(s, z);
  }
  if (i < N) {
    P[i] = p;
    S[i] = s;
  }
  if (lane == 31) tile_ext[warp] = p;
  __syncthreads();
  if (warp == 0) {
    const T e = tile_ext[lane];
    T tp = e, ts = e;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, tp, o);
      if (lane >= o) tp = Op::apply(y, tp);
      const T z = __shfl_down_sync(0xffffffffu, ts, o);
      if (lane + o < 32) ts = Op::apply(ts, z);
    }
    const int t = blockIdx.x * 32 + lane;
    if (t < ((N + 31) >> TILE_SHIFT)) {
      TE[t] = e;
      TP[t] = tp;
      TS[t] = ts;
    }
    if (lane == 31) SB[blockIdx.x] = tp;
  }
}

// One block: levels 1.. of the sparse table over the superblock extrema;
// level k holds op over [t, min(t + 2^k, nsb)).
template <typename Op, typename T>
__global__ void k8_sparse(T* __restrict__ SB, int nsb, int levels) {
  for (int k = 1; k < levels; ++k) {
    const T* prev = SB + static_cast<size_t>(k - 1) * nsb;
    T* cur = SB + static_cast<size_t>(k) * nsb;
    const int half = 1 << (k - 1);
    for (int t = threadIdx.x; t < nsb; t += blockDim.x) {
      const T a = prev[t];
      cur[t] = t + half < nsb ? Op::apply(a, prev[t + half]) : a;
    }
    __syncthreads();
  }
}

template <typename Op, typename T>
struct Structure {
  const T* X;
  const T* P;
  const T* S;
  const T* TE;
  const T* TP;
  const T* TS;
  const T* SB;
  int nsb;
};

template <typename Op, typename T>
__device__ T range_op(int l, int r, const Structure<Op, T>& st) {
  T res = Op::template identity<T>();
  if (r <= l) return res;
  const int e = r - 1;
  const int tl = l >> TILE_SHIFT, te = e >> TILE_SHIFT;
  if (tl == te) {
    for (int p = l; p <= e; ++p) res = Op::apply(res, st.X[p]);
    return res;
  }
  res = Op::apply(st.S[l], st.P[e]);
  const int a = tl + 1, b = te - 1;
  if (a > b) return res;
  const int sa = a >> TILE_SHIFT, sb = b >> TILE_SHIFT;
  if (sa == sb) {
    for (int t = a; t <= b; ++t) res = Op::apply(res, st.TE[t]);
    return res;
  }
  res = Op::apply(res, Op::apply(st.TS[a], st.TP[b]));
  const int c = sa + 1, d = sb - 1;
  if (c > d) return res;
  const int k = 31 - __clz(d - c + 1);
  const T* lvl = st.SB + static_cast<size_t>(k) * st.nsb;
  return Op::apply(res, Op::apply(lvl[c], lvl[d - (1 << k) + 1]));
}

// First sorted index whose (hash, position) is >= (g, tp).
__device__ __forceinline__ int lower_bound(const int64_t* __restrict__ skey,
                                          const int64_t* __restrict__ spos,
                                          int N, int64_t g, int tp) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int64_t k = skey[mid];
    if (k < g || (k == g && spos[mid] < tp)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Ungrouped (skey null): the lane's range is [lo, hi) in positions.
// Grouped: the two lower bounds of (the lane's hash, lo / hi).
template <typename Op, typename T>
__global__ void k8_query(const int* __restrict__ lo, const int* __restrict__ hi,
                         const int64_t* __restrict__ skey,
                         const int64_t* __restrict__ spos,
                         const int64_t* __restrict__ cur_key, int L, int N,
                         Structure<Op, T> st, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  int l = lo[i], r = hi[i];
  if (skey != nullptr) {
    const int64_t g = cur_key[i];
    l = lower_bound(skey, spos, N, g, l);
    r = lower_bound(skey, spos, N, g, r);
  }
  // positions past N exist only when the window overflowed its ring
  out[i] = range_op(max(l, 0), min(r, N), st);
}

template <typename Op, typename T>
int prepare_typed(const void* ring, int C, const int64_t* ring_key,
                  const int64_t* expired, const int64_t* appended,
                  const uint8_t* valid, const int8_t* types,
                  const void* cur_vals, const int64_t* cur_key, int L,
                  void* V, int64_t* key, int* blk, int* lo, int* hi,
                  cudaStream_t stream) {
  const int N = C + L;
  const int nbl = static_cast<int>(siddhi_blocks(L, BLOCK));
  int* blk_cur = blk;
  int* blk_exp = blk + nbl;
  k8_fill_count<Op, T><<<siddhi_blocks(N, BLOCK), BLOCK, 0, stream>>>(
      static_cast<const T*>(ring), C, ring_key, expired, N, valid, types, L,
      static_cast<T*>(V), key, blk_cur, blk_exp);
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k8_scan_blocks<<<1, BLOCK, 0, stream>>>(blk_cur, blk_exp, nbl);
  rc = siddhi_launch_status();
  if (rc) return rc;
  k8_lanes<T><<<nbl, BLOCK, 0, stream>>>(
      valid, types, static_cast<const T*>(cur_vals), cur_key, L, N, blk_cur,
      blk_exp, expired, appended, static_cast<T*>(V), key, lo, hi);
  return siddhi_launch_status();
}

template <typename Op, typename T>
int query_typed(const void* V, const int64_t* perm, const int64_t* skey,
                const int64_t* cur_key, const int* lo, const int* hi, int L,
                int N, void* X, void* P, void* S, void* TE, void* TP,
                void* TS, void* SB, int nsb, int levels, void* out,
                cudaStream_t stream) {
  T* Xt = perm != nullptr ? static_cast<T*>(X)
                          : static_cast<T*>(const_cast<void*>(V));
  k8_build<Op, T><<<nsb, BLOCK, 0, stream>>>(
      static_cast<const T*>(V), perm, N, Xt, static_cast<T*>(P),
      static_cast<T*>(S), static_cast<T*>(TE), static_cast<T*>(TP),
      static_cast<T*>(TS), static_cast<T*>(SB));
  int rc = siddhi_launch_status();
  if (rc) return rc;
  k8_sparse<Op, T><<<1, BLOCK, 0, stream>>>(static_cast<T*>(SB), nsb,
                                           levels);
  rc = siddhi_launch_status();
  if (rc) return rc;
  Structure<Op, T> st{Xt, static_cast<const T*>(P), static_cast<const T*>(S),
                      static_cast<const T*>(TE), static_cast<const T*>(TP),
                      static_cast<const T*>(TS), static_cast<const T*>(SB),
                      nsb};
  constexpr int QB = 256;
  k8_query<Op, T><<<siddhi_blocks(L, QB), QB, 0, stream>>>(
      lo, hi, skey, perm, cur_key, L, N, st, static_cast<T*>(out));
  return siddhi_launch_status();
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k8_block_size() { return BLOCK; }

// op: 0 = min, 1 = max. dtype: 0 = float32, 1 = float64, 2 = int64,
// 3 = int32.
#define SIDDHI_K8_DISPATCH(FN, ...)                                        \
  switch (op * 4 + dtype) {                                                \
    case 0: return FN<OpMin, float>(__VA_ARGS__);                          \
    case 1: return FN<OpMin, double>(__VA_ARGS__);                         \
    case 2: return FN<OpMin, long long>(__VA_ARGS__);                      \
    case 3: return FN<OpMin, int>(__VA_ARGS__);                            \
    case 4: return FN<OpMax, float>(__VA_ARGS__);                          \
    case 5: return FN<OpMax, double>(__VA_ARGS__);                         \
    case 6: return FN<OpMax, long long>(__VA_ARGS__);                      \
    case 7: return FN<OpMax, int>(__VA_ARGS__);                            \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

// Stage one: V[C + L] (values by window position) and, when ring_key is
// given, key[C + L] (their group hashes); the lanes' ranges lo/hi int32[L].
// valid uint8[L] (torch.bool), types int8[L]; expired and appended are
// int64 device scalars (the pre-step window state). blk: int32[2 * nbl],
// nbl = ceil(L / 1024).
SIDDHI_API int k8_prepare(int op, int dtype, const void* ring, int C,
                          const int64_t* ring_key, const int64_t* expired,
                          const int64_t* appended, const uint8_t* valid,
                          const int8_t* types, const void* cur_vals,
                          const int64_t* cur_key, int L, void* V,
                          int64_t* key, int* blk, int* lo, int* hi,
                          cudaStream_t stream) {
  if (L <= 0) return 0;
  SIDDHI_K8_DISPATCH(prepare_typed, ring, C, ring_key, expired, appended,
                     valid, types, cur_vals, cur_key, L, V, key, blk, lo, hi,
                     stream)
}

// Stage two: the range structure over V (ungrouped, perm null) or over V in
// the order of perm (grouped: perm and skey are the stable sort of key,
// cur_key the lanes' hashes), then one query per lane into out[L]. X, P, S
// hold N values, TE/TP/TS ceil(N / 32), SB levels * nsb with nsb =
// ceil(N / 1024) and levels = floor(log2(nsb)) + 1.
SIDDHI_API int k8_query_lanes(int op, int dtype, const void* V,
                              const int64_t* perm, const int64_t* skey,
                              const int64_t* cur_key, const int* lo,
                              const int* hi, int L, int N, void* X, void* P,
                              void* S, void* TE, void* TP, void* TS, void* SB,
                              int nsb, int levels, void* out,
                              cudaStream_t stream) {
  if (L <= 0) return 0;
  SIDDHI_K8_DISPATCH(query_typed, V, perm, skey, cur_key, lo, hi, L, N, X, P,
                     S, TE, TP, TS, SB, nsb, levels, out, stream)
}
