// K12a — wire packing of a step's output for the host, one launch a
// delivery.
//
// Replaces siddhi_tpu/core/stream.py `_wire_pack` (with the host
// compaction `np.nonzero(valid)` its readers do, stream.py:157 and
// event.py:474): ts0 = the least of where(valid, ts, 2^62) (0 if that is
// the sentinel or the batch is empty), dts = uint32(ts - ts0), flags =
// types << 1 | valid, `over` = a delta past 2^32 - 1 or below 0, the
// columns unchanged. Here the valid lanes are compacted in lane order into
// ONE buffer (layout in siddhi_tpu_torch/ops/wire.py): a header {count,
// ts0, over, 0}, then per region `n` entries of which the first `count`
// hold the compacted lanes — the columns, dts, the high words of the delta
// (so an `over` batch still reads back exactly, from this buffer alone)
// and flags. Entries past `count` are left as they were: no reader looks
// at them. One device-to-host copy then moves the whole buffer.
//
// Bound on the H100: bytes. Each lane is read once (ts, valid, types, the
// columns) and each compacted entry written once: for app A's output
// (int32 code + 2 x float32) at B = 131072, half the lanes valid, about
// 2.8 MB read and 1.1 MB written (plus 0.26 MB of high words the function
// needs only on an `over` batch), ~1.2 us at 3.35 TB/s; launch latency
// dominates, so the design is one launch:
//   each block takes a contiguous share of whole 1,024-lane tiles, ranks
//   its valid lanes and folds their minimum (the sentinel for an invalid
//   lane, as `_wire_pack`) and maximum ts in one block scan a tile, and
//   prefetches the valid lanes' types and columns into L2; up to one block
//   of lanes that block is the whole batch (a plain launch, no
//   workspace); past it the blocks leave their partials in the workspace,
//   cross one grid barrier (a cooperative launch) and one warp of each
//   folds every partial: the block's offset, the count and ts0. `over`
//   needs no second pass: ts0 is at most every valid ts, so a delta
//   leaves [0, 2^32 - 1] exactly when the largest one, max - ts0 in
//   unsigned 64 bits, does. Block 0 writes the header; every block writes
//   its valid lanes at their compacted positions (a block of one tile from
//   the rank it kept, a larger share tile by tile again), reading each
//   column through its stride (a strided view of a window's ring is read
//   where it lies).

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int BLOCK = 1024;
constexpr int MAX_COLS = 64;
constexpr long long BIG = 1LL << 62;
// workspace: the barrier, the done counter, then 3 int64 partials a block
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_HEAD = 4;

struct Cols {
  const uint8_t* src[MAX_COLS];
  long long stride[MAX_COLS];  // in elements
  long long off[MAX_COLS];     // byte offset of the region in buf
  int width[MAX_COLS];
  int n;
};

struct Lanes {
  const long long* ts;
  const uint8_t* valid;
  const int8_t* types;
  long long ts_stride, valid_stride, types_stride;  // in elements
  int n;
  int per_block;  // lanes of a block's share, a multiple of BLOCK
  long long dts_off, hi_off, flags_off;
};

struct Partial {
  long long count, min, max;
};

__device__ __forceinline__ Partial fold(Partial a, Partial b) {
  return {a.count + b.count, b.min < a.min ? b.min : a.min,
          b.max > a.max ? b.max : a.max};
}

__device__ __forceinline__ Partial empty_partial() {
  return {0, LLONG_MAX, LLONG_MIN};
}

// The fold of a warp's partials, in every lane.
__device__ __forceinline__ Partial warp_fold(Partial p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Partial q;
    q.count = __shfl_xor_sync(0xffffffffu, p.count, o);
    q.min = __shfl_xor_sync(0xffffffffu, p.min, o);
    q.max = __shfl_xor_sync(0xffffffffu, p.max, o);
    p = fold(p, q);
  }
  return p;
}

struct Smem {
  int count[BLOCK / 32];  // warps' inclusive counts
  long long min[BLOCK / 32], max[BLOCK / 32];
  Partial all;
  long long before;
};

// One tile: v's exclusive rank in the block (returned) and the tile's
// fold of (v, tmin, tmax) in every thread, with two block barriers.
__device__ __forceinline__ int tile_rank_fold(int v, long long tmin,
                                              long long tmax, Partial* tile,
                                              Smem* sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  Partial w = warp_fold({0, tmin, tmax});
  if (lane == 31) sm->count[warp] = x;
  if (lane == 0) {
    sm->min[warp] = w.min;
    sm->max[warp] = w.max;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int NW = BLOCK / 32;
    int c = lane < NW ? sm->count[lane] : 0;
    Partial q = {0, lane < NW ? sm->min[lane] : LLONG_MAX,
                 lane < NW ? sm->max[lane] : LLONG_MIN};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += y;
    }
    q = warp_fold(q);
    if (lane < NW) sm->count[lane] = c;
    if (lane == 0) sm->all = {0, q.min, q.max};
  }
  __syncthreads();
  *tile = {sm->count[BLOCK / 32 - 1], sm->all.min, sm->all.max};
  const int ex = (warp > 0 ? sm->count[warp - 1] : 0) + x - v;
  __syncthreads();  // sm is reused by the next tile
  return ex;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Lane i, valid, at compacted position pos.
__device__ __forceinline__ void write_lane(const Lanes& L, const Cols& cols,
                                           uint8_t* buf, long long ts0,
                                           long long i, long long t,
                                           long long pos) {
  // the int64 subtraction of _wire_pack, wrapping
  const unsigned long long d = static_cast<unsigned long long>(t) -
                               static_cast<unsigned long long>(ts0);
  reinterpret_cast<uint32_t*>(buf + L.dts_off)[pos] = static_cast<uint32_t>(d);
  reinterpret_cast<uint32_t*>(buf + L.hi_off)[pos] =
      static_cast<uint32_t>(d >> 32);
  buf[L.flags_off + pos] = static_cast<uint8_t>(
      (static_cast<uint8_t>(L.types[i * L.types_stride]) << 1) | 1);
  for (int c = 0; c < cols.n; ++c) {
    const int w = cols.width[c];
    siddhi_copy_lane(buf + cols.off[c] + pos * w,
                     cols.src[c] + i * cols.stride[c] * w, w);
  }
}

__global__ void __launch_bounds__(BLOCK)
    k12a_pack(const __grid_constant__ Lanes L,
              const __grid_constant__ Cols cols, uint8_t* __restrict__ buf,
              unsigned* ws) {
  __shared__ Smem sm;
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int b0 = static_cast<int>(min(
      static_cast<long long>(L.n), static_cast<long long>(g) * L.per_block));
  const int b1 = min(L.n, b0 + L.per_block);
  const bool one_tile = b1 - b0 <= BLOCK;  // block-uniform
  // pass 1: the share's valid count, min of where(valid, ts, BIG), max
  // valid ts. A block of one tile ranks its lanes here, keeps the rank for
  // pass 2 and prefetches each valid lane's type and columns into L2; a
  // larger share folds each thread's lanes first and ranks in pass 2.
  Partial p;
  int v1 = 0, ex1 = 0;
  long long t1 = 0;
  if (one_tile) {
    const long long i = b0 + tid;
    const bool in = i < b1;
    v1 = in && L.valid[i * L.valid_stride] ? 1 : 0;
    t1 = v1 ? L.ts[i * L.ts_stride] : BIG;
    if (v1) {
      prefetch_l2(L.types + i * L.types_stride);
      for (int c = 0; c < cols.n; ++c)
        prefetch_l2(cols.src[c] + i * cols.stride[c] * cols.width[c]);
    }
    ex1 = tile_rank_fold(v1, in ? t1 : LLONG_MAX, v1 ? t1 : LLONG_MIN, &p,
                         &sm);
  } else {
    int n = 0;
    long long mn = LLONG_MAX, mx = LLONG_MIN;
    for (long long i = b0 + tid; i < b1; i += BLOCK) {
      const bool v = L.valid[i * L.valid_stride] != 0;
      const long long t = v ? L.ts[i * L.ts_stride] : BIG;
      n += v;
      mn = t < mn ? t : mn;
      if (v) mx = t > mx ? t : mx;
    }
    tile_rank_fold(n, mn, mx, &p, &sm);  // the block's sums, not a rank
  }
  Partial all = p;
  long long before = 0;
  Partial* parts =
      G > 1 ? reinterpret_cast<Partial*>(ws + WS_HEAD) : nullptr;
  unsigned phase = 0;
  if (G > 1) {
    if (tid == 0) parts[g] = p;
    siddhi_grid_sync(ws + WS_BAR, phase);
    if (tid < 32) {  // one warp folds every block's partial
      Partial q = empty_partial();
      long long pre = 0;
      for (int j = tid; j < G; j += 32) {
        Partial r;
        r.count = __ldcg(&parts[j].count);
        r.min = __ldcg(&parts[j].min);
        r.max = __ldcg(&parts[j].max);
        q = fold(q, r);
        if (j < g) pre += r.count;
      }
      q = warp_fold(q);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        pre += __shfl_xor_sync(0xffffffffu, pre, o);
      if (tid == 0) {
        sm.all = q;
        sm.before = pre;
      }
    }
    __syncthreads();
    all = sm.all;
    before = sm.before;
  }
  const long long ts0 = (L.n == 0 || all.min == BIG) ? 0 : all.min;
  if (g == 0 && tid == 0) {
    long long* header = reinterpret_cast<long long*>(buf);
    header[0] = all.count;
    header[1] = ts0;
    header[2] = all.count > 0 &&
                static_cast<unsigned long long>(all.max) -
                        static_cast<unsigned long long>(ts0) >
                    0xFFFFFFFFull;
    header[3] = 0;
  }
  // pass 2: the scatter, from the kept rank or tile by tile again
  if (one_tile) {
    if (v1) write_lane(L, cols, buf, ts0, b0 + tid, t1, before + ex1);
  } else {
    long long base = before;
    for (int x0 = b0; x0 < b1; x0 += BLOCK) {  // the same trip count
      const long long i = x0 + tid;
      const int v = i < b1 && L.valid[i * L.valid_stride] ? 1 : 0;
      Partial tile;
      const int ex = tile_rank_fold(v, LLONG_MAX, LLONG_MIN, &tile, &sm);
      if (v) write_lane(L, cols, buf, ts0, i, L.ts[i * L.ts_stride],
                        base + ex);
      base += tile.count;
    }
  }
  if (G > 1 && siddhi_grid_last(ws + WS_BAR, ws + WS_DONE))
    for (int j = tid; j < 3 * G; j += BLOCK)
      reinterpret_cast<long long*>(parts)[j] = 0;
}

int pack_capacity() {
  static int cap = -1;
  if (cap < 0) {
    const int c = siddhi_coop_capacity(k12a_pack, BLOCK);
    if (c <= 0) return 0;
    cap = c;
  }
  return cap;
}

// Blocks of a pack of n lanes: whole tiles a block, at most the card's
// co-resident blocks; 1 up to one tile (and for n = 0).
int pack_grid(int n, int* per_block) {
  const long long tiles = (n + BLOCK - 1ll) / BLOCK;
  const int cap = tiles > 1 ? pack_capacity() : 1;
  if (cap <= 0) return 0;
  const long long per = tiles > cap ? (tiles + cap - 1) / cap : 1;
  *per_block = static_cast<int>(per * BLOCK);
  return tiles > 1 ? static_cast<int>((tiles + per - 1) / per) : 1;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Bytes of the workspace a pack of n lanes needs: 0 up to one block of
// lanes (no workspace), -1 where the card has no cooperative launches.
SIDDHI_API long long k12a_workspace_bytes(int n) {
  int per = 0;
  const int grid = pack_grid(n, &per);
  if (grid <= 0) return -1;
  return grid > 1 ? 4ll * WS_HEAD + 24ll * grid : 0;
}

// One int64 argument array: ts, ts_stride, valid, valid_stride, types,
// types_stride (device pointers and strides in elements: ts int64, valid
// uint8 as torch.bool storage, types int8, each of n lanes), n, ncols,
// dts_off, hi_off, flags_off (byte offsets into buf), buf (uint8 of the
// layout's size), ws (the workspace, k12a_workspace_bytes; 0 when that is
// 0), then per column: pointer, stride, byte width (1, 2, 4, 8), byte
// offset of its region. One array keeps the host's call to two arguments.
SIDDHI_API int k12a_wire_pack(const long long* a, cudaStream_t stream) {
  const int n = static_cast<int>(a[6]);
  const int ncols = static_cast<int>(a[7]);
  if (ncols < 0 || ncols > MAX_COLS || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  cols.n = ncols;
  const long long* c0 = a + 13;
  for (int c = 0; c < ncols; ++c) {
    const int w = static_cast<int>(c0[4 * c + 2]);
    if (w != 1 && w != 2 && w != 4 && w != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.src[c] = reinterpret_cast<const uint8_t*>(c0[4 * c]);
    cols.stride[c] = c0[4 * c + 1];
    cols.width[c] = w;
    cols.off[c] = c0[4 * c + 3];
  }
  Lanes L;
  L.ts = reinterpret_cast<const long long*>(a[0]);
  L.ts_stride = a[1];
  L.valid = reinterpret_cast<const uint8_t*>(a[2]);
  L.valid_stride = a[3];
  L.types = reinterpret_cast<const int8_t*>(a[4]);
  L.types_stride = a[5];
  L.n = n;
  L.per_block = BLOCK;
  L.dts_off = a[8];
  L.hi_off = a[9];
  L.flags_off = a[10];
  uint8_t* buf = reinterpret_cast<uint8_t*>(a[11]);
  unsigned* ws = reinterpret_cast<unsigned*>(a[12]);
  const int grid = pack_grid(n, &L.per_block);
  if (grid <= 0) return static_cast<int>(cudaErrorNotSupported);
  if (grid == 1) {
    k12a_pack<<<1, BLOCK, 0, stream>>>(L, cols, buf, ws);
    return siddhi_launch_status();
  }
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&L, &cols, &buf, &ws};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k12a_pack), dim3(grid), dim3(BLOCK), args,
      0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}
