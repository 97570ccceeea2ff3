// K13d — the in-memory table's insert: primary-key dedup and row placement.
//
// Replaces siddhi_tpu/core/table.py `InMemoryTable._make_insert`:
//   dedup (:177-190):
//     eq   = AND_k batch[k][:, None] == table[k][None, :]        [B, C]
//     dup  = (eq & table.valid[None, :]).any(1)
//     eq_b = AND_k batch[k][:, None] == batch[k][None, :]        [B, B]
//     dup_in_batch = (eq_b & tril(ones, -1) & valid[None, :]).any(1)
//     ins = valid & ~dup & ~dup_in_batch
//   placement (:191-204): the r-th inserted lane (in lane order) takes the
//     r-th free row (in row order, K1 on ~valid); every column, ts and
//     valid = True are scattered there; overflow = n_ins - n_fit and
//     dropped = n_valid - n_ins are returned.
//
// k13d_dedup: one thread a lane, the rows walked through shared-memory
// tiles, without the [B, C] and [B, B] masks. A 2-D grid splits the rows
// too (ROWS_PER_BLOCK a block), so B = 16,384 lanes against C = 65,536
// rows run as 4,096 blocks; a lane that finds an equal row stores 1 into
// its drop byte (every writer stores the same value). The second launch is
// the batch against itself, rows before the lane only. Equality is JAX's
// `==`: floats compare as floats (NaN never equal, -0.0 == 0.0), integers,
// bools and string codes bitwise, up to MAX_KEYS columns.
//
// k13d_place: one block. It first counts the free rows, the valid lanes
// and the lanes that stay; if they do not fit it writes nothing (the
// table stays as it was: an overflowing insert is all or nothing) and
// leaves only the two counts. Otherwise it ranks the lanes chunk by chunk
// with block scans and writes each column of every staying lane into its
// free row in place. Free rows are distinct, so the scatter has no
// conflict. The counts stay on the device; the caller reads both in one
// copy.
//
// Bound on the H100: dedup is operations — B x C x keys compares (1.1e9
// at app AC's B = 16,384, C = 65,536, one key), served from shared memory;
// its bytes are only the keys (~0.3 MB). Placement is bytes (each staying
// lane's row read and written once, the valid flags) but runs as a single
// block, so latency bounds it at these sizes.

#include "common.cuh"

namespace {

constexpr int LANES = 128;            // lanes a dedup block, one a thread
constexpr int TILE = LANES;           // rows staged a time, one a thread
constexpr int ROWS_PER_BLOCK = 2048;  // rows a dedup block walks
constexpr int MAX_KEYS = 4;
constexpr int PLACE_BLOCK = 1024;
constexpr int MAX_COLS = 64;

enum KeyType { K_I8 = 0, K_I32 = 1, K_I64 = 2, K_F32 = 3, K_F64 = 4 };

struct Keys {
  const void* lane[MAX_KEYS];  // the batch's key columns [B]
  const void* row[MAX_KEYS];   // the rows' key columns [R]
  int type[MAX_KEYS];
  int n;
};

struct Cols {
  const void* src[MAX_COLS];  // the batch's columns [B], ts last
  void* dst[MAX_COLS];        // the table's columns [C], ts last
  int size[MAX_COLS];         // bytes a value: 1, 4 or 8
  int n;
};

__device__ __forceinline__ long long load_key(const void* p, int type,
                                              long long i) {
  switch (type) {
    case K_I8:
      return static_cast<const signed char*>(p)[i];
    case K_I32:
      return static_cast<const int*>(p)[i];
    case K_F32:
      return __float_as_int(static_cast<const float*>(p)[i]);
    default:  // K_I64, K_F64
      return static_cast<const long long*>(p)[i];
  }
}

__device__ __forceinline__ bool key_eq(long long a, long long b, int type) {
  if (type == K_F32)
    return __int_as_float(static_cast<int>(a)) ==
           __int_as_float(static_cast<int>(b));
  if (type == K_F64) return __longlong_as_double(a) == __longlong_as_double(b);
  return a == b;
}

__global__ void k13d_dup(Keys keys, const bool* __restrict__ lane_valid,
                         const bool* __restrict__ row_valid, int B, int R,
                         int in_batch, bool* __restrict__ drop) {
  __shared__ long long tile_key[MAX_KEYS][TILE];
  __shared__ bool tile_ok[TILE];
  const int b = blockIdx.x * LANES + threadIdx.x;
  const bool active = b < B && lane_valid[b];
  long long mine[MAX_KEYS];
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k)
    mine[k] = (active && k < keys.n) ? load_key(keys.lane[k], keys.type[k], b)
                                     : 0;
  const int r0 = blockIdx.y * ROWS_PER_BLOCK;
  int r1 = min(R, r0 + ROWS_PER_BLOCK);
  if (in_batch) {
    // only rows before the block's last lane can precede one of its lanes
    r1 = min(r1, min(B, (int)(blockIdx.x + 1) * LANES) - 1);
  }
  bool found = false;
  for (int t0 = r0; t0 < r1; t0 += TILE) {  // the same trip count block-wide
    const int n = min(TILE, r1 - t0);
    if (threadIdx.x < n) {
      const int r = t0 + threadIdx.x;
      tile_ok[threadIdx.x] = row_valid[r];
#pragma unroll
      for (int k = 0; k < MAX_KEYS; ++k)
        if (k < keys.n)
          tile_key[k][threadIdx.x] = load_key(keys.row[k], keys.type[k], r);
    }
    __syncthreads();
    if (active && !found) {
      const int jmax = in_batch ? min(n, b - t0) : n;
      for (int j = 0; j < jmax; ++j) {
        if (!tile_ok[j]) continue;
        bool eq = true;
#pragma unroll
        for (int k = 0; k < MAX_KEYS; ++k)
          if (k < keys.n) eq = eq && key_eq(mine[k], tile_key[k][j],
                                            keys.type[k]);
        if (eq) {
          found = true;
          break;
        }
      }
    }
    __syncthreads();
  }
  if (found) drop[b] = true;
}

template <typename T>
__device__ __forceinline__ void move_one(const void* src, void* dst, int b,
                                         int slot) {
  static_cast<T*>(dst)[slot] = static_cast<const T*>(src)[b];
}

__global__ void k13d_place(const bool* __restrict__ valid,
                           const bool* __restrict__ drop, int B,
                           bool* __restrict__ row_valid, int C,
                           const int* __restrict__ free_order, Cols cols,
                           int* __restrict__ counts) {
  __shared__ int smem[PLACE_BLOCK / 32];
  const int tid = threadIdx.x;
  int n_free = 0, n_valid = 0, n_ins = 0;
  {
    int f = 0, v = 0, s = 0;
    for (int c = tid; c < C; c += PLACE_BLOCK) f += !row_valid[c];
    for (int b = tid; b < B; b += PLACE_BLOCK) {
      const bool vb = valid[b];
      v += vb;
      s += vb && !(drop != nullptr && drop[b]);
    }
    block_exclusive_sum<PLACE_BLOCK>(f, smem, &n_free);
    block_exclusive_sum<PLACE_BLOCK>(v, smem, &n_valid);
    block_exclusive_sum<PLACE_BLOCK>(s, smem, &n_ins);
  }
  const int overflow = n_ins > n_free ? n_ins - n_free : 0;
  if (tid == 0) {
    counts[0] = overflow;
    counts[1] = n_valid - n_ins;
  }
  if (overflow) return;  // all or nothing: leave the table as it was
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += PLACE_BLOCK) {
    const int b = b0 + tid;
    const int stay =
        b < B && valid[b] && !(drop != nullptr && drop[b]) ? 1 : 0;
    int total;
    const int r = base + block_exclusive_sum<PLACE_BLOCK>(stay, smem, &total);
    if (stay) {
      const int slot = free_order[r];
      for (int c = 0; c < cols.n; ++c) {
        switch (cols.size[c]) {
          case 1:
            move_one<uint8_t>(cols.src[c], cols.dst[c], b, slot);
            break;
          case 4:
            move_one<uint32_t>(cols.src[c], cols.dst[c], b, slot);
            break;
          default:
            move_one<unsigned long long>(cols.src[c], cols.dst[c], b, slot);
        }
      }
      row_valid[slot] = true;
    }
    base += total;
  }
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k13d_max_cols() { return MAX_COLS; }

// k13d_dedup: drop[b] = 1 where valid lane b's key equals a live row's or
// an earlier valid lane's. lane_keys/row_keys/types: n_keys host entries
// (device pointers; types K_I8..K_F64, both sides of one type);
// lane_valid bool[B], row_valid bool[C], drop bool[B] zeroed by the caller.
SIDDHI_API int k13d_dedup(const void* const* lane_keys,
                          const void* const* row_keys, const int* types,
                          int n_keys, const bool* lane_valid,
                          const bool* row_valid, int B, int C, bool* drop,
                          cudaStream_t stream) {
  if (n_keys < 1 || n_keys > MAX_KEYS || B < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Keys table, batch;
  table.n = batch.n = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    if (types[k] < K_I8 || types[k] > K_F64)
      return static_cast<int>(cudaErrorInvalidValue);
    table.lane[k] = batch.lane[k] = batch.row[k] = lane_keys[k];
    table.row[k] = row_keys[k];
    table.type[k] = batch.type[k] = types[k];
  }
  if (B == 0) return 0;
  const unsigned lane_blocks = siddhi_blocks(B, LANES);
  if (C > 0) {
    dim3 grid(lane_blocks, siddhi_blocks(C, ROWS_PER_BLOCK));
    k13d_dup<<<grid, LANES, 0, stream>>>(table, lane_valid, row_valid, B, C,
                                         0, drop);
    const int rc = siddhi_launch_status();
    if (rc) return rc;
  }
  dim3 grid(lane_blocks, siddhi_blocks(B, ROWS_PER_BLOCK));
  k13d_dup<<<grid, LANES, 0, stream>>>(batch, lane_valid, lane_valid, B, B, 1,
                                       drop);
  return siddhi_launch_status();
}

// k13d_place_rows: the staying lanes (valid and not drop; drop may be
// null) into the free rows free_order[0..], every column and valid in
// place, unless they overflow. counts int32[2] out: overflow, dropped.
SIDDHI_API int k13d_place_rows(const bool* valid, const bool* drop, int B,
                               bool* row_valid, int C, const int* free_order,
                               const void* const* src, void* const* dst,
                               const int* sizes, int n_cols, int* counts,
                               cudaStream_t stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || B < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (sizes[c] != 1 && sizes[c] != 4 && sizes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.src[c] = src[c];
    cols.dst[c] = dst[c];
    cols.size[c] = sizes[c];
  }
  k13d_place<<<1, PLACE_BLOCK, 0, stream>>>(valid, drop, B, row_valid, C,
                                            free_order, cols, counts);
  return siddhi_launch_status();
}
