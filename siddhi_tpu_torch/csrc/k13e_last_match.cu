// K13e — the last matching event of each table row, one launch a call.
//
// Replaces the reductions of siddhi_tpu/core/table.py
// `TableOutputExecutor._make` (:361-383) and `contains_probe` (:258-261)
// over the ON condition's [B, C] mask, mask = cond & lane_valid[:, None] &
// row_valid[None, :]:
//   has[c]        = mask.any(axis=0)
//   b_star[c]     = (B - 1) - argmax(mask[::-1, :], axis=0)
//                   (the last b with mask[b, c]; B - 1 where none)
//   ev_matched[b] = mask.any(axis=1)
// The update applies the last matching event per row, delete clears the
// rows with `has`, update-or-insert inserts the events with no match, and
// a non-indexed `in` probe is `ev_matched`.
//
// Two routes, each one cooperative launch whose workspace (the library's,
// per stream) is zero when it starts and when it ends:
//
// k13e_eq, an ON condition that is a conjunction of `==` compares between
// the table's key columns and the events' (up to MAX_KEYS): the [B, C]
// mask never exists. Equality is the compiled `==` through the canonical
// keys of k13_keys.cuh (shared with K13d: NaN equals nothing, -0.0 equals
// +0.0, int64 compared in full).
//   build  every valid lane with no NaN key claims an open-addressing slot
//          of its key class (atomicCAS on lane + 1, equality read from the
//          real key columns), and the slot keeps the largest lane of the
//          class (atomicMax: every lane of a class has an equal key, so the
//          slot's representative stays one of them);
//   grid barrier;
//   probe  every live row with no NaN key walks to its class's slot: has,
//          b_star = the slot's lane, and a mark on the slot;
//   grid barrier;
//   lanes  ev_matched[b] = the mark of lane b's slot;
//   grid barrier, then the slots are zeroed.
// O(B + C) work: the keys and valid flags read once, the outputs written
// once, the table of at least 2 B slots (128 KB at app AD's B = 8,192)
// written and read in L2.
//
// k13e_mask, every other condition: the condition as evaluated, read where
// it lies through its two strides (a [B, 1], [1, C] or scalar condition is
// never broadcast in memory), with the two valid vectors folded in, so the
// `&` passes that built the mask are gone.
//   dense (both strides non-zero; lane b's condition is mask row b, table
//          row c is column c): items of 4,096 columns by a chunk of lanes
//          (a multiple of 32, about one item a co-resident block); each
//          thread reads 16 columns of a lane in one 16-byte load (byte
//          loads where the strides or alignment do not allow it), 8 lanes
//          ahead, reads nothing for an invalid lane or for 16 columns
//          whose table rows are all dead, and keeps each column's last
//          matching lane; its warp ORs each lane's any into a bit of the
//          lanes' words (one atomicOr a warp and 32 lanes); each column's
//          last lane is folded with atomicMax; a grid barrier; then every
//          block writes has/b_star and ev_matched from the folds and
//          zeroes them.
//   separable (a stride 0 or a scalar): the mask is u[b] & v[c], so has =
//          v & any(u), b_star = the last b of u, ev = u & any(v): two
//          reductions, a grid barrier, the outputs.
// Bound on the H100: bytes. The dense route needs the condition's bytes
// at a valid lane and a live row (at most B x C: 512 MiB at app AD's B =
// 8,192, C = 65,536, 0.16 ms at 3.35 TB/s), the valid vectors and the
// three outputs written once.

#include "k13_keys.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int EQ_BLOCK = 1024;       // fewer blocks: cheaper grid barriers
constexpr int VEC = 16;              // columns a thread reads in one load
constexpr int TILE_C = BLOCK * VEC;  // columns of a dense item
constexpr int AHEAD = 8;             // rows a thread loads before using
constexpr int MIN_SLOTS = 256;
constexpr unsigned FULL = 0xffffffffu;
// workspace words: the barrier, the done counter, two words of the
// separable route, then the scratch of a route
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_LAST_U = 4;  // the last lane of u, plus one
constexpr int WS_ANY_V = 5;   // any(v)
constexpr int WS_HEAD = 8;

struct MaskArgs {
  const uint8_t* cond;  // null: the scalar cval
  long long sb, sc;     // the condition's strides in bytes (bool)
  int cval;
  const uint8_t* lv;  // lane valid [B]; null: every lane
  const uint8_t* rv;  // row valid [C]; null: every row
  int B, C;
  int rows;    // rows of a dense item, a multiple of 32
  int ctiles;  // column tiles of a dense item
  int items;   // dense items; 0: the separable route
  int vec;     // 16-byte loads allowed
};

__device__ __forceinline__ unsigned byte_at(const MaskArgs& a, long long b,
                                            int c) {
  return c < a.C ? a.cond[b * a.sb + static_cast<long long>(c) * a.sc] : 0u;
}

// The 16 condition bytes of row b from column c0, as four words.
__device__ __forceinline__ uint4 load_row(const MaskArgs& a, long long b,
                                          int c0, bool full) {
  if (full)
    return __ldg(reinterpret_cast<const uint4*>(a.cond + b * a.sb + c0));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    w[j >> 2] |= byte_at(a, b, c0 + j) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The dense route's first pass over item `it`: the columns' last rows into
// last1 (row + 1, atomicMax), the rows' any into the lanes' bit words.
__device__ __forceinline__ void dense_item(const MaskArgs& a, int it,
                                           unsigned* last1, unsigned* evw) {
  const int lane = threadIdx.x & 31;
  const int ct = it % a.ctiles;
  const int r0 = (it / a.ctiles) * a.rows;
  const int r1 = min(a.B, r0 + a.rows);
  const int c0 = ct * TILE_C + threadIdx.x * VEC;
  unsigned live[4] = {0u, 0u, 0u, 0u};  // 0xff a byte of a live column
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = c0 + j;
    if (c < a.C && (a.rv == nullptr || a.rv[c]))
      live[j >> 2] |= 0xffu << (8 * (j & 3));
  }
  const bool full = a.vec && c0 + VEC <= a.C;
  const bool any_live = (live[0] | live[1] | live[2] | live[3]) != 0u;
  unsigned last[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) last[j] = 0u;
  unsigned wbits = 0u;
  for (int g = r0; g < r1; g += AHEAD) {
    // the valid lanes of the group, one ballot a warp
    const int bl = g + lane;
    const unsigned ok = __ballot_sync(
        FULL, lane < AHEAD && bl < r1 && (a.lv == nullptr || a.lv[bl]));
    uint4 m[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      m[k] = any_live && ((ok >> k) & 1u) ? load_row(a, g + k, c0, full)
                                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int b = g + k;
      if (b >= r1) break;  // warp-uniform
      const unsigned x[4] = {m[k].x & live[0], m[k].y & live[1],
                             m[k].z & live[2], m[k].w & live[3]};
      const bool hit = (x[0] | x[1] | x[2] | x[3]) != 0u;
      if (hit) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if ((x[j >> 2] >> (8 * (j & 3))) & 0xffu) last[j] = b + 1;
      }
      if (__ballot_sync(FULL, hit)) wbits |= 1u << (b & 31);
      if ((b & 31) == 31 || b == r1 - 1) {
        if (lane == 0 && wbits) atomicOr(evw + (b >> 5), wbits);
        wbits = 0u;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (last[j]) atomicMax(last1 + c0 + j, last[j]);
}

// The separable route's factors: mask[b, c] = u(b) & v(c).
__device__ __forceinline__ bool sep_u(const MaskArgs& a, int b) {
  if (a.lv != nullptr && !a.lv[b]) return false;
  if (a.cond == nullptr) return a.cval != 0;
  if (a.sb == 0) return a.sc != 0 || a.cond[0];  // [1, C] or scalar
  return a.cond[static_cast<long long>(b) * a.sb];  // [B, 1]
}

__device__ __forceinline__ bool sep_v(const MaskArgs& a, int c) {
  if (a.rv != nullptr && !a.rv[c]) return false;
  if (a.cond == nullptr || a.sc == 0 || a.sb != 0) return true;
  return a.cond[static_cast<long long>(c) * a.sc];  // [1, C]
}

__global__ void __launch_bounds__(BLOCK)
    k13e_mask(MaskArgs a, unsigned* ws, bool* __restrict__ has,
              int* __restrict__ b_star, bool* __restrict__ ev) {
  const int stride = gridDim.x * BLOCK;
  const int tid = blockIdx.x * BLOCK + threadIdx.x;
  unsigned* last1 = ws + WS_HEAD;  // [C]
  unsigned* evw = last1 + a.C;     // [ceil(B / 32)]
  unsigned phase = 0;
  if (a.items) {
    for (int it = blockIdx.x; it < a.items; it += gridDim.x)
      dense_item(a, it, last1, evw);
    siddhi_grid_sync(ws + WS_BAR, phase);
    for (int c = tid; c < a.C; c += stride) {
      const unsigned l = __ldcg(last1 + c);
      has[c] = l != 0u;
      b_star[c] = l ? static_cast<int>(l) - 1 : a.B - 1;
      if (l) last1[c] = 0u;
    }
    // whole warps: each reads its word, then one lane clears it
    const int b_pad = (a.B + 31) & ~31;
    for (int b = tid; b < b_pad; b += stride) {
      const unsigned w = __ldcg(evw + (b >> 5));
      if (b < a.B) ev[b] = (w >> (b & 31)) & 1u;
      __syncwarp();
      if ((b & 31) == 0 && w) evw[b >> 5] = 0u;
    }
    siddhi_grid_last(ws + WS_BAR, ws + WS_DONE);
    return;
  }
  unsigned last_u = 0u;
  for (int b = tid; b < a.B; b += stride)
    if (sep_u(a, b)) last_u = b + 1;  // ascending: the thread's last
  bool any_v = false;
  for (int c = tid; c < a.C && !any_v; c += stride) any_v = sep_v(a, c);
  last_u = __reduce_max_sync(FULL, last_u);
  const bool warp_v = __any_sync(FULL, any_v);
  if ((threadIdx.x & 31) == 0) {
    if (last_u) atomicMax(ws + WS_LAST_U, last_u);
    if (warp_v) atomicOr(ws + WS_ANY_V, 1u);
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  const unsigned U = __ldcg(ws + WS_LAST_U);
  const bool V = __ldcg(ws + WS_ANY_V) != 0u;
  for (int c = tid; c < a.C; c += stride) {
    const bool h = U != 0u && sep_v(a, c);
    has[c] = h;
    b_star[c] = h ? static_cast<int>(U) - 1 : a.B - 1;
  }
  for (int b = tid; b < a.B; b += stride) ev[b] = V && sep_u(a, b);
  if (siddhi_grid_last(ws + WS_BAR, ws + WS_DONE) && threadIdx.x == 0) {
    ws[WS_LAST_U] = 0u;
    ws[WS_ANY_V] = 0u;
  }
}

// Scratch of the equality route: ref[S] (the class's largest lane + 1),
// hit[S] (a live row matched the class), lane_slot[B] (slot + 1).
__global__ void __launch_bounds__(EQ_BLOCK)
    k13e_eq(KeyCols lanes, KeyCols rows, const bool* __restrict__ lv,
            const bool* __restrict__ rv, int B, int C, unsigned mask,
            unsigned* ws, bool* __restrict__ has, int* __restrict__ b_star,
            bool* __restrict__ ev) {
  const int stride = gridDim.x * EQ_BLOCK;
  const int tid = blockIdx.x * EQ_BLOCK + threadIdx.x;
  unsigned* ref = ws + WS_HEAD;
  unsigned* hit = ref + mask + 1;
  unsigned* lane_slot = hit + mask + 1;
  const int n = lanes.n;
  for (int b = tid; b < B; b += stride) {
    unsigned long long v[MAX_KEYS];
    if (!lv[b] || !read_key(lanes, b, v)) continue;
    const unsigned me = static_cast<unsigned>(b) + 1u;
    unsigned s = static_cast<unsigned>(key_hash(v, n)) & mask;
    for (;;) {
      unsigned r = *reinterpret_cast<volatile unsigned*>(ref + s);
      if (r == 0u) {
        r = atomicCAS(ref + s, 0u, me);
        if (r == 0u) break;  // claimed
      }
      unsigned long long w[MAX_KEYS];
      read_key(lanes, static_cast<int>(r) - 1, w);
      if (key_equal(w, v, n)) {  // the class's slot
        if (r < me) atomicMax(ref + s, me);
        break;
      }
      s = (s + 1u) & mask;
    }
    lane_slot[b] = s + 1u;
  }
  unsigned phase = 0;
  siddhi_grid_sync(ws + WS_BAR, phase);
  for (int c = tid; c < C; c += stride) {
    unsigned long long v[MAX_KEYS];
    unsigned r = 0u;
    if (rv[c] && read_key(rows, c, v)) {
      unsigned s = static_cast<unsigned>(key_hash(v, n)) & mask;
      for (;;) {
        const unsigned q = __ldcg(ref + s);
        if (q == 0u) break;  // no lane of this key
        unsigned long long w[MAX_KEYS];
        read_key(lanes, static_cast<int>(q) - 1, w);
        if (key_equal(w, v, n)) {
          r = q;
          if (!__ldcg(hit + s)) hit[s] = 1u;
          break;
        }
        s = (s + 1u) & mask;
      }
    }
    has[c] = r != 0u;
    b_star[c] = r ? static_cast<int>(r) - 1 : B - 1;
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  for (int b = tid; b < B; b += stride) {
    const unsigned ls = __ldcg(lane_slot + b);
    ev[b] = ls != 0u && __ldcg(hit + ls - 1u) != 0u;
    if (ls) lane_slot[b] = 0u;
  }
  siddhi_grid_sync(ws + WS_BAR, phase);
  for (long long j = tid; j < 2ll * (mask + 1ull); j += stride) ref[j] = 0u;
  siddhi_grid_last(ws + WS_BAR, ws + WS_DONE);
}

int mask_capacity() {
  static int cap = -1;
  if (cap < 0) {
    const int c = siddhi_coop_capacity(k13e_mask, BLOCK);
    if (c <= 0) return 0;
    cap = c;
  }
  return cap;
}

int eq_capacity() {
  static int cap = -1;
  if (cap < 0) {
    const int c = siddhi_coop_capacity(k13e_eq, EQ_BLOCK);
    if (c <= 0) return 0;
    cap = c;
  }
  return cap;
}

// Slots of the equality route's table for B lanes: a power of two, at
// least 2 B.
long long eq_slots(int B) {
  long long s = MIN_SLOTS;
  while (s < 2ll * B) s <<= 1;
  return s;
}

int grid_of(long long work, int cap, int block) {
  const long long want = (work + block - 1) / block;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Bytes of the workspace a call of B lanes against C rows needs (either
// route); 0 where the card has no cooperative launches.
SIDDHI_API long long k13e_workspace_bytes(int B, int C) {
  if (mask_capacity() <= 0 || eq_capacity() <= 0) return 0;
  const long long dense = static_cast<long long>(C) + (B + 31ll) / 32;
  const long long eq = 2 * eq_slots(B) + B;
  return 4 * (WS_HEAD + (dense > eq ? dense : eq));
}

// k13e_last_match: cond bool, element (b, c) at cond[b * sb + c * sc]
// (strides in elements, either may be 0), or null for the scalar cval;
// lane_valid bool[B] (null: every lane), row_valid bool[C] (null: every
// row); has bool[C], b_star int32[C], ev bool[B] out; ws the workspace.
SIDDHI_API int k13e_last_match(const uint8_t* cond, long long sb,
                               long long sc, int cval,
                               const uint8_t* lane_valid,
                               const uint8_t* row_valid, int B, int C,
                               unsigned* ws, bool* has, int* b_star,
                               bool* ev, cudaStream_t stream) {
  if (B < 1 || C < 1 || sb < 0 || sc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = mask_capacity();
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  MaskArgs a;
  a.cond = cond;
  a.sb = cond ? sb : 0;
  a.sc = cond ? sc : 0;
  a.cval = cval;
  a.lv = lane_valid;
  a.rv = row_valid;
  a.B = B;
  a.C = C;
  a.rows = 32;
  a.ctiles = static_cast<int>(siddhi_blocks(C, TILE_C));
  a.items = 0;
  a.vec = a.sc == 1 && a.sb % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(cond) & 15u) == 0u;
  int grid;
  if (a.sb != 0 && a.sc != 0) {
    // about one item a co-resident block
    const int chunks = cap / a.ctiles > 1 ? cap / a.ctiles : 1;
    const long long rows = (B + chunks - 1ll) / chunks;
    a.rows = static_cast<int>(((rows + 31) / 32) * 32);
    const long long items =
        static_cast<long long>(a.ctiles) * ((B + a.rows - 1ll) / a.rows);
    a.items = static_cast<int>(items);
    grid = a.items < cap ? a.items : cap;
  } else {
    grid = grid_of(B > C ? B : C, cap, BLOCK);
  }
  void* args[] = {&a, &ws, &has, &b_star, &ev};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k13e_mask), dim3(grid), dim3(BLOCK),
      args, 0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}

// k13e_last_match_eq: the mask AND_k lane_keys[k][b] == row_keys[k][c] &
// lane_valid[b] & row_valid[c] without building it. lane_keys/row_keys/
// types: n_keys host entries (device pointers [B] and [C]; types
// K_I8..K_F64, both sides of one type); lane_valid bool[B], row_valid
// bool[C]; outputs as k13e_last_match.
SIDDHI_API int k13e_last_match_eq(const void* const* lane_keys,
                                  const void* const* row_keys,
                                  const int* types, int n_keys,
                                  const bool* lane_valid,
                                  const bool* row_valid, int B, int C,
                                  unsigned* ws, bool* has, int* b_star,
                                  bool* ev, cudaStream_t stream) {
  if (n_keys < 1 || n_keys > MAX_KEYS || B < 1 || C < 1 ||
      B >= (1 << 29) || lane_valid == nullptr || row_valid == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  KeyCols lanes, rows;
  lanes.n = rows.n = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    if (types[k] < K_I8 || types[k] > K_F64)
      return static_cast<int>(cudaErrorInvalidValue);
    lanes.col[k] = lane_keys[k];
    rows.col[k] = row_keys[k];
    lanes.type[k] = rows.type[k] = types[k];
  }
  const int cap = eq_capacity();
  if (cap <= 0) return static_cast<int>(cudaErrorNotSupported);
  const int grid = grid_of(B > C ? B : C, cap, EQ_BLOCK);
  unsigned mask = static_cast<unsigned>(eq_slots(B) - 1);
  void* args[] = {&lanes, &rows, &lane_valid, &row_valid, &B, &C,
                  &mask,  &ws,   &has,        &b_star,    &ev};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k13e_eq), dim3(grid), dim3(EQ_BLOCK),
      args, 0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}
