// K4 — open-addressing key table: group-by keys -> dense int32 ids.
//
// Replaces siddhi_tpu/ops/groupby.py `key_lookup_or_insert` and reproduces
// its table state, not only its ids: H = 2K int64 slots (INT64_MAX = empty),
// a double-hashed probe window per key (32 slots: the JAX window's 16 and 16
// more, used only by keys whose first 16 slots are all taken, which the JAX
// table drops)
//   h32 = (lo ^ hi) * 0x9E3779B9 (u32),  base = h32 % H,
//   stride = 1 + 2 * ((h32 >> 16) & 7),
// the first match and the first empty slot in window order, five claim
// waves in which the smaller key wins a contested slot (the JAX scatter-min),
// dense ids ranked in slot order, and the overflow revert with `misses`.
//
// Bound on the H100: bytes, in random 8-byte gathers. A probe reads up to 32
// table words per lane from a 16 MB table (H = 2^21), which the 50 MB L2
// mostly holds; the least time for a call is its lane I/O and one slot read
// per lane, well under a microsecond at 3.35 TB/s. What costs is latency:
// dependent L2 reads and, between the waves, grid-wide barriers.
//
// Design: ONE cooperative launch a call (at most the co-resident blocks of
// 512 threads, two an SM). A thread keeps its lanes (up to LPT in
// registers, the rest in the scratch) across the phases: key, state flags,
// its slot (the matched slot, or while it needs one the first empty slot
// of its window) and that slot's window index.
//   probe    every valid lane reads its window (slot 0 alone, then batches
//            of PROBE_BATCH) up to its key or, while count < K, up to the
//            first empty slot: a key is placed at the first empty slot of
//            its window and slots empty again only by a revert, after
//            which count is K, so no key sits past an empty slot then (at
//            count K the whole window is read). It counts, in a flag of
//            the workspace, whether any lane needs a slot and has an empty
//            one; grid barrier;
//   steady   flag clear (every key present, or no room): straight to the
//            resolve. This is JAX's lax.cond(any(need)); a steady-state
//            call is one probe, one barrier and the resolve;
//   waves    else up to 5: each lane that needs a slot and has an empty
//            one does atomicMin(slot, key); grid barrier; the re-probe
//            reads its claimed slot: its key there means won (same-key
//            lanes claim the same slot, so they win together), else it
//            looks for the next empty slot after the claimed one in window
//            order (the slots before it were taken and stay taken, and no
//            other slot of the window can hold its key); grid barrier. A
//            wave after which no lane can claim ends the loop early: the
//            waves left would change nothing;
//   rank     each won lane sets its slot's bit in a bitmap of H bits (the
//            workspace); each block counts the bits of its share of the
//            words (a block scan writes each word's prefix in the share);
//            grid barrier; each block scans the shares' totals, and a won
//            slot's rank in slot order is its share's base + its word's
//            prefix + the set bits below it in the word. No sort;
//   commit   id = count + rank, or, at K and beyond, the slot reverts to
//            empty; grid barrier;
//   resolve  a lane resolves if it is valid, needs no slot and its slot
//            still holds its key; misses grow by the valid lanes that do
//            not. Won lanes zero their bitmap word; the block that
//            finishes last writes count = min(count + n_new, K) and zeroes
//            the flags and barrier counters.
// An insert-heavy call crosses 2 + 2 w + 1 barriers for w waves run (13 at
// five), each a few microseconds: that, not bytes, sets its time. Every
// read of the table goes through L2 (__ldcg): other blocks write it inside
// the launch.
// Workspace (the library's, per stream; zero on entry, zero after every
// launch): the barrier and done counters, the waves' flags, the bitmap.
// Scratch (written before it is read): the shares' totals, the words'
// prefixes, the spilled lanes' state. Nothing is read back to the host.

#include "common.cuh"

namespace {

constexpr int BLOCK = 512;
constexpr int NW = BLOCK / 32;
constexpr int DEPTH = 32;
constexpr int PROBE_BATCH = 4;  // window slots read at once past slot 0
constexpr int WAVES = 5;
constexpr int LPT = 2;          // lanes a thread keeps in registers
constexpr int MAX_GRID = 1024;  // blocks at most (the shares' scan)
constexpr long long KEY_PAD = 0x7FFFFFFFFFFFFFFFll;
// workspace words: the barrier, the done counter, the probe's and each
// wave's flag, then the bitmap of won slots
constexpr int WS_BAR = 0;
constexpr int WS_DONE = 1;
constexpr int WS_FLAGS = 2;
constexpr int WS_BITMAP = 8;
static_assert(WS_FLAGS + WAVES + 1 <= WS_BITMAP, "flags overlap the bitmap");
// lane flags
constexpr unsigned F_VALID = 1u;
constexpr unsigned F_NEED = 2u;
constexpr unsigned F_CLAIMED = 4u;
constexpr unsigned F_WON = 8u;

__device__ __forceinline__ long long load_key(const long long* keys, int i) {
  const long long k = keys[i];
  return k == KEY_PAD ? KEY_PAD - 1 : k;  // never collide with the pad
}

struct Window {
  unsigned base;
  unsigned stride;
};

__device__ __forceinline__ Window window_of(long long key, unsigned H) {
  const unsigned long long u = static_cast<unsigned long long>(key);
  unsigned h32 = static_cast<unsigned>(u) ^ static_cast<unsigned>(u >> 32);
  h32 *= 0x9E3779B9u;
  Window w;
  w.base = h32 % H;
  w.stride = 1u + 2u * ((h32 >> 16) & 7u);
  return w;
}

__device__ __forceinline__ unsigned slot_at(Window w, int d, unsigned H) {
  return (w.base + static_cast<unsigned>(d) * w.stride) % H;
}

struct Lane {
  long long key;
  int slot;    // the matched slot, or while F_NEED the first empty one
  int de;      // the empty slot's window index, DEPTH if none
  unsigned f;  // F_VALID | F_NEED | F_CLAIMED | F_WON
};

// The window in order: the first match, else the first empty slot. Slot 0
// alone, then batches of PROBE_BATCH. With `stop`, the scan ends at the
// first empty slot: a key is placed at the first empty slot of its window
// and no slot empties again (but by a revert, after which count is K), so
// while count < K no key sits past an empty slot of its window.
__device__ __forceinline__ void probe_window(const long long* tbl, unsigned H,
                                             Lane& l, bool stop) {
  const Window w = window_of(l.key, H);
  int de = DEPTH;
  unsigned es = 0u;
  {
    const long long k = __ldcg(tbl + w.base);
    if (k == l.key) {
      l.f &= ~F_NEED;
      l.slot = static_cast<int>(w.base);
      return;
    }
    if (k == KEY_PAD) {
      de = 0;
      es = w.base;
    }
  }
  for (int d0 = 1; d0 < DEPTH && !(stop && de < DEPTH); d0 += PROBE_BATCH) {
    long long k[PROBE_BATCH];
    unsigned s[PROBE_BATCH];
#pragma unroll
    for (int q = 0; q < PROBE_BATCH; ++q) {
      s[q] = slot_at(w, d0 + q, H);
      if (d0 + q < DEPTH) k[q] = __ldcg(tbl + s[q]);
    }
#pragma unroll
    for (int q = 0; q < PROBE_BATCH; ++q) {
      if (d0 + q >= DEPTH || (stop && de < DEPTH)) break;
      if (k[q] == l.key) {
        l.f &= ~F_NEED;
        l.slot = static_cast<int>(s[q]);
        return;
      }
      if (k[q] == KEY_PAD && de == DEPTH) {
        de = d0 + q;
        es = s[q];
      }
    }
  }
  l.de = de;
  l.slot = static_cast<int>(es);
}

// Applies fn(lane state, lane index) to each of this thread's lanes: lane
// gt + q * nthreads, in registers for q < LPT, else loaded from and stored
// back to the scratch.
template <typename Fn>
__device__ __forceinline__ void for_lanes(Lane (&reg)[LPT], int gt,
                                          int nthreads, int nq, int L,
                                          const long long* keys,
                                          int* sp_slot, unsigned* sp_meta,
                                          Fn fn) {
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    const int i = gt + q * nthreads;
    if (q < nq && i < L) fn(reg[q], i);
  }
  for (int q = LPT; q < nq; ++q) {
    const int i = gt + q * nthreads;
    if (i >= L) break;
    Lane l;
    l.key = load_key(keys, i);
    l.slot = sp_slot[i];
    const unsigned m = sp_meta[i];
    l.de = static_cast<int>(m & 0xffu);
    l.f = m >> 8;
    fn(l, i);
    sp_slot[i] = l.slot;
    sp_meta[i] = static_cast<unsigned>(l.de) | l.f << 8;
  }
}

// Raises flag word `flag` where some thread of the block wants.
__device__ __forceinline__ void publish(bool want, unsigned* flag) {
  if (__syncthreads_or(want) && threadIdx.x == 0) atomicAdd(flag, 1u);
}

__global__ void __launch_bounds__(BLOCK, 2)
    k4_lookup_insert(long long* tbl, int32_t* ids, int32_t* count,
                     int32_t* misses, const long long* __restrict__ keys,
                     const bool* __restrict__ valid, int L, unsigned H,
                     int K, int32_t* __restrict__ out_ids,
                     bool* __restrict__ resolved, unsigned* ws,
                     unsigned* scratch) {
  __shared__ int scan[NW];
  __shared__ int cbase[MAX_GRID];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int nthreads = G * BLOCK;
  const int gt = g * BLOCK + tid;
  const int nq = (L + nthreads - 1) / nthreads;
  const unsigned nwords = (H + 31u) / 32u;
  unsigned* flags = ws + WS_FLAGS;
  unsigned* bitmap = ws + WS_BITMAP;
  int* share_tot = reinterpret_cast<int*>(scratch);  // [MAX_GRID]
  int* wprefix = share_tot + MAX_GRID;               // [nwords]
  int* sp_slot = wprefix + nwords;                   // [L] when lanes spill
  unsigned* sp_meta = reinterpret_cast<unsigned*>(sp_slot + L);
  const int count0 = *count;
  unsigned phase = 0;
  Lane reg[LPT];

  bool want = false;
  for_lanes(reg, gt, nthreads, nq, L, keys, sp_slot, sp_meta,
            [&](Lane& l, int i) {
              l.key = load_key(keys, i);
              l.slot = 0;
              l.de = DEPTH;
              l.f = valid[i] ? F_VALID | F_NEED : 0u;
              if (l.f) probe_window(tbl, H, l, count0 < K);
              want |= (l.f & F_NEED) && l.de < DEPTH;
            });
  publish(want, flags);
  siddhi_grid_sync(ws + WS_BAR, phase);

  int total = 0;  // distinct won slots
  if (__ldcg(flags) != 0u) {
    for (int r = 0; r < WAVES; ++r) {
      for_lanes(reg, gt, nthreads, nq, L, keys, sp_slot, sp_meta,
                [&](Lane& l, int) {
                  if ((l.f & F_NEED) && l.de < DEPTH) {
                    atomicMin(tbl + l.slot, l.key);
                    l.f |= F_CLAIMED;
                  }
                });
      siddhi_grid_sync(ws + WS_BAR, phase);
      want = false;
      for_lanes(reg, gt, nthreads, nq, L, keys, sp_slot, sp_meta,
                [&](Lane& l, int) {
                  if (!(l.f & F_CLAIMED)) return;
                  l.f &= ~F_CLAIMED;
                  if (__ldcg(tbl + l.slot) == l.key) {
                    l.f = (l.f & ~F_NEED) | F_WON;
                    atomicOr(bitmap + (l.slot >> 5), 1u << (l.slot & 31));
                    return;
                  }
                  const Window w = window_of(l.key, H);
                  int de = DEPTH;
                  unsigned es = 0u;
                  for (int d = l.de + 1; d < DEPTH; ++d) {
                    const unsigned s = slot_at(w, d, H);
                    if (__ldcg(tbl + s) == KEY_PAD) {
                      de = d;
                      es = s;
                      break;
                    }
                  }
                  l.de = de;
                  l.slot = static_cast<int>(es);
                  want |= de < DEPTH;
                });
      publish(want, flags + r + 1);
      siddhi_grid_sync(ws + WS_BAR, phase);
      if (__ldcg(flags + r + 1) == 0u) break;  // no lane can claim
    }
    // each block's share of the bitmap's words: their prefixes and total
    const unsigned chunk = (nwords + G - 1) / G;
    const unsigned w0 = min(nwords, g * chunk);
    const unsigned w1 = min(nwords, w0 + chunk);
    int carry = 0;
    for (unsigned x = w0; x < w1; x += BLOCK) {
      const unsigned w = x + tid;
      const int c = w < w1 ? __popc(__ldcg(bitmap + w)) : 0;
      int tot;
      const int ex = block_exclusive_sum<BLOCK>(c, scan, &tot);
      if (w < w1) wprefix[w] = carry + ex;
      carry += tot;
    }
    if (tid == 0) share_tot[g] = carry;
    siddhi_grid_sync(ws + WS_BAR, phase);
    for (int c = 0; c < G; c += BLOCK) {
      const int x = c + tid < G ? __ldcg(share_tot + c + tid) : 0;
      int tot;
      const int ex = block_exclusive_sum<BLOCK>(x, scan, &tot);
      if (c + tid < G) cbase[c + tid] = total + ex;
      total += tot;
    }
    __syncthreads();
    for_lanes(reg, gt, nthreads, nq, L, keys, sp_slot, sp_meta,
              [&](Lane& l, int) {
                if (!(l.f & F_WON)) return;
                const unsigned w = static_cast<unsigned>(l.slot) >> 5;
                const unsigned below = (1u << (l.slot & 31)) - 1u;
                const int rank = cbase[w / chunk] + __ldcg(wprefix + w) +
                                 __popc(__ldcg(bitmap + w) & below);
                const long long id = static_cast<long long>(count0) + rank;
                if (id >= K)
                  tbl[l.slot] = KEY_PAD;  // no id left: revert
                else
                  ids[l.slot] = static_cast<int32_t>(id);
              });
    siddhi_grid_sync(ws + WS_BAR, phase);
  }

  int miss = 0;
  for_lanes(reg, gt, nthreads, nq, L, keys, sp_slot, sp_meta,
            [&](Lane& l, int i) {
              bool ok = false;
              int id = 0;
              if ((l.f & F_VALID) && !(l.f & F_NEED)) {
                ok = __ldcg(tbl + l.slot) == l.key;
                if (ok) id = __ldcg(ids + l.slot);
              }
              out_ids[i] = id;
              resolved[i] = ok;
              miss += (l.f & F_VALID) && !ok;
              if (l.f & F_WON) bitmap[l.slot >> 5] = 0u;
            });
  int block_miss;
  block_exclusive_sum<BLOCK>(miss, scan, &block_miss);
  if (tid == 0 && block_miss) atomicAdd(misses, block_miss);
  if (siddhi_grid_last(ws + WS_BAR, ws + WS_DONE)) {
    if (tid <= WAVES) flags[tid] = 0u;
    if (tid == 0) {
      const long long room = static_cast<long long>(K) - count0;
      const long long n_new = room < 0 ? 0 : (total < room ? total : room);
      const long long c = count0 + n_new;
      *count = static_cast<int32_t>(c < K ? c : K);
    }
  }
}

int capacity() {
  static int cap = -1;
  if (cap < 0) {
    const int c = siddhi_coop_capacity(k4_lookup_insert, BLOCK);
    if (c <= 0) return 0;
    cap = c;
  }
  return cap;
}

int grid_of(int L) {
  int g = static_cast<int>(siddhi_blocks(L, BLOCK));
  const int cap = capacity();
  if (g > cap) g = cap;
  return g < MAX_GRID ? g : MAX_GRID;
}

long long words_of(int H) { return (static_cast<long long>(H) + 31) / 32; }

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

// Bytes of the workspace for a table of H slots (zero when first
// allocated, zero after every call).
SIDDHI_API long long k4_workspace_bytes(int H) {
  return 4 * (WS_BITMAP + words_of(H));
}

// Bytes of the scratch for a call of L lanes into H slots; 0 where the card
// has no cooperative launches.
SIDDHI_API long long k4_scratch_bytes(int H, int L) {
  const int G = grid_of(L);
  if (G <= 0) return 0;
  const bool spill = static_cast<long long>(L) > 1ll * LPT * G * BLOCK;
  return 4 * (MAX_GRID + words_of(H)) + (spill ? 8ll * L : 0);
}

// One call: tbl int64[H] and ids int32[H] updated in place, count and
// misses the table's int32 scalars; keys int64[L], valid bool[L]; out_ids
// int32[L] and resolved bool[L] out; ws and scratch as sized above.
SIDDHI_API int k4_lookup_or_insert(long long* tbl, int32_t* ids,
                                   int32_t* count, int32_t* misses,
                                   const long long* keys, const bool* valid,
                                   int L, int H, int32_t* out_ids,
                                   bool* resolved, unsigned* ws,
                                   unsigned* scratch, cudaStream_t stream) {
  if (L <= 0) return 0;
  if (H < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_of(L);
  if (grid <= 0) return static_cast<int>(cudaErrorNotSupported);
  unsigned uH = static_cast<unsigned>(H);
  int K = H / 2;
  void* args[] = {&tbl, &ids,     &count,    &misses, &keys,
                  &valid, &L,     &uH,       &K,      &out_ids,
                  &resolved, &ws, &scratch};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k4_lookup_insert), dim3(grid),
      dim3(BLOCK), args, 0, stream);
  return e != cudaSuccess ? static_cast<int>(e) : siddhi_launch_status();
}
