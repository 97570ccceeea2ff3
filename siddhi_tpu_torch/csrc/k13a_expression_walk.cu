// K13a — the sequential condition walk of the general expression windows.
//
// Replaces two loops of siddhi_tpu/ops/expression_general.py that evaluate
// an arbitrary window condition (`_compile_condition`) once per check over
// arrival-order metric arrays (`_metric_env`: value sequences, prefix sums
// and squared prefix sums, float64):
//   mode 0 — `GeneralExpressionWindow._frontiers`, a lax.while_loop: each
//     arrival is added, then the window pops from the front while the
//     condition is false (at most E pops a step, and an empty window stops
//     the loop). Out: s_vec[B] (the frontier each arrival settles at; lanes
//     past the walk take the final one) and the final frontier s.
//   mode 1 — `GeneralExpressionBatchWindow.step`'s lax.scan: one check per
//     arrival over the accumulating window; a false check on a valid lane
//     flushes. Out: flush[B], end_j[B], empty[B] and the final start s.
//
// The condition arrives as a postfix program built once per query on the
// host (ops/expression_general.py `compile_postfix`): int32 (op, a, b)
// triples, float64 constants and the metric arrays' device pointers, all
// passed by value as one kernel parameter (no upload, no host sync). The
// walk copies it to shared memory and interprets it on a float64 stack;
// booleans are 0.0 / 1.0.
//
// What is kept bit for bit with the JAX function:
//   - every add, subtract, multiply, divide and sqrt is one IEEE operation
//     rounded to nearest (the __d*_rn intrinsics, so nvcc does not contract
//     a*b+c into an FMA that rounds once);
//   - `%` is jnp.remainder: the truncated fmod, then the divisor added when
//     the signs differ and the remainder is not 0 (floored modulo);
//   - stdDev's clamp keeps NaN, as jnp.maximum(nan, 0) does (fmax would
//     give 0);
//   - an empty window (count 0) divides 0 by 0: NaN means, and every
//     comparison with NaN is false (!= is true);
//   - &, | and ~ evaluate both sides (no short circuit) — the program has
//     no jumps;
//   - an index past an array's end is clamped, as a JAX gather clamps.
//
// The walk, in one block of 512 threads (one SM; no host sync, no launch
// a tile):
//   mode 1 — while the window start s is fixed, the checks of arrivals j,
//     j+1, ... are independent: the block checks 512 arrivals at once, a
//     ballot and a find-first over the block give the first that flushes;
//     the lanes before it are written as no-flush, s becomes its end_j and
//     the next tile starts after it.
//   mode 0 — speculation with an exact sequential resolution. An arrival
//     tile gives each of 60 arrivals j' a band of 32 candidate starts s'
//     (a warp evaluates four bands, a lane one start of each) and
//     evaluates on every s' the pop-check P(j', s') = cond([s', q_j'], cur
//     = s' - 1) and the add-check A(j', s') = cond([s', q_j'], cur = q_j')
//     (the same check when the condition never reads the current event),
//     as two 32-bit masks a band. From them every (arrival, start) entry
//     gets its response: the arrival settles at s' if A holds there, else
//     at the first s'' > s' where P holds or a stop is forced (s'' > q_j'
//     or s'' >= E), after exactly the checks the loop makes; and the entry
//     where the next arrival then starts, if that lies in its band. Warp 0
//     follows the entries from the tile's start (one dependent shared
//     load an arrival), sums the checks and settles the prefix of
//     arrivals that stay in their bands under the 2B + E + 8 cap; its
//     lane 0 replays the rest check for check from the masks, so the
//     bailout lands where the loop's does. Meanwhile the other 15 warps
//     evaluate the next arrival tile ahead, from the frontier the drift
//     predicts; it is used when the walk reaches its first arrival inside
//     its first band, and evaluated again from the real start otherwise.
//     A band starts at the predicted frontier (frontier moved an arrival,
//     smoothed over tiles) less a margin; a pop chain that outruns its
//     band continues in a chain tile, whose 60 bands cover 1,920
//     consecutive starts of that one arrival. Lanes past the walk take
//     the final frontier in the same launch.
// The program lives in shared memory. Each thread evaluates its checks in
// one pass of the interpreter, the top two stack slots in registers.
//
// Bound on the H100: bytes — the arrays the program indexes, at the
// positions the walk visits, and the outputs' writes (about 2 MB for app
// X's condition, under a microsecond at 3.35 TB/s). The time is the chain
// of dependent tiles (app X's sliding walk: ~2,500 tiles of ~53
// arrivals): each is an evaluation pass over its bands, bound by
// instruction throughput on one SM, overlapped with the previous tile's
// serial follow.

#include <climits>

#include "common.cuh"

namespace {

constexpr int MAX_INSTR = 64;
constexpr int MAX_CONSTS = 32;
constexpr int MAX_ARRAYS = 24;
constexpr int MAX_STACK = 16;
constexpr int WALK = 512;          // threads of the walking block
constexpr int NWARP = WALK / 32;
constexpr int TILE = 60;           // arrivals of an arrival tile
// segments a warp evaluates for a tile evaluated at once, and for one
// evaluated ahead (warp 0 follows the tile before meanwhile)
constexpr int ARR = (TILE + NWARP - 1) / NWARP;
constexpr int AHEAD = (TILE + NWARP - 2) / (NWARP - 1);
static_assert(TILE <= 64 && TILE <= WALK, "warp 0 settles two a lane");
constexpr int BAND = 32;           // candidate starts of an arrival
constexpr int MARGIN = 12;         // a band starts this far below the
                                   // predicted frontier
constexpr unsigned FULL = 0xffffffffu;

// opcodes; keep in step with ops/expression_general.py `_OPS`
enum Op : int {
  OP_CONST = 0,  // push consts[a]
  OP_COUNT = 1,  // push (double)(q + 1 - s)
  OP_SEQ = 2,    // push arrays[a][frame b: 0 current, 1 first, 2 last]
  OP_SUM = 3,    // push pre[q + 1] - pre[s], pre = arrays[a]
  OP_AVG = 4,    // that sum / count
  OP_STD = 5,    // sqrt(max(E[x^2] - mean^2, 0)), squares in arrays[b]
  OP_ADD = 6,
  OP_SUB = 7,
  OP_MUL = 8,
  OP_DIV = 9,
  OP_MOD = 10,
  OP_LT = 11,
  OP_LE = 12,
  OP_GT = 13,
  OP_GE = 14,
  OP_EQ = 15,
  OP_NE = 16,
  OP_AND = 17,
  OP_OR = 18,
  OP_NOT = 19,
};

struct Program {
  int op[MAX_INSTR];
  int a[MAX_INSTR];
  int b[MAX_INSTR];
  double consts[MAX_CONSTS];
  const double* arrays[MAX_ARRAYS];
  int len[MAX_ARRAYS];
  int n;
  int n_arrays;
};

__device__ __forceinline__ double load(const double* a, int n, long long i) {
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return a[i];
}

__device__ __forceinline__ double truth(bool v) { return v ? 1.0 : 0.0; }

// jnp.remainder: the truncated fmod, then the divisor added when the signs
// differ and the remainder is not 0
__device__ __forceinline__ double floored_mod(double x, double y) {
  double r = fmod(x, y);
  if (r != 0.0 && ((r < 0.0) != (y < 0.0))) r = __dadd_rn(r, y);
  return r;
}

// Ask L2 for the 128-byte line of position i of array k (clamped).
__device__ __forceinline__ void prefetch(const Program& p, int k,
                                         long long i) {
#ifdef __CUDA_ARCH__
  const int n = p.len[k];
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p.arrays[k] + i));
#endif
}

// The condition over window [s[c], q[c]] for N checks c at once (one pass
// of the interpreter, their loads in flight together); `cur` is the current
// event's position and `fi` the first one's (min(s, q)). The top two
// stack slots live in registers (the program is the same in every thread,
// so depth tests do not diverge); deeper slots go to memory.
template <int N>
__device__ void eval_n(const Program& p, const int (&s)[N],
                       const int (&q)[N], const int (&cur)[N],
                       const int (&fi)[N], bool (&out)[N]) {
  double t0[N], t1[N];          // top, next
  double st[MAX_STACK - 2][N];  // slot k < sp - 2
#pragma unroll
  for (int c = 0; c < N; ++c) t0[c] = t1[c] = 0.0;
  int sp = 0;
  for (int i = 0; i < p.n; ++i) {
    const int a = p.a[i];
    const int b = p.b[i];
    const int op = p.op[i];
    if (op <= OP_STD) {  // a push; each kind's loads go out together
      double v[N];
      if (op == OP_CONST) {
#pragma unroll
        for (int c = 0; c < N; ++c) v[c] = p.consts[a];
      } else if (op == OP_COUNT) {
#pragma unroll
        for (int c = 0; c < N; ++c)
          v[c] = static_cast<double>(q[c] + 1 - s[c]);
      } else if (op == OP_SEQ) {
        const double* arr = p.arrays[a];
        const int len = p.len[a];
#pragma unroll
        for (int c = 0; c < N; ++c)
          v[c] = load(arr, len, b == 1 ? fi[c] : (b == 2 ? q[c] : cur[c]));
      } else {  // OP_SUM, OP_AVG, OP_STD
        const double* arr = p.arrays[a];
        const int len = p.len[a];
        double hi[N], lo[N];
#pragma unroll
        for (int c = 0; c < N; ++c) {
          hi[c] = load(arr, len, q[c] + 1);
          lo[c] = load(arr, len, s[c]);
        }
#pragma unroll
        for (int c = 0; c < N; ++c) v[c] = __dsub_rn(hi[c], lo[c]);
        if (op != OP_SUM) {
          double hi2[N], lo2[N];
          if (op == OP_STD) {
            const double* arr2 = p.arrays[b];
            const int len2 = p.len[b];
#pragma unroll
            for (int c = 0; c < N; ++c) {
              hi2[c] = load(arr2, len2, q[c] + 1);
              lo2[c] = load(arr2, len2, s[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < N; ++c) {
            const double cnt = static_cast<double>(q[c] + 1 - s[c]);
            const double mean = __ddiv_rn(v[c], cnt);
            if (op == OP_AVG) {
              v[c] = mean;
              continue;
            }
            const double ex2 = __ddiv_rn(__dsub_rn(hi2[c], lo2[c]), cnt);
            double w = __dsub_rn(ex2, __dmul_rn(mean, mean));
            w = (w > 0.0 || w != w) ? w : 0.0;  // jnp.maximum keeps NaN
            v[c] = __dsqrt_rn(w);
          }
        }
      }
      if (sp >= 2) {
#pragma unroll
        for (int c = 0; c < N; ++c) st[sp - 2][c] = t1[c];
      }
#pragma unroll
      for (int c = 0; c < N; ++c) {
        t1[c] = t0[c];
        t0[c] = v[c];
      }
      ++sp;
    } else if (op == OP_NOT) {
#pragma unroll
      for (int c = 0; c < N; ++c) t0[c] = truth(t0[c] == 0.0);
    } else {  // a binary operator: next (op) top, into top
#define SIDDHI_K13A_BINARY(expr)                 \
  _Pragma("unroll") for (int c = 0; c < N; ++c) { \
    const double x = t1[c], y = t0[c];            \
    t0[c] = (expr);                               \
  }                                               \
  break;
      switch (op) {
        case OP_ADD: SIDDHI_K13A_BINARY(__dadd_rn(x, y))
        case OP_SUB: SIDDHI_K13A_BINARY(__dsub_rn(x, y))
        case OP_MUL: SIDDHI_K13A_BINARY(__dmul_rn(x, y))
        case OP_DIV: SIDDHI_K13A_BINARY(__ddiv_rn(x, y))
        case OP_MOD: SIDDHI_K13A_BINARY(floored_mod(x, y))
        case OP_LT: SIDDHI_K13A_BINARY(truth(x < y))
        case OP_LE: SIDDHI_K13A_BINARY(truth(x <= y))
        case OP_GT: SIDDHI_K13A_BINARY(truth(x > y))
        case OP_GE: SIDDHI_K13A_BINARY(truth(x >= y))
        case OP_EQ: SIDDHI_K13A_BINARY(truth(x == y))
        case OP_NE: SIDDHI_K13A_BINARY(truth(x != y))
        case OP_AND: SIDDHI_K13A_BINARY(truth((x != 0.0) & (y != 0.0)))
        default: SIDDHI_K13A_BINARY(truth((x != 0.0) | (y != 0.0)))  // OR
      }
#undef SIDDHI_K13A_BINARY
      if (sp >= 3) {
#pragma unroll
        for (int c = 0; c < N; ++c) t1[c] = st[sp - 3][c];
      }
      --sp;
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = t0[c] != 0.0;
}

__device__ __forceinline__ bool eval(const Program& p, int s, int q, int cur,
                                     int fi) {
  bool out[1];
  eval_n<1>(p, {s}, {q}, {cur}, {fi}, out);
  return out[0];
}

// (frontier, checks) an arrival settles with when its add-check starts at
// band start b + c (masks am, pm of its band, q its position); x = -1
// where its pop chain runs past the band.
__device__ __forceinline__ int2 respond(unsigned am, unsigned pm, int c,
                                        int b, int q, int E) {
  const int s_in = b + c;
  if ((am >> c) & 1u) return make_int2(s_in, 1);
  const int forced = max(s_in + 1, min(q + 1, E));
  const unsigned m = c + 1 < BAND ? pm & (~0u << (c + 1)) : 0u;
  const int stop = min(m ? b + __ffs(m) - 1 : INT_MAX, forced);
  if (stop < b + BAND) return make_int2(stop, 1 + stop - s_in);
  return make_int2(-1, 0);
}

// Band start of segment r of an arrival tile whose first arrival is
// predicted to start at `base`: the frontier predicted r arrivals on, less
// MARGIN, never below `lo` (where the tile before started, or this tile's
// own start when it is known).
__device__ __forceinline__ int band_start(int base, int lo, int r,
                                          float drift) {
  const float ahead = fminf(r * drift, 16777216.0f);
  return max(lo, base + __float2int_rd(ahead) - MARGIN);
}

constexpr int SINK = TILE * BAND;

// Two tiles' evaluations, by turns: entry r * BAND + c (segment r, band
// start c) holds where its arrival settles from that start, as an offset
// into its band (-1: its pop chain leaves the band), the checks it makes,
// and the entry where the next arrival then starts (SINK: outside its
// band, or the tile's last); SINK settles nothing and leads to itself.
struct Tiles {
  signed char x[2][SINK + 1];
  unsigned char k[2][SINK + 1];
  short next[2][SINK + 1];
  unsigned a_bits[2][TILE], p_bits[2][TILE];  // each band's masks
  int seg_b[2][TILE];                          // each band's start
  int settled[2][TILE];  // the frontier each settled arrival leaves
};

// The walk's state before a tile, by turns (thread 0 writes the next
// while the others may still read this one): `have` says the tile's
// evaluation was made ahead and holds its start, at entry e0.
struct WalkState {
  int j, s, it, pop, fin, n, have, e0;
  float drift;
};

// This warp's segments of a tile into buffer c, segment r = (warp -
// first) + n * u for u < U (the warps first, ..., first + n - 1 share the
// tile): a chain tile (bands of consecutive starts past s for arrival jt)
// or an arrival tile (arrival jt + r in band band_start(base, lo, r,
// drift)).
template <int U>
__device__ void eval_segments(const Program& p, Tiles& T, int c, bool chain,
                              int jt, int s, int base, int lo, float drift,
                              int w0, int nv, int E, bool uses_cur,
                              int first, int n) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int jr[U], br[U], q[U], sp[U], fi[U], cur[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = min(warp - first + n * u, TILE - 1);
    jr[u] = chain ? jt : jt + r;
    br[u] = chain ? s + 1 + BAND * r : band_start(base, lo, r, drift);
    q[u] = w0 + jr[u];
    sp[u] = br[u] + lane;
    fi[u] = min(sp[u], q[u]);
    cur[u] = sp[u] - 1;
  }
  // this lane's checks at its start of each band: the pop-check, and in
  // an arrival tile the add-check (the same check when the condition
  // never reads the current event)
  bool pk[U], ak[U];
  eval_n<U>(p, sp, q, cur, fi, pk);
  if (!chain && uses_cur) {
    eval_n<U>(p, sp, q, q, fi, ak);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) ak[u] = pk[u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = warp - first + n * u;
    if (r >= TILE) break;  // warp-uniform
    const unsigned am = __ballot_sync(FULL, ak[u]);
    const unsigned pm = __ballot_sync(FULL, pk[u]);
    if (lane == 0) {
      T.a_bits[c][r] = am;
      T.p_bits[c][r] = pm;
      T.seg_b[c][r] = br[u];
    }
    if (!chain) {
      const int2 f = jr[u] < nv ? respond(am, pm, lane, br[u], q[u], E)
                                : make_int2(-1, 0);
      int nxt = SINK;
      if (f.x >= 0 && r + 1 < TILE) {
        const int off = f.x - band_start(base, lo, r + 1, drift);
        if (off >= 0 && off < BAND) nxt = (r + 1) * BAND + off;
      }
      const int e = r * BAND + lane;
      T.x[c][e] = static_cast<signed char>(f.x >= 0 ? f.x - br[u] : -1);
      T.k[c][e] = static_cast<unsigned char>(f.y);
      T.next[c][e] = static_cast<short>(nxt);
    }
  }
}

// mode 0: the add-then-pop-while-false loop (expression_general.py:295-332)
__global__ void __launch_bounds__(WALK)
    k13a_sliding(Program prog, int B, int E, const int* __restrict__ winlen0,
                 const int* __restrict__ n_valid, int* __restrict__ s_vec,
                 int* __restrict__ s_out) {
  __shared__ Program p;
  __shared__ Tiles T;
  __shared__ WalkState st[2];
  __shared__ short path[TILE];  // the entry each arrival starts at
  __shared__ int cum_k[TILE];
  __shared__ int uses_cur_s;
  const int w0 = *winlen0;
  const int nv = *n_valid;
  const int max_iter = 2 * B + E + 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    p = prog;
    st[0] = WalkState{0, 0, 0, 0, nv <= 0 || max_iter <= 0, 0, 0, 0, 0.0f};
    // does the condition read the current event? If not, an add-check and
    // a pop-check over the same window agree
    uses_cur_s = 0;
    for (int i = 0; i < prog.n; ++i)
      uses_cur_s |= prog.op[i] == OP_SEQ && prog.b[i] != 1 && prog.b[i] != 2;
    for (int c = 0; c < 2; ++c) {
      T.x[c][SINK] = -1;
      T.k[c][SINK] = 0;
      T.next[c][SINK] = SINK;
    }
  }
  __syncthreads();
  const bool uses_cur = uses_cur_s;
  int c = 0;  // this tile's buffer and state, the same in every thread
  while (!st[c].fin) {
    const WalkState now = st[c];
    const bool chain = now.pop;
    if (!now.have) {  // evaluate this tile now, every warp
      eval_segments<ARR>(p, T, c, chain, now.j, now.s, now.s, now.s,
                         now.drift, w0, nv, E, uses_cur, 0, NWARP);
      __syncthreads();
    }
    // warp 0 follows this tile while the other warps evaluate the next
    // arrival tile ahead, from the frontier the drift predicts
    const int jn = now.j + TILE;
    const int base_n =
        now.s + __float2int_rd(fminf(TILE * now.drift, 16777216.0f));
    if (warp != 0 && !chain)
      eval_segments<AHEAD>(p, T, c ^ 1, false, jn, now.s, base_n, now.s,
                           now.drift, w0, nv, E, uses_cur, 1, NWARP - 1);
    if (warp == 0) {
      int n_ok = 0;
      if (!chain) {
        // the entry every arrival starts at, from the tile's start: one
        // dependent load an arrival, no branch
        if (lane == 0) {
          int e = now.have ? now.e0 : 0;
#pragma unroll 15
          for (int r = 0; r < TILE; ++r) {
            path[r] = static_cast<short>(e);
            e = T.next[c][e];
          }
        }
        __syncwarp();
        // the arrivals that settle by their responses: a prefix, ended by
        // the first whose start left its band, whose chain left it, or that
        // would pass the cap
        int x[2], k[2];
        int incl = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * lane + h;
          x[h] = -1;
          k[h] = 0;
          if (r < TILE && now.j + r < nv) {
            const int e = path[r];
            const int off = T.x[c][e];
            x[h] = off >= 0 ? T.seg_b[c][r] + off : -1;
            k[h] = x[h] >= 0 ? T.k[c][e] : 0;
          }
          incl += k[h];
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int cum = incl;
#pragma unroll
        for (int h = 1; h >= 0; --h) {
          const int r = 2 * lane + h;
          const bool ok = x[h] >= 0 && cum <= max_iter - now.it;
          n_ok += __popc(__ballot_sync(FULL, ok));
          if (r < TILE) {
            T.settled[c][r] = x[h];
            cum_k[r] = cum;
          }
          cum -= k[h];
        }
        __syncwarp();
      }
      if (lane == 0) {
        int jj = now.j + n_ok, ss = now.s, it = now.it;
        bool pop = chain;
        if (n_ok > 0) {
          ss = T.settled[c][n_ok - 1];
          it += cum_k[n_ok - 1];
        }
        // the rest of the tile, check for check from the bands' masks: an
        // arrival whose chain left its band or met the cap, a chain tile
        for (int r = jj - now.j; r < TILE; ++r) {
          if (jj >= nv || it >= max_iter || (chain ? now.j : now.j + r) != jj)
            break;
          const int b = T.seg_b[c][r];
          const int qj = w0 + jj;
          if (!pop) {  // the add-check at ss
            const int off = ss - b;
            if (off < 0 || off >= BAND) break;
            ++it;
            if ((T.a_bits[c][r] >> off) & 1u) {
              T.settled[c][jj++ - now.j] = ss;
              continue;
            }
            pop = true;
            if (it >= max_iter) break;
          }
          // pop-checks at ss + 1, ss + 2, ...: the first that holds, or
          // the first forced stop
          const int c0 = ss + 1 - b;
          if (c0 < 0 || c0 >= BAND) break;
          const int forced = max(ss + 1, min(qj + 1, E));
          const unsigned m = T.p_bits[c][r] & (~0u << c0);
          const int stop = min(m ? b + __ffs(m) - 1 : INT_MAX, forced);
          const int avail = max_iter - it;
          const int last = stop < b + BAND ? stop : b + BAND - 1;
          const int k = last - ss;
          if (k > avail) {  // the cap bites inside the chain
            ss += avail;
            it = max_iter;
            break;
          }
          it += k;
          ss = last;
          if (stop < b + BAND) {
            T.settled[c][jj++ - now.j] = ss;
            pop = false;
          }
        }
        WalkState nx;
        nx.j = jj;
        nx.s = ss;
        nx.it = it;
        nx.pop = pop;
        nx.fin = jj >= nv || it >= max_iter;
        nx.n = jj - now.j;
        // frontier moved an arrival, smoothed over tiles (1/8 of the new)
        nx.drift = now.drift;
        if (!chain && jj > now.j) {
          const float d = static_cast<float>(ss - now.s) /
                          static_cast<float>(jj - now.j);
          nx.drift =
              now.drift == 0.0f ? d : now.drift + 0.125f * (d - now.drift);
        }
        // the next tile was evaluated ahead for arrival jn from base_n:
        // usable if it starts there, in its first band
        const int b0 = band_start(base_n, now.s, 0, now.drift);
        nx.have = !chain && !pop && jj == jn && ss >= b0 && ss - b0 < BAND;
        nx.e0 = nx.have ? ss - b0 : 0;
        st[c ^ 1] = nx;
      }
    }
    __syncthreads();
    const int n = st[c ^ 1].n;
    if (static_cast<int>(threadIdx.x) < n)
      s_vec[now.j + threadIdx.x] = T.settled[c][threadIdx.x];
    c ^= 1;
  }
  // lanes past the walk (or past an iteration-cap bailout) take the final
  // frontier
  const int s = st[c].s;
  for (int i = min(st[c].j, nv) + threadIdx.x; i < B; i += WALK)
    s_vec[i] = s;
  if (threadIdx.x == 0) *s_out = s;
}

// mode 1: greedy prefix segmentation (expression_general.py:386-401)
__global__ void __launch_bounds__(WALK)
    k13a_batch(Program prog, int B, int include_trigger,
               const int* __restrict__ winlen0,
               const int* __restrict__ n_valid, uint8_t* __restrict__ flush,
               int* __restrict__ end_j, uint8_t* __restrict__ empty,
               int* __restrict__ s_out) {
  __shared__ Program p;
  // [tile parity][kind][warp]: flush ballots of the tile's checks from its
  // start s, from s = q and from s = q - 1
  __shared__ unsigned flags[2][3][NWARP];
  if (threadIdx.x == 0) p = prog;
  __syncthreads();
  const int w0 = *winlen0;
  const int nv = *n_valid;
  const int inc = include_trigger;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x;
  // the same in every thread; `dense`: the last tile flushed early, so
  // this one also checks each arrival as if the one before it flushed
  int s = 0, j0 = 0, round = 0;
  bool dense = false;
  while (j0 < B) {
    const int j = j0 + t;
    const int q = w0 + j;
    const bool live = j < nv && j < B;  // invalid lanes never flush
    bool f[3] = {false, false, false};
    if (live && dense) {
      // after a flush the next start is q (inc, or an empty window) or
      // q - 1
      bool ok[3];
      eval_n<3>(p, {s, q, q - 1}, {q, q, q}, {q, q, q},
                {min(s, q), q, q - 1}, ok);
      f[0] = !ok[0];
      f[1] = !ok[1];
      f[2] = !ok[2];
    } else if (live) {
      f[0] = !eval(p, s, q, q, min(s, q));
    }
    // the next tile's [q + 1], 16 float64 a line
    if ((t >> 6) < p.n_arrays && j0 + WALK < nv)
      prefetch(p, t >> 6, static_cast<long long>(w0) + j0 + WALK + 1 +
                              16 * (t & 63));
    unsigned(*fl)[NWARP] = flags[round & 1];  // two: one barrier a tile
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned bits = __ballot_sync(FULL, f[k]);
      if ((t & 31) == 0) fl[k][warp] = bits;
    }
    __syncthreads();
    int first = WALK;
    for (int w = 0; w < NWARP; ++w) {
      const unsigned x = fl[0][w];
      if (x) {
        first = 32 * w + __ffs(x) - 1;
        break;
      }
    }
    // a run of flushes after the first: lanes first + 1 .. g - 1 each
    // flush from the start the one before left (q, or q - 1 when the
    // trigger is out and the first flush's window was not empty)
    const int qf = w0 + j0 + first;
    const bool e_first = s == qf;
    const bool at_q = inc || e_first;
    int g = first + 1;
    if (dense && first < WALK) {
      g = WALK;
      for (int w = (first + 1) >> 5; w < NWARP; ++w) {
        unsigned stop = ~fl[at_q ? 1 : 2][w];
        if (w == (first + 1) >> 5) stop &= ~0u << ((first + 1) & 31);
        if (stop) {
          g = 32 * w + __ffs(stop) - 1;
          break;
        }
      }
    }
    if (j < B && t <= first) {  // from the tile's start
      const bool e = t == first && e_first;
      flush[j] = t == first;
      end_j[j] = e ? q + 1 : q + inc;
      empty[j] = e;
    } else if (j < B && t < g) {  // the run
      flush[j] = 1;
      end_j[j] = at_q ? q + 1 : q + inc;
      empty[j] = at_q;
    } else if (j < B && t == g && dense) {  // the run's end: no flush
      flush[j] = 0;
      end_j[j] = q + inc;
      empty[j] = 0;
    }
    if (first == WALK) {
      j0 += WALK;
    } else if (!dense) {
      s = e_first ? qf + 1 : qf + inc;
      j0 += first + 1;
    } else if (g == WALK) {  // the run reaches the tile's end
      const int ql = w0 + j0 + WALK - 1;
      s = (WALK - 1 == first ? e_first : at_q) ? ql + 1 : ql + inc;
      j0 += WALK;
    } else {  // lane g keeps the start the run left it
      s = w0 + j0 + g - (at_q ? 0 : 1);
      j0 += g + 1;
    }
    dense = first < 32;
    ++round;
  }
  if (t == 0) *s_out = s;
}

}  // namespace

SIDDHI_ERROR_STRING_EXPORT

SIDDHI_API int k13a_max_instr() { return MAX_INSTR; }
SIDDHI_API int k13a_max_consts() { return MAX_CONSTS; }
SIDDHI_API int k13a_max_arrays() { return MAX_ARRAYS; }
SIDDHI_API int k13a_max_stack() { return MAX_STACK; }

// ops/a/b: int32[n_instr] (host); consts: float64[n_consts] (host);
// arrays/lens: n_arrays device pointers to float64 arrays and their
// lengths (host). winlen0, n_valid: int32 device scalars. Mode 0 writes
// s_vec[B] and s_out[1]; mode 1 writes flush/empty (uint8[B]), end_j
// (int32[B]) and s_out[1]. One launch either way.
SIDDHI_API int k13a_expression_walk(
    const int* ops, const int* as, const int* bs, int n_instr,
    const double* consts, int n_consts, const void* const* arrays,
    const int* lens, int n_arrays, int mode, int B, int E,
    int include_trigger, const int* winlen0, const int* n_valid, int* s_vec,
    int* s_out, uint8_t* flush, int* end_j, uint8_t* empty,
    cudaStream_t stream) {
  if (n_instr < 1 || n_instr > MAX_INSTR || n_consts > MAX_CONSTS ||
      n_arrays > MAX_ARRAYS || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Program prog;
  prog.n = n_instr;
  for (int i = 0; i < n_instr; ++i) {
    prog.op[i] = ops[i];
    prog.a[i] = as[i];
    prog.b[i] = bs[i];
  }
  for (int i = 0; i < n_consts; ++i) prog.consts[i] = consts[i];
  for (int i = 0; i < n_arrays; ++i) {
    prog.arrays[i] = static_cast<const double*>(arrays[i]);
    prog.len[i] = lens[i];
  }
  prog.n_arrays = n_arrays;
  if (mode == 0)
    k13a_sliding<<<1, WALK, 0, stream>>>(prog, B, E, winlen0, n_valid, s_vec,
                                         s_out);
  else
    k13a_batch<<<1, WALK, 0, stream>>>(prog, B, include_trigger, winlen0,
                                       n_valid, flush, end_j, empty, s_out);
  return siddhi_launch_status();
}
