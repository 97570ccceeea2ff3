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
// Bound on the H100: the walk is sequential by nature (each check depends
// on the frontier the previous one left), so one thread walks. The bytes
// are the reads of the arrays the program indexes, at the positions the
// walk visits, and the outputs' writes — about 2 MB for app X's condition,
// under a microsecond at 3.35 TB/s — but the time is the chain of dependent checks
// (up to 2B + E + 8 a step in mode 0, B in mode 1), each a few dozen
// instructions and L1/L2 loads. A later change can test 32 candidate pops
// at once with a warp ballot.

#include "common.cuh"

namespace {

constexpr int MAX_INSTR = 64;
constexpr int MAX_CONSTS = 32;
constexpr int MAX_ARRAYS = 24;
constexpr int MAX_STACK = 16;
constexpr int FILL_BLOCK = 256;

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
};

__device__ __forceinline__ double load(const Program& p, int k,
                                       long long i) {
  const int n = p.len[k];
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return p.arrays[k][i];
}

__device__ __forceinline__ double truth(bool v) { return v ? 1.0 : 0.0; }

// The condition over window [s, q]; `cur` is the current event's position
// and `fi` the first one's (min(s, q)).
__device__ bool eval(const Program& p, int s, int q, int cur, int fi) {
  double st[MAX_STACK];
  int sp = 0;
  for (int i = 0; i < p.n; ++i) {
    const int a = p.a[i];
    const int b = p.b[i];
    switch (p.op[i]) {
      case OP_CONST:
        st[sp++] = p.consts[a];
        break;
      case OP_COUNT:
        st[sp++] = static_cast<double>(q + 1 - s);
        break;
      case OP_SEQ:
        st[sp++] = load(p, a, b == 1 ? fi : (b == 2 ? q : cur));
        break;
      case OP_SUM:
      case OP_AVG:
      case OP_STD: {
        const double total = __dsub_rn(load(p, a, q + 1), load(p, a, s));
        if (p.op[i] == OP_SUM) {
          st[sp++] = total;
          break;
        }
        const double cnt = static_cast<double>(q + 1 - s);
        const double mean = __ddiv_rn(total, cnt);
        if (p.op[i] == OP_AVG) {
          st[sp++] = mean;
          break;
        }
        const double ex2 =
            __ddiv_rn(__dsub_rn(load(p, b, q + 1), load(p, b, s)), cnt);
        double v = __dsub_rn(ex2, __dmul_rn(mean, mean));
        v = (v > 0.0 || v != v) ? v : 0.0;  // jnp.maximum keeps NaN
        st[sp++] = __dsqrt_rn(v);
        break;
      }
      case OP_NOT:
        st[sp - 1] = truth(st[sp - 1] == 0.0);
        break;
      default: {
        const double y = st[--sp];
        const double x = st[sp - 1];
        double r;
        switch (p.op[i]) {
          case OP_ADD: r = __dadd_rn(x, y); break;
          case OP_SUB: r = __dsub_rn(x, y); break;
          case OP_MUL: r = __dmul_rn(x, y); break;
          case OP_DIV: r = __ddiv_rn(x, y); break;
          case OP_MOD:
            r = fmod(x, y);
            if (r != 0.0 && ((r < 0.0) != (y < 0.0))) r = __dadd_rn(r, y);
            break;
          case OP_LT: r = truth(x < y); break;
          case OP_LE: r = truth(x <= y); break;
          case OP_GT: r = truth(x > y); break;
          case OP_GE: r = truth(x >= y); break;
          case OP_EQ: r = truth(x == y); break;
          case OP_NE: r = truth(x != y); break;
          case OP_AND: r = truth((x != 0.0) & (y != 0.0)); break;
          default: r = truth((x != 0.0) | (y != 0.0)); break;  // OP_OR
        }
        st[sp - 1] = r;
      }
    }
  }
  return st[0] != 0.0;
}

// mode 0: the add-then-pop-while-false loop (expression_general.py:295-332)
__global__ void k13a_sliding(Program prog, int B, int E,
                             const int* __restrict__ winlen0,
                             const int* __restrict__ n_valid,
                             int* __restrict__ s_vec, int* __restrict__ s_out,
                             int* __restrict__ tail) {
  __shared__ Program p;
  p = prog;
  const int w0 = *winlen0;
  const int nv = *n_valid;
  const int max_iter = 2 * B + E + 8;
  int j = 0, s = 0, it = 0;
  bool pop = false;
  while (j < nv && it < max_iter) {
    const int qj = w0 + j;
    // add-check: window [s, qj], current = arrival qj; pop-check: pop
    // event s (window [s + 1, qj]), current = s
    const int se = pop ? s + 1 : s;
    const int cur = pop ? s : qj;
    const bool ok = eval(p, se, qj, cur, min(se, qj));
    const bool stop = ok || (pop && (se > qj || se >= E));
    if (pop) s = se;
    if (stop) {
      s_vec[j] = s;
      ++j;
      pop = false;
    } else {
      pop = true;
    }
    ++it;
  }
  *s_out = s;
  tail[0] = min(j, nv);
  tail[1] = s;
}

// lanes past the walk (or past an iteration-cap bailout) take the final
// frontier
__global__ void k13a_fill_tail(int B, const int* __restrict__ tail,
                               int* __restrict__ s_vec) {
  const int i = blockIdx.x * FILL_BLOCK + threadIdx.x;
  if (i < B && i >= tail[0]) s_vec[i] = tail[1];
}

// mode 1: greedy prefix segmentation (expression_general.py:386-401)
__global__ void k13a_batch(Program prog, int B, int include_trigger,
                           const int* __restrict__ winlen0,
                           const int* __restrict__ n_valid,
                           uint8_t* __restrict__ flush,
                           int* __restrict__ end_j,
                           uint8_t* __restrict__ empty,
                           int* __restrict__ s_out) {
  __shared__ Program p;
  p = prog;
  const int w0 = *winlen0;
  const int nv = *n_valid;
  int s = 0;
  for (int j = 0; j < B; ++j) {
    const int qj = w0 + j;
    // invalid lanes never flush, so their check is not needed
    const bool f = j < nv && !eval(p, s, qj, qj, min(s, qj));
    const bool e = f && s == qj;
    const int end = e ? qj + 1 : qj + include_trigger;
    if (f) s = end;
    flush[j] = f;
    end_j[j] = end;
    empty[j] = e;
  }
  *s_out = s;
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
// s_vec[B], s_out[1] and uses tail (int32[2] device scratch); mode 1 writes
// flush/empty (uint8[B]), end_j (int32[B]) and s_out[1].
SIDDHI_API int k13a_expression_walk(
    const int* ops, const int* as, const int* bs, int n_instr,
    const double* consts, int n_consts, const void* const* arrays,
    const int* lens, int n_arrays, int mode, int B, int E,
    int include_trigger, const int* winlen0, const int* n_valid, int* s_vec,
    int* s_out, int* tail, uint8_t* flush, int* end_j, uint8_t* empty,
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
  if (mode == 0) {
    k13a_sliding<<<1, 1, 0, stream>>>(prog, B, E, winlen0, n_valid, s_vec,
                                       s_out, tail);
    int rc = siddhi_launch_status();
    if (rc) return rc;
    k13a_fill_tail<<<siddhi_blocks(B, FILL_BLOCK), FILL_BLOCK, 0, stream>>>(
        B, tail, s_vec);
    return siddhi_launch_status();
  }
  k13a_batch<<<1, 1, 0, stream>>>(prog, B, include_trigger, winlen0,
                                   n_valid, flush, end_j, empty, s_out);
  return siddhi_launch_status();
}
