"""The general expression and expressionBatch windows: exact reference
semantics for ARBITRARY retain conditions (counterpart of
siddhi_tpu/ops/expression_general.py).

Reference: ExpressionWindowProcessor.java:204-234 — each arrival is
appended, the condition is evaluated over (current, first, last) with
running window aggregates, and while it is false the window pops from the
front (`current` rebinding to the just-popped event) until it turns true or
the window empties. ExpressionBatchWindowProcessor.java:288-347 — events
accumulate while the condition holds (evaluated INCLUDING the arrival);
when it breaks the accumulated window flushes as a batch (expired copies of
the previous flush first), and the triggering event joins the flush
(`includeTriggeringEvent=true`) or starts the next window.

Conditions reference only prefix-computable metrics — count(),
sum/avg/stdDev(attr), first.attr / last.attr / bare attr (current),
eventTimestamp(first|last) — so a check is a few reads of arrival-order
metric arrays (`_metric_env`, float64). The checks are sequential: the
sliding window walks its add-then-pop loop (at most 2B + E + 8 checks a
step), expressionBatch checks each arrival once. On the card both walks are
kernel K13a (csrc/k13a_expression_walk.cu), which interprets the condition
as a postfix program built once per query (`PostfixProgram`) in one block:
expressionBatch checks a tile of arrivals at once and takes the first that
flushes; the sliding walk evaluates bands of candidate frontiers for
several arrivals at once and replays the loop over them exactly. On the CPU
the plain walk runs the reference loop in Python over the same metric
arrays, evaluating the condition as a tree of closures over float64 values
(`_compile_condition`), the JAX module's own form.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import kernels
from ..core import dtypes
from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from ..query_api.expression import (And, AttributeFunction, Compare,
                                    CompareOp, Constant, Expression,
                                    MathExpression, MathOp, Not, Or,
                                    Variable)
from .expression_window import ExpressionWindow, arrival_sequence
from .search import searchsorted32
from .windows import (KIND_CURRENT, KIND_EXPIRED, KIND_RESET, WindowOp,
                      _append_packed, _fetch_rel_packed, _layout_words,
                      _ring_live_mask, _sort_chunk_packed, _unpack_rows,
                      compact_packed)

#: sentinel attr name for the timestamp payload
TS_ATTR = "\x00ts"


class _Terms(NamedTuple):
    attrs: frozenset  # attrs needing value sequences (incl. TS_ATTR)
    prefix_attrs: frozenset  # attrs needing prefix sums (sum/avg/stdDev)
    sq_attrs: frozenset  # attrs needing squared prefix sums (stdDev)


def _collect_terms(expr: Expression, layout: dict) -> _Terms:
    attrs, prefix, sq = set(), set(), set()

    def walk(e: Expression):
        if isinstance(e, (And, Or)):
            walk(e.left), walk(e.right)
        elif isinstance(e, Not):
            walk(e.expression)
        elif isinstance(e, Compare):
            walk(e.left), walk(e.right)
        elif isinstance(e, MathExpression):
            walk(e.left), walk(e.right)
        elif isinstance(e, Constant):
            if e.type_name == "string":
                raise SiddhiAppCreationError(
                    "expression window conditions cannot compare string "
                    "constants (dictionary codes are not orderable); filter "
                    "strings in the query instead")
        elif isinstance(e, Variable):
            if e.stream_id not in (None, "first", "last", "current"):
                raise SiddhiAppCreationError(
                    f"expression window variable {e.stream_id}.{e.attribute}"
                    " — only bare (current), first.* and last.* references "
                    "are available inside a window condition")
            if e.attribute not in layout:
                raise SiddhiAppCreationError(
                    f"expression window references unknown attribute "
                    f"{e.attribute!r}")
            attrs.add(e.attribute)
        elif isinstance(e, AttributeFunction):
            name = e.name
            if name == "count" and not e.parameters:
                return
            if name == "eventTimestamp":
                if e.parameters:
                    p = e.parameters[0]
                    if not (isinstance(p, Variable)
                            and p.attribute in ("first", "last")):
                        raise SiddhiAppCreationError(
                            "eventTimestamp() takes first or last")
                attrs.add(TS_ATTR)
                return
            if name in ("sum", "avg", "stdDev", "stddev"):
                p = e.parameters[0] if e.parameters else None
                if not isinstance(p, Variable) or p.attribute not in layout:
                    raise SiddhiAppCreationError(
                        f"{name}() needs a stream attribute argument")
                attrs.add(p.attribute)
                prefix.add(p.attribute)
                if name in ("stdDev", "stddev"):
                    sq.add(p.attribute)
                return
            raise SiddhiAppCreationError(
                f"unsupported window-condition function {name!r}; supported: "
                "count(), sum(x), avg(x), stdDev(x), eventTimestamp(first|"
                "last), first.x/last.x/bare attributes (min/max need full "
                "window scans and are not prefix-computable)")
        else:
            raise SiddhiAppCreationError(
                f"unsupported expression window term {type(e).__name__}")

    walk(expr)
    return _Terms(frozenset(attrs), frozenset(prefix), frozenset(sq))


def _check_boolean(expr: Expression) -> None:
    """The root and the operands of &, | and not are boolean: comparisons,
    their combinations or bool constants (jnp refuses & on floats)."""
    def is_bool(e):
        return (isinstance(e, (Compare, And, Or, Not))
                or (isinstance(e, Constant) and e.type_name == "bool"))

    def walk(e):
        if isinstance(e, (And, Or)):
            operands = (e.left, e.right)
        elif isinstance(e, Not):
            operands = (e.expression,)
        else:
            operands = ()
        for o in operands:
            if not is_bool(o):
                raise SiddhiAppCreationError(
                    "expression window conditions combine comparisons with "
                    f"and / or / not; got {type(o).__name__}")
        for o in (getattr(e, "left", None), getattr(e, "right", None),
                  getattr(e, "expression", None)):
            if isinstance(o, Expression):
                walk(o)

    if isinstance(expr, (Constant, Variable, MathExpression,
                         AttributeFunction)):
        raise SiddhiAppCreationError(
            "expression window condition must be boolean")
    walk(expr)


# --------------------------------------------------------------------------- #
# the plain condition: closures over float64 values, as the JAX module
# builds them; (env, s, q, cur, first_idx) -> bool
# --------------------------------------------------------------------------- #


def _at(arr: list, i: int) -> float:
    """arr[i], clamped to the last element as a JAX gather clamps."""
    n = len(arr)
    return arr[i if i < n else n - 1]


def _div(a, b) -> float:
    try:
        return a / b
    except ZeroDivisionError:  # IEEE: x/0 is +-inf, 0/0 and nan/0 NaN
        if a != a or a == 0:
            return math.nan
        return math.copysign(math.inf, a) * math.copysign(1.0, b)


def _mod(a, b) -> float:
    """jnp.remainder on float64: the truncated fmod, plus the divisor when
    the signs differ and the remainder is not 0."""
    try:
        r = math.fmod(a, b)
    except ValueError:  # fmod(inf, y) and fmod(x, 0) are NaN in C
        return math.nan
    if r != 0 and ((r < 0) != (b < 0)):
        r += b
    return r


_CMP = {
    CompareOp.LESS_THAN: lambda a, b: a < b,
    CompareOp.LESS_THAN_EQUAL: lambda a, b: a <= b,
    CompareOp.GREATER_THAN: lambda a, b: a > b,
    CompareOp.GREATER_THAN_EQUAL: lambda a, b: a >= b,
    CompareOp.EQUAL: lambda a, b: a == b,
    CompareOp.NOT_EQUAL: lambda a, b: a != b,
}
_MATH = {
    MathOp.ADD: lambda a, b: a + b,
    MathOp.SUBTRACT: lambda a, b: a - b,
    MathOp.MULTIPLY: lambda a, b: a * b,
    MathOp.DIVIDE: _div,
    MathOp.MOD: _mod,
}


def _frame_index(frame, s, q, cur, first_idx):
    return first_idx if frame == "first" else (q if frame == "last" else cur)


def _compile_condition(expr: Expression):
    """The AST as fn(env, s, q, cur, first_idx) -> bool over host lists:
    env[('seq', attr)] (length C + B), env[('prefix', attr)] and
    env[('prefix_sq', attr)] (C + B + 1). Window = [s, q]; `cur` indexes
    the current event (arrival q at the add-check, the just-popped event
    at pop-checks); first_idx = min(s, q)."""
    _check_boolean(expr)

    def build(e: Expression):
        if isinstance(e, And):
            l, r = build(e.left), build(e.right)
            return lambda *a: bool(l(*a)) & bool(r(*a))
        if isinstance(e, Or):
            l, r = build(e.left), build(e.right)
            return lambda *a: bool(l(*a)) | bool(r(*a))
        if isinstance(e, Not):
            f = build(e.expression)
            return lambda *a: not f(*a)
        if isinstance(e, Compare):
            l, r, op = build(e.left), build(e.right), _CMP[e.op]
            return lambda *a: op(l(*a), r(*a))
        if isinstance(e, MathExpression):
            l, r, op = build(e.left), build(e.right), _MATH[e.op]
            return lambda *a: op(l(*a), r(*a))
        if isinstance(e, Constant):
            v = bool(e.value) if e.type_name == "bool" else float(e.value)
            return lambda *a: v
        if isinstance(e, Variable):
            key, frame = ("seq", e.attribute), e.stream_id

            def var(env, s, q, cur, fi):
                return _at(env[key], _frame_index(frame, s, q, cur, fi))
            return var
        if isinstance(e, AttributeFunction):
            name = e.name
            if name == "count":
                return lambda env, s, q, cur, fi: float(q + 1 - s)
            if name == "eventTimestamp":
                frame = (e.parameters[0].attribute if e.parameters
                         else "current")
                key = ("seq", TS_ATTR)

                def ets(env, s, q, cur, fi):
                    return _at(env[key], _frame_index(frame, s, q, cur, fi))
                return ets
            attr = e.parameters[0].attribute
            pkey, skey = ("prefix", attr), ("prefix_sq", attr)

            def agg(env, s, q, cur, fi):
                pre = env[pkey]
                total = _at(pre, q + 1) - _at(pre, s)
                if name == "sum":
                    return total
                cnt = float(q + 1 - s)
                mean = _div(total, cnt)
                if name == "avg":
                    return mean
                sq = env[skey]
                ex2 = _div(_at(sq, q + 1) - _at(sq, s), cnt)
                v = ex2 - mean * mean
                return math.sqrt(v if (v > 0.0 or v != v) else 0.0)
            return agg
        raise SiddhiAppCreationError(  # pragma: no cover — _collect guards
            f"unsupported expression term {type(e).__name__}")

    return build(expr)


# --------------------------------------------------------------------------- #
# the K13a condition: a postfix program over the metric arrays
# --------------------------------------------------------------------------- #

#: opcodes of csrc/k13a_expression_walk.cu (enum Op)
_OPS = {"const": 0, "count": 1, "seq": 2, "sum": 3, "avg": 4, "std": 5,
        MathOp.ADD: 6, MathOp.SUBTRACT: 7, MathOp.MULTIPLY: 8,
        MathOp.DIVIDE: 9, MathOp.MOD: 10,
        CompareOp.LESS_THAN: 11, CompareOp.LESS_THAN_EQUAL: 12,
        CompareOp.GREATER_THAN: 13, CompareOp.GREATER_THAN_EQUAL: 14,
        CompareOp.EQUAL: 15, CompareOp.NOT_EQUAL: 16,
        "and": 17, "or": 18, "not": 19}
_FRAMES = {None: 0, "current": 0, "first": 1, "last": 2}
#: the kernel's static limits (MAX_INSTR, MAX_CONSTS, MAX_ARRAYS, MAX_STACK)
K13A_LIMITS = {"instr": 64, "consts": 32, "arrays": 24, "stack": 16}


class PostfixProgram(NamedTuple):
    """The condition as K13a runs it: (op, a, b) int32 triples, float64
    constants, and the env keys of the arrays the program indexes."""

    ops: tuple
    a: tuple
    b: tuple
    consts: tuple
    arrays: tuple  # env keys, program array index order
    depth: int


def compile_postfix(expr: Expression) -> PostfixProgram:
    """Lower the condition to K13a's postfix program (once per query)."""
    _check_boolean(expr)
    arrays: list = []  # only the env arrays an opcode indexes, first use first
    ops, av, bv, consts = [], [], [], []
    depth = [0, 0]  # current, max

    def array(kind: str, attr: str) -> int:
        if (kind, attr) not in arrays:
            arrays.append((kind, attr))
        return arrays.index((kind, attr))

    def emit(op, a=0, b=0, pops=0, pushes=1):
        ops.append(_OPS[op])
        av.append(a)
        bv.append(b)
        depth[0] += pushes - pops
        depth[1] = max(depth[1], depth[0])

    def const(v: float) -> int:
        consts.append(v)
        return len(consts) - 1

    def build(e: Expression):
        if isinstance(e, (And, Or)):
            build(e.left), build(e.right)
            emit("and" if isinstance(e, And) else "or", pops=2)
        elif isinstance(e, Not):
            build(e.expression)
            emit("not", pops=1)
        elif isinstance(e, (Compare, MathExpression)):
            build(e.left), build(e.right)
            emit(e.op, pops=2)
        elif isinstance(e, Constant):
            v = (float(bool(e.value)) if e.type_name == "bool"
                 else float(e.value))
            emit("const", const(v))
        elif isinstance(e, Variable):
            emit("seq", array("seq", e.attribute), _FRAMES[e.stream_id])
        elif e.name == "count":
            emit("count")
        elif e.name == "eventTimestamp":
            frame = e.parameters[0].attribute if e.parameters else None
            emit("seq", array("seq", TS_ATTR), _FRAMES[frame])
        else:
            attr = e.parameters[0].attribute
            pre = array("prefix", attr)
            if e.name == "sum":
                emit("sum", pre)
            elif e.name == "avg":
                emit("avg", pre)
            else:
                emit("std", pre, array("prefix_sq", attr))

    build(expr)
    prog = PostfixProgram(tuple(ops), tuple(av), tuple(bv), tuple(consts),
                          tuple(arrays), depth[1])
    for what, n in (("instr", len(ops)), ("consts", len(consts)),
                    ("arrays", len(arrays)), ("stack", prog.depth)):
        if n > K13A_LIMITS[what]:
            raise SiddhiAppCreationError(
                f"expression window condition too large for the walk "
                f"kernel: {n} {what} (at most {K13A_LIMITS[what]})")
    return prog


class Condition:
    """One compiled window condition in both forms."""

    def __init__(self, expr: Expression):
        self.plain = _compile_condition(expr)
        self.program = compile_postfix(expr)


def _metric_env(terms: _Terms, ring_cols, ring_ts, comp_cols, comp_ts,
                base, winlen0, n_valid32, C: int, B: int) -> dict:
    """Arrival-order metric arrays, float64: position r holds the event at
    overall index base + r (window rows [0, winlen0), this batch's arrivals
    at [winlen0, winlen0 + n_valid)); dead positions are 0."""
    env: dict = {}
    for attr in sorted(terms.attrs):
        ring_vals = ring_ts if attr == TS_ATTR else ring_cols[attr]
        comp_vals = comp_ts if attr == TS_ATTR else comp_cols[attr]
        env[("seq", attr)] = arrival_sequence(
            ring_vals, comp_vals, base, winlen0, n_valid32, C, B,
            0).to(torch.float64)
    for attr in sorted(terms.prefix_attrs):
        seq = env[("seq", attr)]
        env[("prefix", attr)] = torch.cat([seq.new_zeros(1),
                                           torch.cumsum(seq, 0)])
    for attr in sorted(terms.sq_attrs):
        seq = env[("seq", attr)]
        env[("prefix_sq", attr)] = torch.cat([seq.new_zeros(1),
                                              torch.cumsum(seq * seq, 0)])
    return env


# --------------------------------------------------------------------------- #
# the walks: plain (host loop) and K13a
# --------------------------------------------------------------------------- #


def _host_env(env: dict) -> dict:
    return {k: v.tolist() for k, v in env.items()}


def sliding_walk_plain(cond: Condition, env: dict, winlen0, n_valid32,
                       B: int, E: int):
    """The JAX `_frontiers` while_loop, step by step in Python: returns
    (s_vec int32[B], final s int32 scalar) on env's device."""
    dev = winlen0.device
    fn, henv = cond.plain, _host_env(env)
    w0, nv = int(winlen0), int(n_valid32)
    max_iter = 2 * B + E + 8
    s_vec = [0] * B
    j = s = it = 0
    pop = False
    while j < nv and it < max_iter:
        qj = w0 + j
        se = s + 1 if pop else s
        cur = s if pop else qj
        ok = fn(henv, se, qj, cur, min(se, qj))
        stop = ok or (pop and (se > qj or se >= E))
        if pop:
            s = se
        if stop:
            s_vec[j] = s
            j += 1
            pop = False
        else:
            pop = True
        it += 1
    for i in range(min(j, nv), B):
        s_vec[i] = s
    return (torch.tensor(s_vec, dtype=torch.int32, device=dev),
            torch.tensor(s, dtype=torch.int32, device=dev))


def batch_walk_plain(cond: Condition, env: dict, winlen0, n_valid32, B: int,
                     include_trigger: bool):
    """The JAX expressionBatch lax.scan in Python: returns (flush bool[B],
    end_j int32[B], empty bool[B], final s int32 scalar)."""
    dev = winlen0.device
    fn, henv = cond.plain, _host_env(env)
    w0, nv, inc = int(winlen0), int(n_valid32), int(include_trigger)
    flush, end_j, empty = [False] * B, [0] * B, [False] * B
    s = 0
    for j in range(B):
        qj = w0 + j
        f = j < nv and not fn(henv, s, qj, qj, min(s, qj))
        e = f and s == qj
        end = qj + 1 if e else qj + inc
        if f:
            s = end
        flush[j], end_j[j], empty[j] = f, end, e
    return (torch.tensor(flush, dtype=torch.bool, device=dev),
            torch.tensor(end_j, dtype=torch.int32, device=dev),
            torch.tensor(empty, dtype=torch.bool, device=dev),
            torch.tensor(s, dtype=torch.int32, device=dev))


def _k13a_cuda(cond: Condition, env: dict, winlen0, n_valid32, B: int,
               E: int, mode: int, include_trigger: bool = False):
    prog = cond.program
    arrays = [env[k].contiguous() for k in prog.arrays]
    winlen0 = winlen0.to(torch.int32).reshape(())
    n_valid32 = n_valid32.to(torch.int32).reshape(())
    kernels.require_cuda("expression_walk", winlen0, n_valid32, *arrays)
    if any(a.dtype != torch.float64 or a.dim() != 1 for a in arrays):
        raise ValueError("expression_walk: float64 metric arrays")
    dev = winlen0.device
    s_vec = torch.empty(B, dtype=torch.int32, device=dev)
    s_out = torch.empty((), dtype=torch.int32, device=dev)
    flush = torch.empty(B, dtype=torch.bool, device=dev)
    end_j = torch.empty(B, dtype=torch.int32, device=dev)
    empty = torch.empty(B, dtype=torch.bool, device=dev)

    def ints(v):
        return (ctypes.c_int * max(len(v), 1))(*v)

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = kernels.bind("k13a_expression_walk", "k13a_expression_walk",
                      [P, P, P, I, P, I, P, P, I, I, I, I, I]
                      + [P] * 8)
    rc = fn(ints(prog.ops), ints(prog.a), ints(prog.b), len(prog.ops),
            (ctypes.c_double * max(len(prog.consts), 1))(*prog.consts),
            len(prog.consts),
            (ctypes.c_void_p * max(len(arrays), 1))(
                *[a.data_ptr() for a in arrays]),
            ints([a.shape[0] for a in arrays]), len(arrays), mode, B, E,
            int(include_trigger), winlen0.data_ptr(), n_valid32.data_ptr(),
            s_vec.data_ptr(), s_out.data_ptr(), flush.data_ptr(),
            end_j.data_ptr(), empty.data_ptr(), kernels.stream())
    kernels.check("k13a_expression_walk", "expression_walk", rc)
    kernels.LAUNCHES["K13a sliding" if mode == 0 else "K13a batch"] += 1
    if mode == 0:
        return s_vec, s_out
    return flush, end_j, empty, s_out


def sliding_walk(cond: Condition, env: dict, winlen0, n_valid32, B: int,
                 E: int):
    """The sliding window's frontiers (K13a mode 0): (s_vec[B], s)."""
    if winlen0.is_cuda:
        return _k13a_cuda(cond, env, winlen0, n_valid32, B, E, 0)
    return sliding_walk_plain(cond, env, winlen0, n_valid32, B, E)


def batch_walk(cond: Condition, env: dict, winlen0, n_valid32, B: int,
               include_trigger: bool):
    """expressionBatch's segmentation (K13a mode 1): (flush, end_j, empty,
    s)."""
    if winlen0.is_cuda:
        return _k13a_cuda(cond, env, winlen0, n_valid32, B, 0, 1,
                          include_trigger)
    return batch_walk_plain(cond, env, winlen0, n_valid32, B,
                            include_trigger)


# --------------------------------------------------------------------------- #
# the windows
# --------------------------------------------------------------------------- #


class GeneralExpressionWindow(ExpressionWindow):
    """Sliding expression window for ARBITRARY conditions: the reference's
    add-then-pop-while-false loop run exactly (K13a). Conditions the
    monotone path takes by construction never get here (the factory
    prefers ExpressionWindow)."""

    def __init__(self, layout: dict, batch_cap: int, condition: str):
        from ..compiler import parse_expression
        self.layout = layout
        self.B = batch_cap
        expr = parse_expression(condition)
        self.terms = _collect_terms(expr, layout)
        self.cond = Condition(expr)
        self.conjuncts = []  # no static count bound
        self.C = max(dtypes.config.default_window_capacity, batch_cap)
        self.E = max(batch_cap, 1024)
        self.C = max(self.C, self.E)
        self.chunk_width = self.B + self.E
        self.W = _layout_words(layout)

    def _frontiers(self, ring_cols, ring_ts, comp_cols, comp_ts, expired,
                   winlen0, n_valid32, q):
        env = _metric_env(self.terms, ring_cols, ring_ts, comp_cols,
                          comp_ts, expired, winlen0, n_valid32, self.C,
                          self.B)
        s_vec, _ = sliding_walk(self.cond, env, winlen0, n_valid32, self.B,
                                self.E)
        return s_vec


class GeneralBatchState(NamedTuple):
    ring: torch.Tensor  # int32[W, C] packed rows at overall index % C
    appended: torch.Tensor  # int64 total arrivals
    flushed: torch.Tensor  # int64 start of the accumulating window
    prev_start: torch.Tensor  # int64 start of the previous flushed batch
    overflow: torch.Tensor  # int64 rows lost to ring wrap / emission caps


class GeneralExpressionBatchWindow(WindowOp):
    """expressionBatch(condition[, includeTriggeringEvent]) for arbitrary
    conditions: greedy prefix segmentation (one check per arrival, K13a),
    flushing [expired(previous flush), RESET, currents] like the other
    batch windows. count()-form conditions never get here (the factory
    lowers them to LengthBatchWindow)."""

    def __init__(self, layout: dict, batch_cap: int, condition: str,
                 include_trigger: bool = False):
        from ..compiler import parse_expression
        self.layout = layout
        self.B = batch_cap
        self.include_trigger = include_trigger
        expr = parse_expression(condition)
        self.terms = _collect_terms(expr, layout)
        self.cond = Condition(expr)
        self.C = max(dtypes.config.default_window_capacity, 2 * batch_cap)
        self.E = max(batch_cap, 1024)
        self.P = self.E + self.B  # emission lanes per kind
        self.chunk_width = 2 * self.P + self.B
        self.W = _layout_words(layout)

    def init_state(self, device) -> GeneralBatchState:
        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        return GeneralBatchState(
            ring=torch.zeros((self.W, self.C), dtype=torch.int32,
                             device=device),
            appended=i64(0), flushed=i64(0), prev_start=i64(0),
            overflow=i64(0))

    def step(self, state: GeneralBatchState, batch: EventBatch, now):
        B, C, P = self.B, self.C, self.P
        dev = batch.ts.device
        comp_mat, n_valid32 = compact_packed(batch, self.layout)
        n_valid = n_valid32.to(torch.int64)
        winlen0 = (state.appended - state.flushed).to(torch.int32)
        ring_cols, ring_ts = _unpack_rows(state.ring, self.layout)
        comp_cols, comp_ts = _unpack_rows(comp_mat, self.layout)
        env = _metric_env(self.terms, ring_cols, ring_ts, comp_cols,
                          comp_ts, state.flushed, winlen0, n_valid32, C, B)
        flush, end_j, empty_j, s_final = batch_walk(
            self.cond, env, winlen0, n_valid32, B, self.include_trigger)

        n_flushes = flush.sum(dtype=torch.int32)
        k_j = torch.cumsum(flush.to(torch.int32), 0, dtype=torch.int32) - 1
        rj = torch.arange(B, dtype=torch.int32, device=dev)
        # flush k's end, trigger lane and emptiness at row k (flush lanes
        # are unique per k: plain scatters into a spare row B)
        scatter_to = torch.where(flush, k_j, B).long()
        ends = torch.full((B + 1,), 2**30, dtype=torch.int32, device=dev)
        ends.index_put_((scatter_to,), end_j)
        trig = torch.full((B + 1,), B, dtype=torch.int32, device=dev)
        trig.index_put_((scatter_to,), rj)
        empty_k = torch.zeros(B + 1, dtype=torch.bool, device=dev)
        empty_k.index_put_((scatter_to,), empty_j)
        ends, trig, empty_k = ends[:B], trig[:B], empty_k[:B]
        # flush k covers rel range [start_k, end_k); start_0 = 0 and
        # start_{k+1} = end_k
        # (one-lane indices: a 0-d index tensor would read back to the host)
        last_k = torch.clamp(n_flushes - 1, min=0).long().reshape(1)
        lim = torch.where(n_flushes > 0, ends[last_k][0], 0)
        start_last = torch.where(
            n_flushes >= 2,
            ends[torch.clamp(n_flushes - 2, min=0).long().reshape(1)][0], 0)

        # CURRENT lanes: rel positions [0, lim) from `flushed`
        pe = torch.arange(P, dtype=torch.int32, device=dev)
        cur_mat = _fetch_rel_packed(state.ring, comp_mat, state.flushed,
                                    state.appended, P)
        cur_k = searchsorted32(ends, pe, side="right")
        cur_valid = (pe < lim) & (cur_k < n_flushes)
        cur_trig = trig[torch.clamp(cur_k, 0, B - 1).long()]
        cur_hi = torch.clamp(cur_trig, 0, B) * 4 + KIND_CURRENT

        # EXPIRED lanes: the previous flush re-emitted at this step's flush
        # k + 1 (flush 0 expires the previous step's last flushed batch);
        # an empty-window flush expires its own event at flush k itself
        prev_len = (state.flushed - state.prev_start).to(torch.int32)
        exp_mat = _fetch_rel_packed(state.ring, comp_mat, state.prev_start,
                                    state.appended, P)
        r = pe - prev_len
        in_prev = pe < prev_len
        own_k = searchsorted32(ends, torch.clamp(r, min=0), side="right")
        own_empty = empty_k[torch.clamp(own_k, 0, B - 1).long()]
        exp_k = torch.where(in_prev, 0,
                            torch.where(own_empty, own_k, own_k + 1))
        exp_valid = (exp_k < n_flushes) & (in_prev | (r < lim))
        exp_trig = trig[torch.clamp(exp_k, 0, B - 1).long()]
        exp_hi = torch.clamp(exp_trig, 0, B) * 4 + KIND_EXPIRED

        # RESET lanes: one per flush
        rst_hi = rj * 4 + KIND_RESET
        rst_mat = torch.zeros((self.W, B), dtype=torch.int32, device=dev)

        L = 2 * P + B
        all_hi = torch.cat([exp_hi, rst_hi, cur_hi])
        all_mat = torch.cat([exp_mat, rst_mat, cur_mat], dim=1)
        all_emit = torch.full((L,), int(now), dtype=torch.int64, device=dev)
        all_valid = torch.cat([exp_valid, flush, cur_valid])
        all_types = torch.cat([
            torch.full((P,), int(EventType.EXPIRED), dtype=torch.int8,
                       device=dev),
            torch.full((B,), int(EventType.RESET), dtype=torch.int8,
                       device=dev),
            torch.full((P,), int(EventType.CURRENT), dtype=torch.int8,
                       device=dev)])
        chunk = _sort_chunk_packed(all_hi, all_mat, all_emit,
                                   all_valid, all_types, self.layout,
                                   self.chunk_width, 4 * B + 4)

        # the append comes after the reads of the ring (in place on the card)
        ring = _append_packed(state.ring, comp_mat, state.appended,
                              n_valid32)
        appended1 = state.appended + n_valid
        flushed1 = state.flushed + s_final.to(torch.int64)
        empty_last = empty_k[last_k][0]
        prev_start1 = torch.where(
            n_flushes > 0,
            state.flushed + torch.where(empty_last, lim,
                                        start_last).to(torch.int64),
            state.prev_start)
        # monitored losses: ring wrap past prev_start, and flushes wider
        # than the emission block
        span0 = torch.clamp(state.appended - state.prev_start - C, min=0)
        span1 = torch.clamp(appended1 - prev_start1 - C, min=0)
        dropped_emit = torch.clamp(lim - P, min=0).to(torch.int64)
        new_state = GeneralBatchState(
            ring=ring, appended=appended1, flushed=flushed1,
            prev_start=prev_start1,
            overflow=(state.overflow + torch.clamp(span1 - span0, min=0)
                      + dropped_emit))
        return new_state, chunk

    def contents(self, state: GeneralBatchState, now):
        """Joins see the accumulating (unflushed) window."""
        ring_cols, ring_ts = _unpack_rows(state.ring, self.layout)
        live = _ring_live_mask(self.C, state.flushed, state.appended)
        return ring_cols, ring_ts, live
