"""The expression and expressionBatch windows of siddhi_tpu_torch against
the JAX package on the CPU: `_sort_chunk_packed` (K7 on the `hi` key alone)
against `jax.lax.sort` on (hi, lo), K13a's postfix program against the
plain closures, the plain condition walks against the JAX `_frontiers`
while_loop and the expressionBatch scan (through the window steps, every
emitted lane and the whole state), the shapes of
tests/test_expression_window.py through both public APIs, and
chip_smoke.py's apps W and X at 4 rounds of 512 against the JAX package
and the script's numpy oracles.

Inputs are made with numpy from a seed and handed to both packages. The
metrics are float64 in both and the walks do the same IEEE operations in
the same order, so orders, frontiers, strings, longs, doubles, timestamps
and event types must be equal (tolerance 0); the data keeps sums exact
(integers and 1/64 steps) so no summation order can matter.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import dtypes as jdtypes
from siddhi_tpu.ops import expression_general as jeg
from siddhi_tpu.ops import expression_window as jew
from siddhi_tpu.ops import windows as jw
from siddhi_tpu_torch.core import dtypes as tdtypes
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.ops import expression_general as teg
from siddhi_tpu_torch.ops import expression_window as tew
from siddhi_tpu_torch.ops import search, windows as tw
from tests.test_torch_session_sort import _pair, _same_lanes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAYOUT_J = {"symbol": jnp.int32, "price": jnp.float64, "volume": jnp.int64}
LAYOUT_T = {"symbol": torch.int32, "price": torch.float64,
            "volume": torch.int64}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture
def small_capacity():
    """A 2048-row default window capacity in both packages (the JAX batch
    window fetches E + B = 1056 rows of it): the metric arrays stay short,
    so the plain walk and the JAX loop stay quick."""
    prev = (jdtypes.config.default_window_capacity,
            tdtypes.config.default_window_capacity)
    jdtypes.config.default_window_capacity = 2048
    tdtypes.config.default_window_capacity = 2048
    yield
    (jdtypes.config.default_window_capacity,
     tdtypes.config.default_window_capacity) = prev


# ------------------------------------------------ K7 on the packed chunk


def _caller_keys(rng, B, caller):
    """(hi, lo, valid) of a caller's chunk: each kind's lanes numbered by
    `lo` in concatenation order, the kind in hi % 4."""
    if caller == "expression":  # [pe, p]: expired (kind 3), current (2)
        E = max(B, 16)
        hi = np.r_[rng.integers(0, B + 1, E) * 4 + 3, np.arange(B) * 4 + 2]
        lo = np.r_[np.arange(E), np.arange(B)]
    else:  # [pe, rj, pe]: expired (0), reset (1), current (2)
        P = 2 * B
        hi = np.r_[rng.integers(0, B + 1, P) * 4, np.arange(B) * 4 + 1,
                   rng.integers(0, B + 1, P) * 4 + 2]
        lo = np.r_[np.arange(P), np.arange(B), np.arange(P)]
    valid = rng.random(hi.shape[0]) < 0.55
    return hi.astype(np.int32), lo.astype(np.int32), valid


@pytest.mark.parametrize("B", [64, 512])
@pytest.mark.parametrize("caller", ["expression", "batch"])
def test_k7_on_hi_alone_orders_valid_lanes_as_lax_sort(caller, B):
    """The (hi, lo) stable lax.sort with invalid hi at INT32_MAX against K7
    on hi alone with invalid lanes at the bound 4B + 4: the valid lanes
    come first in the same order (the invalid ones carry no event)."""
    rng = np.random.default_rng(B + len(caller))
    hi, lo, valid = _caller_keys(rng, B, caller)
    L = hi.shape[0]
    hj = jnp.where(jnp.asarray(valid), jnp.asarray(hi),
                   jnp.iinfo(jnp.int32).max)
    _, _, want = jax.lax.sort((hj, jnp.asarray(lo),
                               jnp.arange(L, dtype=jnp.int32)),
                              num_keys=2, is_stable=True)
    bound = 4 * B + 4
    got = search.stable_radix_argsort(
        torch.where(_t(valid), _t(hi), bound).to(torch.int32), bound,
        counter="K7 packed chunk")
    nv = int(valid.sum())
    np.testing.assert_array_equal(got[:nv].numpy(), np.asarray(want)[:nv])

    # and the whole function, payload gathered: valid lanes equal
    rng = np.random.default_rng(9)
    W = tw._layout_words(LAYOUT_T)
    mat = rng.integers(0, 2**32, (W, L), dtype=np.uint64).astype(np.uint32)
    emit = rng.integers(0, 2**40, L)
    types = rng.integers(0, 3, L).astype(np.int8)
    jc = jw._sort_chunk_packed(jnp.asarray(hi), jnp.asarray(lo),
                               jnp.asarray(mat), jnp.asarray(emit),
                               jnp.asarray(valid), jnp.asarray(types),
                               LAYOUT_J, L)
    tc = tw._sort_chunk_packed(_t(hi), _t(mat.view(np.int32)), _t(emit),
                               _t(valid), _t(types), LAYOUT_T, L, bound)
    assert _same_lanes(jc, tc) == nv


# ------------------------------------------------ K13a: the conditions

CONDITIONS = {
    "count_and_sum": "count() > 3 and sum(price) < 50.0",
    "avg_empties": "avg(price) < 5.0",
    "stddev": "stdDev(price) < 2.0 or count() <= 2",
    "first_last_current": "last.price - first.price < 4.0 and price >= 1.0",
    "ts_span": "eventTimestamp(last) - eventTimestamp(first) <= 40",
    "mod_negative": "volume % -3 != -1 and (last.volume - first.volume) "
                    "% 4 < 2",
    "not_avg": "not (avg(volume) > 2.0) or count() < 2",
    "div_by_count": "sum(volume) / count() >= -1.0",
}


def _interpret(prog: teg.PostfixProgram, env: dict, s, q, cur, fi) -> bool:
    """K13a's interpreter written out in numpy float64 (the kernel's rules:
    fmod then the divisor's sign, NaN kept by the stdDev clamp, indices
    clamped)."""
    arrays = [env[k] for k in prog.arrays]

    def at(k, i):
        return arrays[k][min(i, arrays[k].shape[0] - 1)]

    st = []
    f64 = np.float64
    with np.errstate(all="ignore"):
        for op, a, b in zip(prog.ops, prog.a, prog.b):
            if op == 0:
                st.append(f64(prog.consts[a]))
            elif op == 1:
                st.append(f64(q + 1 - s))
            elif op == 2:
                st.append(at(a, fi if b == 1 else (q if b == 2 else cur)))
            elif op in (3, 4, 5):
                total = at(a, q + 1) - at(a, s)
                cnt = f64(q + 1 - s)
                if op == 3:
                    st.append(total)
                elif op == 4:
                    st.append(total / cnt)
                else:
                    mean = total / cnt
                    v = (at(b, q + 1) - at(b, s)) / cnt - mean * mean
                    st.append(np.sqrt(v if (v > 0 or v != v) else f64(0)))
            elif op == 19:
                st.append(f64(st.pop() == 0))
            else:
                y, x = st.pop(), st.pop()
                if op == 10:
                    r = np.fmod(x, y)
                    if r != 0 and ((r < 0) != (y < 0)):
                        r = r + y
                else:
                    r = {6: lambda: x + y, 7: lambda: x - y,
                         8: lambda: x * y, 9: lambda: x / y,
                         11: lambda: f64(x < y), 12: lambda: f64(x <= y),
                         13: lambda: f64(x > y), 14: lambda: f64(x >= y),
                         15: lambda: f64(x == y), 16: lambda: f64(x != y),
                         17: lambda: f64((x != 0) & (y != 0)),
                         18: lambda: f64((x != 0) | (y != 0))}[op]()
                st.append(r)
    assert len(st) == 1
    return bool(st[0] != 0)


def _random_env(rng, terms, n):
    data = {"price": rng.integers(-200, 800, n) / 64.0,
            "volume": rng.integers(-9, 9, n).astype(np.float64),
            teg.TS_ATTR: (1_000 + np.cumsum(rng.integers(0, 9, n)))
            .astype(np.float64)}
    env = {}
    for a in terms.attrs:
        env[("seq", a)] = data[a]
    for a in terms.prefix_attrs:
        env[("prefix", a)] = np.r_[0.0, np.cumsum(data[a])]
    for a in terms.sq_attrs:
        env[("prefix_sq", a)] = np.r_[0.0, np.cumsum(data[a] ** 2)]
    return env


@pytest.mark.parametrize("name", list(CONDITIONS))
def test_postfix_program_matches_the_closures(name):
    """The program K13a runs, interpreted in numpy, against the plain
    closures at random windows, empty ones included (s = q + 1: NaN
    means, every comparison false)."""
    from siddhi_tpu_torch.compiler import parse_expression
    expr = parse_expression(CONDITIONS[name])
    terms = teg._collect_terms(expr, LAYOUT_T)
    cond = teg.Condition(expr)
    rng = np.random.default_rng(len(name))
    n = 300
    env = _random_env(rng, terms, n)
    host = {k: v.tolist() for k, v in env.items()}
    seen = set()
    for _ in range(400):
        q = int(rng.integers(0, n - 1))
        s = int(rng.integers(0, q + 2))
        cur = int(rng.integers(0, q + 1))
        fi = min(s, q)
        want = cond.plain(host, s, q, cur, fi)
        assert _interpret(cond.program, env, s, q, cur, fi) == want
        seen.add(want)
    assert seen == {True, False}


def test_plain_arithmetic_keeps_jnp_semantics():
    """`%` is jnp.remainder on negative operands (fmod would differ), x/0
    is an IEEE infinity or NaN, and the stdDev clamp keeps NaN."""
    for a, b in ((-7.0, 3.0), (7.0, -3.0), (-7.5, -2.0), (6.0, 3.0),
                 (5.0, 0.0), (math.inf, 2.0), (2.0, math.inf)):
        want = float(jnp.remainder(jnp.float64(a), jnp.float64(b)))
        got = teg._mod(a, b)
        assert (math.isnan(want) and math.isnan(got)) or got == want
    for a, b in ((1.0, 0.0), (-1.0, 0.0), (0.0, 0.0), (1.0, -0.0)):
        want = float(jnp.float64(a) / jnp.float64(b))
        got = teg._div(a, b)
        assert (math.isnan(want) and math.isnan(got)) or got == want
    assert math.isnan(float(jnp.maximum(jnp.float64(math.nan), 0.0)))


def _ring_and_batch(rng, B, C):
    """Ring columns of C rows and a batch of B compacted arrivals."""
    def cols(n):
        return {"symbol": rng.integers(0, 5, n).astype(np.int32),
                "price": rng.integers(-200, 800, n) / 64.0,
                "volume": rng.integers(-9, 9, n).astype(np.int64)}
    ring_cols, comp_cols = cols(C), cols(B)
    ring_ts = 1_000 + np.arange(C, dtype=np.int64) * 3
    comp_ts = 1_000 + 3 * C + np.arange(B, dtype=np.int64) * 3
    return ring_cols, ring_ts, comp_cols, comp_ts


@pytest.mark.parametrize("name", list(CONDITIONS))
def test_sliding_walk_matches_the_jax_frontiers(name, small_capacity):
    """The plain walk (the port's `_frontiers`, metric arrays built by its
    `_metric_env`) against the JAX while_loop over the same ring and
    batch, for a window start that wraps the ring."""
    B = 64
    jwin = jeg.GeneralExpressionWindow(LAYOUT_J, B, CONDITIONS[name])
    twin = teg.GeneralExpressionWindow(LAYOUT_T, B, CONDITIONS[name])
    C = twin.C
    assert C == jwin.C
    rng = np.random.default_rng(3 + len(name))
    ring_cols, ring_ts, comp_cols, comp_ts = _ring_and_batch(rng, B, C)
    for expired, winlen0, n_valid in ((C - 40, 100, B), (0, 0, B - 7),
                                      (17, 180, 50)):
        q = winlen0 + np.arange(B, dtype=np.int32)
        want = jax.jit(jwin._frontiers)(
            {k: jnp.asarray(v) for k, v in ring_cols.items()},
            jnp.asarray(ring_ts),
            {k: jnp.asarray(v) for k, v in comp_cols.items()},
            jnp.asarray(comp_ts), jnp.int64(expired), jnp.int32(winlen0),
            jnp.int32(n_valid), jnp.asarray(q))
        got = twin._frontiers(
            {k: _t(v) for k, v in ring_cols.items()}, _t(ring_ts),
            {k: _t(v) for k, v in comp_cols.items()}, _t(comp_ts),
            torch.tensor(expired), torch.tensor(winlen0, dtype=torch.int32),
            torch.tensor(n_valid, dtype=torch.int32), _t(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _feed(rng, B, rounds, price_steps=64):
    """Batches of the operator tests: prices on a 1/64 grid (some
    negative), small signed volumes, 0-3 ms apart; one empty batch."""
    t = 1_000
    out = []
    for r in range(rounds):
        n = 0 if r == 2 else int(rng.integers(1, B + 1))
        stamps = t + np.cumsum(rng.integers(0, 4, B))
        cols = {"symbol": rng.integers(0, 5, B).astype(np.int32),
                "price": rng.integers(-100, 900, B) / price_steps,
                "volume": rng.integers(-9, 12, B).astype(np.int64)}
        valid = np.arange(B) < n
        now = int(stamps[n - 1]) if n else t + 5
        t = now + 1
        out.append((stamps, cols, valid, now))
    return out


def _state_eq(ts_, js, fields):
    for f in fields:
        if f == "ring":
            np.testing.assert_array_equal(
                ts_.ring.numpy(), np.asarray(js.ring).view(np.int32))
        else:
            assert int(getattr(ts_, f)) == int(getattr(js, f)), f


@pytest.mark.parametrize("kind,condition", [
    ("monotone", "count() <= 40"),
    ("monotone", "eventTimestamp(last) - eventTimestamp(first) < 30"),
    ("general", "sum(volume) <= 60 and count() > 1"),
    ("general", "stdDev(price) < 3.0 or count() < 4"),
    ("batch", "sum(price) < 60.0"),
    ("batch_include", "avg(price) <= 5.0 or last.volume % 4 == -1"),
], ids=["count", "ts_span", "sum_general", "stddev_general", "batch_sum",
        "batch_include"])
def test_window_steps_match_jax(kind, condition, small_capacity):
    """Each window operator alone, step by step: every emitted lane (valid
    lanes in order) and the whole state."""
    B = 32
    if kind == "monotone":
        jwin = jew.ExpressionWindow(LAYOUT_J, B, condition)
        twin = tew.ExpressionWindow(LAYOUT_T, B, condition)
        fields = ("ring", "appended", "expired", "overflow")
    elif kind == "general":
        jwin = jeg.GeneralExpressionWindow(LAYOUT_J, B, condition)
        twin = teg.GeneralExpressionWindow(LAYOUT_T, B, condition)
        fields = ("ring", "appended", "expired", "overflow")
    else:
        inc = kind == "batch_include"
        jwin = jeg.GeneralExpressionBatchWindow(LAYOUT_J, B, condition, inc)
        twin = teg.GeneralExpressionBatchWindow(LAYOUT_T, B, condition, inc)
        fields = ("ring", "appended", "flushed", "prev_start", "overflow")
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    emitted = 0
    for stamps, cols, valid, now in _feed(np.random.default_rng(5), B, 9):
        jb, tb = _pair(stamps, cols, valid)
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        emitted += _same_lanes(jc, tc)
        _state_eq(ts_, js, fields)
    assert emitted > 2 * B


# ------------------------------------------------ through the public API

S = "define stream S (symbol string, price double, volume long);\n"


def _api(pkg, app, script, batch_size=4):
    rt = pkg.SiddhiManager(
        **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
        .create_siddhi_app_runtime("@app:playback\n" + app,
                                   batch_size=batch_size)
    rt.start()
    got = []
    rt.add_query_callback("q", lambda ts, i, r: got.append(
        (ts, [tuple(e.data) for e in i or []],
         [tuple(e.data) for e in r or []])))
    h = rt.get_input_handler("S")
    for op in script:
        if op[0] == "send":
            h.send(op[1], timestamp=op[2])
        else:
            rt.flush()
    rt.flush()
    return got


def _sends(rows, flush_each=True):
    out = []
    for i, row in enumerate(rows):
        out.append(("send", row, row[2] if len(row) > 3 else i))
        if flush_each:
            out.append(("flush",))
    return out


def _rows(pairs):
    return [(s, p, i) for i, (s, p) in enumerate(pairs)]


# the app and event shapes of tests/test_expression_window.py
SHAPES = {
    "count_like_length": (
        "from S#window.expression('count() <= 2') select symbol, "
        "sum(price) as total insert all events into Out;",
        _sends(_rows([("s0", 1.0), ("s1", 2.0), ("s2", 4.0), ("s3", 8.0)]),
               False)),
    "sum": ("from S#window.expression('sum(price) <= 10.0') select symbol, "
            "price insert all events into Out;",
            _sends(_rows([("a", 6.0), ("b", 5.0), ("c", 4.0)]), False)),
    "ts_span": ("from S#window.expression('eventTimestamp(last) - "
                "eventTimestamp(first) < 5000') select symbol insert all "
                "events into Out;",
                [("send", ("a", 1.0, 0), 1_000), ("send", ("b", 1.0, 1),
                                                  2_000),
                 ("send", ("c", 1.0, 2), 7_500)]),
    "inverted_count": ("from S#window.expression('count() > 3') select "
                       "symbol, price insert all events into Out;",
                       _sends(_rows([("a", 1.0), ("b", 2.0), ("c", 3.0)]))),
    "current_attr": ("from S#window.expression('price >= 10.0') select "
                     "symbol, price insert all events into Out;",
                     _sends(_rows([("a", 5.0), ("b", 12.0), ("c", 3.0),
                                   ("d", 20.0)]))),
    "or": ("from S#window.expression('sum(price) < 10.0 or count() <= 1') "
           "select symbol, price insert all events into Out;",
           _sends(_rows([("a", 6.0), ("b", 5.0), ("c", 9.0)]))),
    "avg_empties": ("from S#window.expression('avg(price) < 5.0') select "
                    "symbol, price insert all events into Out;",
                    _sends(_rows([("a", 4.0), ("b", 8.0), ("c", 2.0)]))),
    "batch_count_is_length_batch": (
        "from S#window.expressionBatch('count() <= 2') select symbol, "
        "sum(price) as t insert into Out;",
        _sends(_rows([("s0", 1.0), ("s1", 2.0), ("s2", 4.0), ("s3", 8.0)]),
               False)),
    "batch_sum_greedy": (
        "from S#window.expressionBatch('sum(price) <= 10.0') select symbol, "
        "price insert all events into Out;",
        _sends(_rows([("a", 4.0), ("b", 5.0), ("c", 3.0), ("d", 8.0),
                      ("e", 1.0)]))),
    "batch_include_trigger": (
        "from S#window.expressionBatch('count() <= 2', true) select symbol "
        "insert all events into Out;",
        _sends(_rows([(c, 1.0) for c in "abcdef"]))),
    "batch_oversized_single": (
        "from S#window.expressionBatch('sum(price) <= 10.0') select symbol "
        "insert all events into Out;",
        [("send", ("big", 50.0, 0), 0), ("flush",),
         ("send", ("a", 4.0, 1), 1), ("send", ("b", 9.0, 2), 2)]),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_shapes_match_jax(name):
    app, script = SHAPES[name]
    app = S + "@info(name='q') " + app
    want = _api(siddhi_tpu, app, script)
    assert any(i or r for _, i, r in want)
    assert _api(siddhi_tpu_torch, app, script) == want


@pytest.mark.parametrize("window,match", [
    ("expression('min(price) < 5.0')", "min"),
    ("expression(\"symbol == 'IBM'\")", "string"),
    ("expressionBatch('count() <= 2', false, true)", "3rd parameter"),
    ("expression('count() + 1')", "must be boolean"),
], ids=["min", "string_constant", "stream_mode", "not_boolean"])
def test_refusals_match_jax(window, match):
    app = (S + f"@info(name='q') from S#window.{window} select symbol "
           "insert into Out;")
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match=match):
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    with pytest.raises(SiddhiAppCreationError, match=match):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app)


# ------------------------------------------------ apps W and X


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


SMALL = {"w_length": 300, "x_volume": 10_000, "x_price": 500.0,
         "y_wide": 250}


def run_app(pkg, cs, name, rounds=4, batch=512, seed=11, **kw):
    """chip_smoke.py's app `name` at a reduced size through `pkg`; returns
    (the checker of the script's oracle, {stream: events})."""
    text, queries = cs.expr_app_plan(**SMALL)[name]
    sym, price, volume, ts, pool = cs.expr_app_events(
        np.random.default_rng(seed), name, rounds, batch, z_rate=83)
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        text, batch_size=batch)
    got = {o: [] for o in queries.values()}
    for o in queries.values():
        rt.add_callback(o, got[o].extend)
    h = rt.get_input_handler("TradeStream")
    cols = {"symbol": pool[sym], "price": price, "volume": volume}
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        h.send_columns({k: v[s] for k, v in cols.items()},
                       timestamps=ts[s])
        rt.flush()
    check = cs.expect_expr_app(name, sym, price, volume, ts, pool, rounds,
                               batch, **SMALL)
    return check, got


def assert_apps_equal(want: dict, got: dict):
    for stream, w in want.items():
        g = got[stream]
        assert len(g) == len(w) > 0, stream
        for a, b in zip(w, g):
            assert (a.timestamp, a.is_expired) == (b.timestamp, b.is_expired)
            assert tuple(a.data) == tuple(b.data)


@pytest.mark.parametrize("name", ["W", "X"])
def test_apps_match_jax_and_the_oracle(name):
    """Apps W (`expression('count() <= 300')`) and X (`expression(
    'sum(volume) <= 10000')` and `expressionBatch('sum(price) < 500.0',
    true)`) at 4 rounds of 512: the port against the JAX package event for
    event, and against chip_smoke.py's numpy oracle (exact)."""
    cs = _chip_smoke()
    _, want = run_app(siddhi_tpu, cs, name)
    check, got = run_app(siddhi_tpu_torch, cs, name, device="cpu")
    assert_apps_equal(want, got)
    assert check(got) == sum(len(v) for v in got.values())


@pytest.mark.parametrize("window", [
    "expression('count() <= 30')",
    "expression('sum(volume) <= 200 and count() > 2')",
], ids=["monotone", "general"])
def test_minmax_over_an_expression_window_matches_jax(window):
    """An expression window is a FIFO sliding window to min/max (the K8
    range path), grouped, on 3 rounds of 256."""
    from tests.test_torch_session_sort import S as SK, _feeds, _run
    from tests.test_torch_session_sort import assert_same
    app = (SK + f"from S#window.{window} select symbol, max(price) as hi, "
           "min(volume) as lo, count() as n group by symbol insert all "
           "events into Out;")
    feeds = _feeds(61, rounds=3, n=256)
    want = _run(siddhi_tpu, app, feeds, batch_size=256)
    assert len(want) > 0
    assert_same(want, _run(siddhi_tpu_torch, app, feeds, batch_size=256,
                           device="cpu"))
