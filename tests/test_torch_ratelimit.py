"""The output rate limiters of siddhi_tpu_torch against the JAX package on
the CPU: K13c's plain append and gather against the JAX ring scatter and
gather, every limiter class stepped directly from the same state (the JAX
state carried over by interop.py), every make_rate_limiter branch, every
limiter shape of tests/test_ratelimit.py through both public APIs, and
seeded random feeds of the shapes that file lacks.

Inputs are made with numpy from a seed and handed to both packages.
Events, their order, strings, longs, timestamps and event types must be
equal; floats within rtol 1e-5 (float32 accumulation order,
tests/test_numeric_parity.py) plus atol 1e-3 for what removal leaves of a
float32 sum.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import dtypes as jdtypes
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops import ratelimit as jrl
from siddhi_tpu.query_api.execution import OutputRate as JRate
from siddhi_tpu.query_api.execution import OutputRateType as JRateType
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import dtypes as tdtypes
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.ops import ratelimit as trl
from siddhi_tpu_torch.ops.selector import GROUP_SLOT_COL
from siddhi_tpu_torch.query_api.execution import OutputRate as TRate
from siddhi_tpu_torch.query_api.execution import OutputRateType as TRateType

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3

LAYOUT_J = {"symbol": jnp.int32, "price": jnp.float32, "volume": jnp.int64}
LAYOUT_T = {"symbol": torch.int32, "price": torch.float32,
            "volume": torch.int64}
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------ K13c, plain


@pytest.mark.parametrize("C,appended", [(16, 0), (16, 13), (24, 2**40 + 5)],
                         ids=["empty", "wraps", "large_count"])
def test_k13c_plain_append_matches_the_jax_ring_scatter(C, appended):
    """The selected lanes ranked in lane order at (appended % C + rank) % C,
    wrap-around at the ring's end included, against the JAX int32 slot
    math and `.at[slot].set(mode="drop")` of BufferedLimiter.step."""
    rng = np.random.default_rng(C + appended % 7)
    B = C // 2
    sel = rng.random(B) < 0.6
    src = {"a": rng.integers(-9, 9, B).astype(np.int32),
           "b": rng.standard_normal(B).astype(np.float32),
           "c": rng.integers(0, 2**50, B)}
    ring = {k: rng.integers(0, 5, C).astype(v.dtype) for k, v in src.items()}
    got, n = trl.ring_append_plain({k: _t(v) for k, v in ring.items()},
                                   {k: _t(v) for k, v in src.items()},
                                   _t(sel), torch.tensor(appended))
    order = np.asarray(jrl.stable_partition_order(jnp.asarray(sel)))
    base = appended % C
    p = np.arange(B)
    slot = np.where(p < sel.sum(), (base + p) % C, C)
    for k, v in src.items():
        want = jnp.asarray(ring[k]).at[jnp.asarray(slot)].set(
            jnp.asarray(v)[order], mode="drop")
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want), k)
    assert int(n) == int(sel.sum())


@pytest.mark.parametrize("lo,n", [(0, 0), (5, 16), (14, 9), (2**40 + 3, 7)],
                         ids=["none", "whole", "wraps", "large_lo"])
def test_k13c_plain_gather_matches_the_jax_ring_gather(lo, n):
    """out[i] = ring[(lo % C + i) % C], valid = (i < n) & ring.valid, as
    BufferedLimiter.step gathers [emit_from, flush_to)."""
    rng = np.random.default_rng(lo % 11 + n)
    C = 16
    ring = {"a": rng.integers(-9, 9, C).astype(np.int32),
            "t": rng.integers(0, 2**45, C)}
    rvalid = rng.random(C) < 0.8
    cols, valid = trl.ring_gather_plain(
        {k: _t(v) for k, v in ring.items()}, torch.tensor(lo),
        torch.tensor(n), _t(rvalid))
    i32 = jnp.arange(C, dtype=jnp.int32)
    oslot = (jnp.int32(lo % C) + i32) % C
    for k, v in ring.items():
        np.testing.assert_array_equal(cols[k].numpy(),
                                      np.asarray(jnp.asarray(v)[oslot]))
    np.testing.assert_array_equal(
        valid.numpy(), np.asarray((i32 < n) & jnp.asarray(rvalid)[oslot]))


# ------------------------------------------------ the limiters alone


def _batch(rng, B, t0, types=True, n_groups=6, slot_col=False):
    """A chunk of B lanes from t0 on: about a quarter invalid, a fifth
    EXPIRED (when `types`), symbols as codes < n_groups."""
    ts = t0 + np.cumsum(rng.integers(0, 120, B))
    cols = {"symbol": rng.integers(0, n_groups, B).astype(np.int32),
            "price": (rng.integers(1, 60, B) * 0.5).astype(np.float32),
            "volume": rng.integers(0, 1000, B).astype(np.int64)}
    if slot_col:
        cols[GROUP_SLOT_COL] = cols["symbol"].copy()
    valid = rng.random(B) < 0.75
    kinds = (np.where(rng.random(B) < 0.2, 1, 0) if types
             else np.zeros(B)).astype(np.int8)
    return ts, cols, valid, kinds


def _jb(ts, cols, valid, kinds):
    return JBatch(ts=jnp.asarray(ts), cols={k: jnp.asarray(v)
                                            for k, v in cols.items()},
                  valid=jnp.asarray(valid), types=jnp.asarray(kinds))


def _tb(ts, cols, valid, kinds):
    return TBatch(ts=_t(ts), cols={k: _t(v) for k, v in cols.items()},
                  valid=_t(valid), types=_t(kinds))


def _emitted_equal(jo, to):
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    v = np.asarray(jo.valid)
    np.testing.assert_array_equal(to.ts.numpy()[v], np.asarray(jo.ts)[v])
    np.testing.assert_array_equal(to.types.numpy()[v],
                                  np.asarray(jo.types)[v])
    for k in to.cols:
        np.testing.assert_array_equal(to.cols[k].numpy()[v],
                                      np.asarray(jo.cols[k])[v], k)
    return int(v.sum())


def _state_equal(ts_, js):
    """Every field of the port's state against the JAX state carried over
    by interop (bit for bit)."""
    want = interop.limiter_state(js, ts_)
    for a, b in zip(_leaves(want), _leaves(ts_)):
        np.testing.assert_array_equal(b.numpy(), a.numpy())


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name))]
    return [x for v in obj for x in _leaves(v)]


def _limiters(kind):
    lay_j, lay_t = LAYOUT_J, LAYOUT_T
    if kind == "first_every_3":
        return jrl.EventOrdinalLimiter(3, "first"), \
            trl.EventOrdinalLimiter(3, "first")
    if kind == "last_every_5":
        return jrl.EventOrdinalLimiter(5, "last"), \
            trl.EventOrdinalLimiter(5, "last")
    if kind == "all_every_7":
        return (jrl.BufferedLimiter(lay_j, 16, n_events=7),
                trl.BufferedLimiter(lay_t, 16, n_events=7))
    if kind in ("all_every_sec", "last_every_sec"):
        which = kind.split("_")[0]
        return (jrl.BufferedLimiter(lay_j, 16, time_ms=1000, which=which),
                trl.BufferedLimiter(lay_t, 16, time_ms=1000, which=which))
    if kind == "all_every_sec_small_ring":
        pair = (jrl.BufferedLimiter(lay_j, 16, time_ms=1000),
                trl.BufferedLimiter(lay_t, 16, time_ms=1000))
        for lim in pair:
            lim.C = 24  # shrunken: a bucket outgrows the ring
        return pair
    if kind == "first_every_sec":
        return jrl.TimeFirstLimiter(1000), trl.TimeFirstLimiter(1000)
    if kind == "snapshot":
        return (jrl.SnapshotLimiter(lay_j, 1000),
                trl.SnapshotLimiter(lay_t, 1000))
    if kind == "windowed_snapshot":
        return (jrl.WindowedSnapshotLimiter(lay_j, 1000, 32),
                trl.WindowedSnapshotLimiter(lay_t, 1000, 32))
    if kind == "contents_snapshot":
        return jrl.ContentsSnapshotLimiter(1000), \
            trl.ContentsSnapshotLimiter(1000)
    assert kind == "grouped_snapshot"
    return (jrl.GroupedSnapshotLimiter(lay_j, 1000, 4, 1 << 20),
            trl.GroupedSnapshotLimiter(lay_t, 1000, 4, 1 << 20))


KINDS = ["first_every_3", "last_every_5", "all_every_7", "all_every_sec",
         "last_every_sec", "all_every_sec_small_ring", "first_every_sec",
         "snapshot", "windowed_snapshot", "contents_snapshot",
         "grouped_snapshot"]


@pytest.mark.parametrize("kind", KINDS)
def test_limiter_steps_from_the_same_state_match_jax(kind):
    """Three JAX steps, then the JAX state carried into the port by
    interop.limiter_state, then five steps of both from it (one an empty
    heartbeat): every emitted lane and the whole state after each step."""
    rng = np.random.default_rng(len(kind))
    B = 16
    jl, tl = _limiters(kind)
    js = jl.init_state()
    grouped = kind == "grouped_snapshot"
    windowed = kind == "windowed_snapshot"
    t0 = 100

    def step_j(state, b, now):
        if kind == "contents_snapshot":
            return jl.step_contents(state, b, jnp.int64(now))
        return jl.step(state, b, jnp.int64(now))

    def step_t(state, b, now):
        if kind == "contents_snapshot":
            return tl.step_contents(state, b, now)
        return tl.step(state, b, now)

    def feed(r):
        nonlocal t0
        b = _batch(rng, B, t0, types=windowed, n_groups=6 if grouped else 9,
                   slot_col=grouped)
        if r == 5:  # a heartbeat: nothing valid
            b = (b[0], b[1], np.zeros(B, bool), b[3])
        now = int(b[0][-1]) + int(rng.integers(0, 900))
        t0 = now + 1
        return b, now

    for r in range(3):
        b, now = feed(r)
        js, _ = step_j(js, _jb(*b), now)
    ts_ = interop.limiter_state(js, tl.init_state(CPU))
    _state_equal(ts_, js)
    emitted = 0
    for r in range(3, 8):
        b, now = feed(r)
        js, jo = step_j(js, _jb(*b), now)
        ts_, to = step_t(ts_, _tb(*b), now)
        emitted += _emitted_equal(jo, to)
        _state_equal(ts_, js)
    assert emitted > 0


def test_buffered_overflow_truncates_to_the_newest_lanes():
    """TestBufferedLimiterOverflow at its sizes: 12 lanes in one bucket of a
    shrunken C = 8 ring; the close emits the newest 8, in order, in both."""
    outs = []
    for pkg, lim_cls, layout in ((jnp, jrl.BufferedLimiter,
                                  {"x": jnp.int32}),
                                 (torch, trl.BufferedLimiter,
                                  {"x": torch.int32})):
        lim = lim_cls(layout, out_width=4, time_ms=1000, which="all")
        lim.C = 8
        state = lim.init_state() if pkg is jnp else lim.init_state(CPU)
        got = []
        for vals, ts in ((range(0, 4), 100), (range(4, 8), 100),
                         (range(8, 12), 100), ([], 1500)):
            b = len(vals)
            batch = (_jb if pkg is jnp else _tb)(
                np.full(b, ts, np.int64),
                {"x": np.asarray(list(vals), np.int32)},
                np.ones(b, bool), np.zeros(b, np.int8))
            now = jnp.int64(ts) if pkg is jnp else ts
            state, out = lim.step(state, batch, now)
            v = np.asarray(out.valid)
            got.append(np.asarray(out.cols["x"])[v].tolist())
        outs.append(got)
    assert outs[0] == outs[1] == [[], [], [], list(range(4, 12))]


# ------------------------------------------------ make_rate_limiter


RATES = [
    (None, {}), (("all", None, 4), {}), (("first", None, 4), {}),
    (("last", None, 4), {}), (("first", 1000, None), {}),
    (("all", 1000, None), {}), (("last", 1000, None), {}),
    (("snapshot", 1000, None), {}),
    (("snapshot", 1000, None), {"grouped": True, "group_capacity": 512}),
    (("snapshot", 1000, None), {"grouped": True}),
    (("snapshot", 1000, None), {"fifo_window": True,
                                "window_capacity": 9000}),
    (("snapshot", 1000, None), {"fifo_window": True}),
    (("snapshot", 1000, None), {"fifo_window": True,
                                "has_aggregates": True}),
    (("snapshot", 1000, None), {"contents_window": True}),
    (("snapshot", 1000, None), {"contents_window": True, "grouped": True,
                                "has_aggregates": True}),
]


@pytest.mark.parametrize("rate,kw", RATES, ids=[
    "none", "all_events", "first_events", "last_events", "first_time",
    "all_time", "last_time", "snapshot", "grouped_small_capacity",
    "grouped", "fifo", "fifo_default_cap", "fifo_aggregated", "contents",
    "contents_grouped_aggregated"])
def test_make_rate_limiter_picks_the_jax_class(rate, kw):
    def make(pkg_rate, pkg_type, mod, layout):
        r = (None if rate is None else
             pkg_rate(pkg_type(rate[0]), time_ms=rate[1],
                      event_count=rate[2]))
        return mod.make_rate_limiter(r, layout, 6000, **kw)

    j = make(JRate, JRateType, jrl, LAYOUT_J)
    t = make(TRate, TRateType, trl, LAYOUT_T)
    assert type(t).__name__ == type(j).__name__
    for attr in ("n", "which", "C", "B", "n_events", "time_ms", "T", "Cap",
                 "G", "has_time_semantics"):
        assert getattr(t, attr, None) == getattr(j, attr, None), attr


def test_snapshot_without_a_period_is_refused_as_in_jax():
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match="needs a time period"):
        jrl.make_rate_limiter(JRate(JRateType.SNAPSHOT, event_count=3),
                              LAYOUT_J, 8)
    with pytest.raises(SiddhiAppCreationError, match="needs a time period"):
        trl.make_rate_limiter(TRate(TRateType.SNAPSHOT, event_count=3),
                              LAYOUT_T, 8)


# ------------------------------------------------ through the public API

S = "define stream S (symbol string, price float);\n"


def _api(pkg, app, script, batch_size=4):
    rt = pkg.SiddhiManager(
        **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
        .create_siddhi_app_runtime("@app:playback\n" + S + app,
                                   batch_size=batch_size)
    rt.start()
    got = []
    rt.add_query_callback("q", lambda ts, i, r: got.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
         [(e.timestamp, tuple(e.data)) for e in r or []])))
    h = rt.get_input_handler("S")
    for op in script:
        if op[0] == "send":
            h.send(op[1], timestamp=op[2])
        elif op[0] == "hb":
            rt.heartbeat(op[1])
        else:
            rt.flush()
    rt.flush()
    return got


def _sends(pairs, ts0=0, flush_each=False):
    out = []
    for i, (s, p) in enumerate(pairs):
        out.append(("send", (s, float(p)), ts0 + i))
        if flush_each:
            out.append(("flush",))
    return out + [("flush",)]


def _letters(word):
    return [(c, i) for i, c in enumerate(word)]


def _at(*rows):
    """(symbol, price, ts) rows, then a flush."""
    return [("send", (s, float(p)), t) for s, p, t in rows] + [("flush",)]


Q = "@info(name='q') from S "
GROUPED_SUM = (Q + "select symbol, sum(price) as total group by symbol "
               "output {} insert into Out;")

# the limiter shapes of tests/test_ratelimit.py (its two table cases are
# test_const_insert_* below)
SHAPES = {
    "last_every_3_events": (
        Q + "select symbol, price output last every 3 events insert into "
        "Out;", _sends(_letters("abcdef")), 4),
    "first_every_3_events": (
        Q + "select symbol, price output first every 3 events insert into "
        "Out;", _sends(_letters("abcdef")), 4),
    "all_every_2_events": (
        Q + "select symbol, price output all every 2 events insert into "
        "Out;", _sends(_letters("abcde")), 4),
    "carry_across_batches": (
        Q + "select symbol, price output last every 3 events insert into "
        "Out;", _sends(_letters("abcd"), flush_each=True), 2),
    "snapshot_reemits_latest": (
        Q + "select symbol, price output snapshot every 1 sec insert into "
        "Out;", _at(("a", 1, 100), ("b", 2, 200))
        + [("hb", 1500), ("hb", 2500)], 4),
    "snapshot_boundary_pre_batch": (
        Q + "select symbol, price output snapshot every 1 sec insert into "
        "Out;", _at(("a", 1, 900)) + _at(("b", 2, 1100)), 4),
    "grouped_snapshot_last_row": (
        Q + "select symbol, price group by symbol output snapshot every 1 "
        "sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 200), ("a", 3, 300))
        + [("hb", 1500), ("hb", 2500)] + _at(("b", 9, 2600))
        + [("hb", 3500)], 4),
    "grouped_snapshot_aggregate": (
        GROUPED_SUM.format("snapshot every 1 sec"),
        _at(("a", 1, 100), ("a", 2, 200), ("b", 5, 300)) + [("hb", 1500)],
        4),
    "first_every_second": (
        Q + "select symbol, price output first every 1 sec insert into "
        "Out;", _at(("a", 1, 100), ("b", 2, 200)) + _at(("c", 3, 1300)), 4),
    "all_every_second": (
        Q + "select symbol, price output all every 1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 200)) + [("hb", 1500)], 4),
    "last_every_second": (
        Q + "select symbol, price output last every 1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 200)) + [("hb", 1500)], 4),
    "windowed_length": (
        "@info(name='q') from S#window.length(3) select symbol, price "
        "output snapshot every 1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 101), ("c", 3, 102), ("d", 4, 103))
        + [("hb", 1500)], 4),
    "windowed_time_expiry": (
        "@info(name='q') from S#window.time(2 sec) select symbol, price "
        "output snapshot every 1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 1900))
        + [("hb", 2500), ("hb", 3500), ("hb", 4500)], 4),
    "windowed_aggregated": (
        "@info(name='q') from S#window.length(3) select sum(price) as total "
        "output snapshot every 1 sec insert into Out;",
        _at(("a", 1, 100), ("a", 2, 101), ("a", 3, 102)) + [("hb", 1500)],
        4),
    "windowed_length_batch": (
        "@info(name='q') from S#window.lengthBatch(2) select symbol, price "
        "output snapshot every 1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 101), ("c", 3, 102), ("d", 4, 103))
        + [("hb", 1500)], 4),
    "grouped_non_aggregated_window": (
        "@info(name='q') from S#window.length(3) select symbol, price "
        "group by symbol output snapshot every 1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 101), ("a", 3, 102), ("b", 4, 103))
        + [("hb", 1500)], 4),
    "sort_window_live_set": (
        "@info(name='q') from S#window.sort(2, price) select symbol, price "
        "output snapshot every 1 sec insert into Out;",
        _at(("hi", 5, 100), ("lo", 1, 101), ("mid", 3, 102))
        + [("hb", 1500), ("hb", 2500)], 4),
    "frequent_window_live_set": (
        "@info(name='q') from S#window.frequent(1, symbol) select symbol, "
        "price output snapshot every 1 sec insert into Out;",
        _at(("a", 1, 100)) + _at(("a", 2, 101)) + _at(("b", 3, 102))
        + [("hb", 1500)], 4),
    "session_window_expiry": (
        "@info(name='q') from S#window.session(1 sec) select symbol, price "
        "output snapshot every 2 sec insert into Out;",
        _at(("a", 1, 100)) + [("hb", 2500)], 4),
    "grouped_aggregated_window": (
        "@info(name='q') from S#window.length(3) select symbol, sum(price) "
        "as total group by symbol output snapshot every 1 sec insert into "
        "Out;", _at(("a", 1, 100), ("b", 2, 101), ("a", 3, 102))
        + [("hb", 1500)], 4),
    "nonfifo_pre_batch": (
        "@info(name='q') from S#window.sort(5, price) select symbol, price "
        "output snapshot every 1 sec insert into Out;",
        _at(("early", 1, 500)) + _at(("late", 2, 1500)) + [("hb", 2500)],
        4),
    "nonfifo_having": (
        "@info(name='q') from S#window.sort(5, price) select symbol, price "
        "having price > 2.0 output snapshot every 1 sec insert into Out;",
        _at(("lo", 1, 100), ("hi", 5, 101)) + [("hb", 1500)], 4),
    "last_every_3_events_grouped": (
        GROUPED_SUM.format("last every 3 events"),
        _sends(_letters("ababab")), 4),
    "first_every_2_events_grouped": (
        GROUPED_SUM.format("first every 2 events"),
        _sends(_letters("abab")), 4),
    "snapshot_time_grouped": (
        GROUPED_SUM.format("snapshot every 1 sec"),
        _at(("a", 1, 100), ("b", 2, 200), ("a", 3, 300)) + [("hb", 1500)],
        4),
    "all_every_second_grouped": (
        Q + "select symbol, count() as n group by symbol output all every "
        "1 sec insert into Out;",
        _at(("a", 1, 100), ("b", 2, 200)) + [("hb", 1500)], 4),
}


def assert_same_emissions(want, got):
    assert len(got) == len(want)
    for (wt, wi, wr), (gt, gi, gr) in zip(want, got):
        assert gt == wt
        for w_rows, g_rows in ((wi, gi), (wr, gr)):
            assert len(g_rows) == len(w_rows)
            for (wts, wd), (gts, gd) in zip(w_rows, g_rows):
                assert gts == wts
                for w, g in zip(wd, gd):
                    if isinstance(w, float):
                        np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                                   atol=FLOAT_ATOL)
                    else:
                        assert type(g) is type(w) and g == w


@pytest.mark.parametrize("name", list(SHAPES))
def test_shapes_match_jax(name):
    app, script, bs = SHAPES[name]
    want = _api(siddhi_tpu, app, script, bs)
    got = _api(siddhi_tpu_torch, app, script, bs)
    assert_same_emissions(want, got)
    if name != "session_window_expiry":  # the session closed: nothing
        assert any(i for _, i, _ in want)


def test_nonfifo_snapshot_refuses_limit_as_jax():
    app = ("@app:playback\n" + S + "@info(name='q') from S#window.sort(5, "
           "price) select symbol, price limit 1 output snapshot every 1 sec "
           "insert into Out;")
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match="order by / limit / offset"):
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    with pytest.raises(SiddhiAppCreationError,
                       match="order by / limit / offset"):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app)


def test_nonfifo_snapshot_refuses_post_window_filters_as_jax():
    app = ("@app:playback\n" + S + "@info(name='q') from S#window.sort(5, "
           "price)[price > 1.0] select symbol, price output snapshot every "
           "1 sec insert into Out;")
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match="post-window functions/filters"):
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    with pytest.raises(SiddhiAppCreationError,
                       match="post-window functions/filters"):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app)


# ------------------------------------------------ seeded random feeds

SF = ("@app:playback\n"
      "define stream S (symbol string, price double, volume long, k int);\n"
      "@info(name = 'q') ")


def _feeds(seed, rounds=4, n=512, n_syms=7, step=(0, 40)):
    rng = np.random.default_rng(seed)
    t = 1_000
    feeds = []
    for _ in range(rounds):
        ts = t + np.cumsum(rng.integers(step[0], step[1], n))
        t = int(ts[-1]) + 1
        feeds.append(({"symbol": np.array([f"S{i}" for i in
                                           rng.integers(0, n_syms, n)],
                                          dtype=object),
                       "price": rng.integers(1, 60, n) * 0.5,
                       "volume": rng.integers(1, 40, n).astype(np.int64),
                       "k": rng.integers(0, 9, n).astype(np.int32)}, ts))
    return feeds


def _run(pkg, app, feeds, heartbeats=(), batch_size=128, **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=batch_size, group_capacity=2048)
    got = []
    rt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    for cols, ts in feeds:
        rt.get_input_handler("S").send_columns(cols, timestamps=ts)
        rt.flush()
    for hb in heartbeats:
        rt.heartbeat(hb)
    return rt, got


def assert_same(want, got):
    assert len(got) == len(want)
    for (wt, wd, we), (gt, gd, ge) in zip(want, got):
        assert (gt, ge) == (wt, we)
        for w, g in zip(wd, gd):
            if isinstance(w, float):
                np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                           atol=FLOAT_ATOL)
            else:
                assert type(g) is type(w) and g == w


FEED_APPS = {
    "last_every_sec": "from S select symbol, price, volume output last "
                      "every 1 sec insert into Out;",
    "all_every_5_events": "from S select symbol, volume output all every 5 "
                          "events insert into Out;",
    "first_every_sec_grouped": "from S select symbol, sum(volume) as v "
                               "group by symbol output first every 1 sec "
                               "insert into Out;",
    "windowed_length_batch": "from S#window.lengthBatch(100) select symbol, "
                             "price output snapshot every 2 sec insert into "
                             "Out;",
    "windowed_time_batch": "from S#window.timeBatch(3 sec) select symbol, "
                           "volume output snapshot every 2 sec insert into "
                           "Out;",
    "contents_session": "from S#window.session(5 sec) select symbol, price "
                        "output snapshot every 2 sec insert into Out;",
    "contents_hopping": "from S#window.hopping(3 sec, 1 sec) select symbol, "
                        "volume output snapshot every 2 sec insert into "
                        "Out;",
}


@pytest.mark.parametrize("name", list(FEED_APPS))
def test_random_feeds_match_jax(name):
    """4 rounds of 512 events 0-40 ms apart, batches of 128, then
    heartbeats past the last bucket: event for event."""
    feeds = _feeds(7 + len(name))
    end = int(feeds[-1][1][-1])
    app = SF + FEED_APPS[name]
    hbs = (end + 1_000, end + 3_000)
    _, want = _run(siddhi_tpu, app, feeds, hbs)
    _, got = _run(siddhi_tpu_torch, app, feeds, hbs, device="cpu")
    assert len(want) > 0
    assert_same(want, got)


def test_grouped_snapshot_past_the_group_capacity_counts_as_jax():
    """More symbols than snapshot_group_capacity (shrunk to 16 in both):
    the same rows snapshot and the same overflow count."""
    app = SF + ("from S select symbol, sum(volume) as v group by symbol "
                "output snapshot every 1 sec insert into Out;")
    feeds = _feeds(5, rounds=4, n=256, n_syms=40)
    end = int(feeds[-1][1][-1])
    old = (jdtypes.config.snapshot_group_capacity,
           tdtypes.config.snapshot_group_capacity)
    jdtypes.config.snapshot_group_capacity = 16
    tdtypes.config.snapshot_group_capacity = 16
    try:
        jrt, want = _run(siddhi_tpu, app, feeds, (end + 1_000,))
        trt, got = _run(siddhi_tpu_torch, app, feeds, (end + 1_000,),
                        device="cpu")
    finally:
        (jdtypes.config.snapshot_group_capacity,
         tdtypes.config.snapshot_group_capacity) = old
    assert len(want) > 0
    assert_same(want, got)
    j_over = int(np.asarray(jrt.query_runtimes["q"].state[2].overflow))
    t_over = int(trt.query_runtimes["q"].state[2].overflow)
    assert t_over == j_over > 0


# ------------------------------------------------ apps AA and AB

SMALL = {"aa_length": 300, "ab_length": 100}


def run_limiter_app(pkg, cs, name, rounds=4, batch=512, seed=13, **kw):
    """chip_smoke.py's app `name` at a reduced size through `pkg` (AA at
    83 events a second, so a round of 512 crosses second boundaries);
    returns (the checker of the script's oracle, {stream: events})."""
    text, queries = cs.limiter_app_plan(**SMALL)[name]
    sym, price, volume, ts, pool = cs.limiter_app_events(
        np.random.default_rng(seed), name, rounds, batch, aa_rate=83)
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
    check = cs.expect_limiter_app(name, sym, price, volume, ts, pool,
                                  rounds, batch, **SMALL)
    return check, got


@pytest.mark.parametrize("name", ["AA", "AB"])
def test_apps_match_jax_and_the_oracle(name):
    """Apps AA (the five rates of a dashboard) and AB (a leaderboard:
    ORDER BY two keys, LIMIT, OFFSET over lengthBatch(100)) at 4 rounds of
    512: the port against the JAX package event for event (floats within
    the stated tolerance), and against chip_smoke.py's numpy oracles."""
    from tests.test_torch_expression_window import _chip_smoke
    cs = _chip_smoke()
    _, want = run_limiter_app(siddhi_tpu, cs, name)
    check, got = run_limiter_app(siddhi_tpu_torch, cs, name, device="cpu")
    for stream, w in want.items():
        assert len(w) > 0, stream
        assert_same([(e.timestamp, tuple(e.data), e.is_expired) for e in w],
                    [(e.timestamp, tuple(e.data), e.is_expired)
                     for e in got[stream]])
    assert check(got) == sum(len(v) for v in got.values())


@pytest.mark.parametrize("select,ok", [
    ("select 5.0 as wrongname", False),
    ("select 5.0 as price, 'NEW' as sym", True)])
def test_const_insert_into_a_table(select, ok):
    """tests/test_ratelimit.py's `test_const_insert_rejects_schema_mismatch`
    and `test_const_insert_maps_by_name`: a standalone `select <constants>
    insert into T` checks its names against the table schema and inserts
    by name, in both packages."""
    from siddhi_tpu.errors import SiddhiAppCreationError as JError
    outcomes = []
    for pkg, err in ((siddhi_tpu, JError),
                     (siddhi_tpu_torch, SiddhiAppCreationError)):
        rt = pkg.SiddhiManager(
            **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
            .create_siddhi_app_runtime(
                "define table T (sym string, price double);")
        try:
            rt.query(f"{select} insert into T")
            outcomes.append(("rows", rt.tables["T"].all_rows()))
        except err as e:
            outcomes.append(("error", str(e)))
    assert outcomes[1] == outcomes[0]
    if ok:
        assert outcomes[1] == ("rows", [("NEW", 5.0)])
    else:
        assert outcomes[1][0] == "error" and "missing" in outcomes[1][1]
