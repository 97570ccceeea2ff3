"""Incremental aggregation of siddhi_tpu_torch against the JAX package on
the CPU: `bucket_start` and `bucket_bounds` on every duration (pre-1970
and leap-year instants too), every shape of tests/test_aggregations.py
but snapshot/restore (persistence is not yet ported), a single-point
`within`, min/max with NaN and signed zeros, capacity-pressure eviction,
growth, retention, the stream join, a seeded random feed through `every
sec ... year` across a year boundary, and an aggregation stepped on from
a carried JAX state (`interop.load_aggregation`).

Found rows, group columns, counts, int64 sums, min/max, AGG_TIMESTAMP,
store counts and error texts must be equal; float32 sums within 1e-5 of
the bucket's sum of magnitudes (the random feed carries that sum as a
column) or rtol 1e-5 where the feed is a handful of events.
"""

import datetime as dt
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import aggregation as jagg
from siddhi_tpu.query_api.definition import Duration as JDuration
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import aggregation as tagg
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.query_api.definition import Duration

FLOAT_RTOL = 1e-5
HOUR = 3_600_000
DAY = 86_400_000

APP = """
define stream TradeStream (symbol string, price double, volume long, ts long);
define aggregation TradeAgg
from TradeStream
select symbol, avg(price) as avgPrice, sum(price) as total, count() as n
group by symbol
aggregate by ts every sec, min, hours, days;
"""


def _utc(*a) -> int:
    return int(dt.datetime(*a, tzinfo=dt.timezone.utc).timestamp() * 1000)


def _build(pkg, text, **kw):
    mk = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    return pkg.SiddhiManager(**mk).create_siddhi_app_runtime(text, **kw)


def run_script(pkg, text, script, **kw):
    """Run `script` through one package; returns what it observed. Ops:
    ("send", stream, rows) sends and flushes; ("query", text);
    ("heartbeat", t); ("count", agg, duration index) the store's live
    keys; ("capacity", agg); ("check", agg) forces the next batch's
    capacity check. A raising op records its error's type and text."""
    try:
        rt = _build(pkg, text, **kw)
    except Exception as e:  # noqa: BLE001 - the error is the observation
        return [("create", type(e).__name__, str(e))]
    rt.start()
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for op in script:
            try:
                kind = op[0]
                if kind == "send":
                    h = rt.get_input_handler(op[1])
                    for row in op[2]:
                        h.send(row)
                    rt.flush()
                elif kind == "query":
                    seen.append(("query", [tuple(e.data)
                                           for e in rt.query(op[1])]))
                elif kind == "heartbeat":
                    rt.heartbeat(op[1])
                elif kind == "count":
                    st = rt.aggregations[op[1]].state[op[2]]
                    seen.append(("count", int(st.key_table.count)))
                elif kind == "capacity":
                    seen.append(("capacity",
                                 rt.aggregations[op[1]].capacity))
                elif kind == "check":
                    rt.aggregations[op[1]]._batches_since_check = 32
            except Exception as e:  # noqa: BLE001 - the observation
                seen.append((op[0], type(e).__name__, str(e)))
    return seen


def assert_same(want, got, rtol=FLOAT_RTOL):
    """Equal structure; floats within rtol (NaN equal to NaN), the rest
    exact, type too."""
    if isinstance(want, float):
        assert isinstance(got, float), (want, got)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (want, got)
        for w, g in zip(want, got):
            assert_same(w, g, rtol)
    else:
        assert type(got) is type(want) and got == want, (want, got)


def parity(text, script, **kw):
    want = run_script(siddhi_tpu, text, script, **kw)
    got = run_script(siddhi_tpu_torch, text, script, **kw)
    assert_same(want, got)
    return got


# --------------------------------------------------------------------------- #
# bucket arithmetic
# --------------------------------------------------------------------------- #

INSTANTS = np.array([
    0, 1, -1, -999, -1000, -1001, 59_999, -60_001, 1_234_567,
    _utc(1969, 12, 31, 23, 59, 59), _utc(1900, 2, 28, 12),
    _utc(1900, 3, 1), _utc(1600, 2, 29, 23, 59), _utc(2000, 2, 29, 6),
    _utc(2000, 3, 1), _utc(2024, 2, 29, 23, 59, 59, 999_000),
    _utc(2025, 12, 31, 23, 59, 59, 999_000), _utc(2026, 1, 1),
    _utc(2100, 2, 28, 1), _utc(1583, 1, 1), _utc(9999, 12, 31, 23),
], dtype=np.int64)


@pytest.mark.parametrize("name", ["SECONDS", "MINUTES", "HOURS", "DAYS",
                                  "MONTHS", "YEARS"])
def test_bucket_start_and_bounds_match_jax(name):
    rng = np.random.default_rng(hash(name) % 2**32)
    ts = np.concatenate([INSTANTS, rng.integers(-(2**42), 2**42, 200)])
    want = np.asarray(jagg.bucket_start(JDuration[name], jnp.asarray(ts)))
    got = tagg.bucket_start(Duration[name], torch.from_numpy(ts)).numpy()
    np.testing.assert_array_equal(got, want)
    for t in ts[:40].tolist():
        assert tagg.bucket_bounds(Duration[name], t) == \
            jagg.bucket_bounds(JDuration[name], t)


def test_month_and_year_buckets_against_the_calendar():
    for t in INSTANTS.tolist():
        d = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc) + \
            dt.timedelta(milliseconds=t)
        m = tagg.bucket_start(Duration.MONTHS, torch.tensor([t]))[0].item()
        y = tagg.bucket_start(Duration.YEARS, torch.tensor([t]))[0].item()
        assert m == _utc(d.year, d.month, 1)
        assert y == _utc(d.year, 1, 1)


@pytest.mark.parametrize("value", [1000, "1970-01-01 00:00:10",
                                   "1970-01-01 01:00:00 +01:00",
                                   "2026-07-15 12:30:00 -05:30"])
def test_parse_time_constant_matches_jax(value):
    assert tagg.parse_time_constant(value) == jagg.parse_time_constant(value)


def test_parse_time_constant_refusals_match():
    for bad in ("yesterday", 1.5):
        with pytest.raises(SiddhiAppCreationError) as e:
            tagg.parse_time_constant(bad)
        with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError) as w:
            jagg.parse_time_constant(bad)
        assert str(e.value) == str(w.value)


# --------------------------------------------------------------------------- #
# the shapes of tests/test_aggregations.py
# --------------------------------------------------------------------------- #

FINDS = {
    "per_sec_group_by": (
        [("IBM", 10.0, 1, 1_000), ("IBM", 20.0, 2, 1_500),
         ("IBM", 40.0, 3, 2_200), ("WSO2", 5.0, 1, 1_100)],
        ["from TradeAgg within 0, 10000 per 'sec' "
         "select symbol, avgPrice, total, n"]),
    "per_hour_rollup": (
        [("IBM", 10.0, 1, 10 * HOUR + 5), ("IBM", 30.0, 1, 10 * HOUR + 70_000),
         ("IBM", 100.0, 1, 11 * HOUR + 1)],
        ["from TradeAgg within 0, 86400000 per 'hours' "
         "select symbol, total, n"]),
    "within_filters_buckets": (
        [("A", 1.0, 1, 1 * DAY + 10), ("A", 2.0, 1, 2 * DAY + 10),
         ("A", 4.0, 1, 3 * DAY + 10)],
        [f"from TradeAgg within {2 * DAY}, {3 * DAY} per 'days' "
         "select symbol, total"]),
    "single_point_within": (
        [("A", 1.0, 1, 1 * DAY + 10), ("A", 2.0, 1, 2 * DAY + 10),
         ("A", 4.0, 1, 2 * DAY + HOUR)],
        [f"from TradeAgg within {2 * DAY + 5 * HOUR} per 'days' "
         "select symbol, total, n",
         "from TradeAgg within '1970-01-03 00:30:00' per 'hours' "
         "select symbol, total, AGG_TIMESTAMP"]),
    "further_aggregation": (
        [("A", 10.0, 1, 1_000), ("A", 20.0, 1, 2_000), ("B", 5.0, 1, 3_000)],
        ["from TradeAgg within 0, 100000 per 'sec' "
         "select symbol, sum(total) as grand group by symbol",
         "from TradeAgg within 0, 100000 per 'sec' on total > 6.0 "
         "select count() as buckets, max(total) as top"]),
    "agg_timestamp": (
        [("A", 10.0, 1, 61_000)],
        ["from TradeAgg within 0, 600000 per 'min' "
         "select AGG_TIMESTAMP, total",
         "from TradeAgg within '1970-01-01 00:00:00', '1970-01-01 01:00:00' "
         "per 'min' select *"]),
    "missing_per": ([("A", 1.0, 1, 5)], ["from TradeAgg select symbol"]),
    "unknown_duration": (
        [("A", 1.0, 1, 5)],
        ["from TradeAgg within 0, 10 per 'months' select symbol"]),
}


@pytest.mark.parametrize("shape", list(FINDS))
def test_find_shapes_match_jax(shape):
    rows, queries = FINDS[shape]
    seen = parity(APP, [("send", "TradeStream", rows)]
                  + [("query", q) for q in queries])
    assert seen and seen[0][0] == "query"


def test_out_of_order_events_merge():
    script = [("send", "TradeStream", [("A", 10.0, 1, 5_000)]),
              ("send", "TradeStream", [("A", 30.0, 1, 1_000)]),
              ("send", "TradeStream", [("A", 2.0, 1, 5_500)]),
              ("query", "from TradeAgg within 0, 10000 per 'sec' "
                        "select symbol, total, n")]
    seen = parity(APP, script, batch_size=4)
    assert sorted(r[1:] for r in seen[0][1]) == [(12.0, 2), (30.0, 1)]


def test_distinct_count_refused_with_the_same_text():
    app = """
    define stream S (k string, v double, ts long);
    define aggregation A from S
    select k, distinctCount(v) as n
    group by k aggregate by ts every sec;
    """
    seen = parity(app, [])
    assert seen[0][0] == "create" and "not supported" in seen[0][2]


def test_min_max_with_nan_and_signed_zeros():
    """XLA's scatter min/max on the CPU: NaN wins; -0.0 sorts below +0.0
    whatever the lanes' order (pinned here: the min of {0.0, -0.0} is -0.0
    and the max +0.0)."""
    app = """
    define stream S (k string, v double, ts long);
    define aggregation MM
    from S select k, min(v) as lo, max(v) as hi, sum(v) as s
    group by k aggregate by ts every sec, min;
    """
    nan = float("nan")
    rows = [("a", 5.0, 1_000), ("a", 2.0, 1_200), ("a", 9.0, 1_900),
            ("a", 7.0, 2_500), ("b", 1.0, 1_000), ("b", nan, 1_100),
            ("b", 3.0, 1_200), ("z", 0.0, 3_000), ("z", -0.0, 3_001),
            ("y", -0.0, 3_000), ("y", 0.0, 3_001), ("i", float("inf"), 4_000),
            ("i", -float("inf"), 4_001)]
    seen = parity(app, [("send", "S", rows),
                        ("query", "from MM within 0, 5000 per 'sec' "
                                  "select k, lo, hi, AGG_TIMESTAMP"),
                        ("query", "from MM within 0, 60000 per 'min' "
                                  "select k, lo, hi, s")], batch_size=4)
    by = {(r[0], r[3]): r for r in seen[0][1]}
    assert by[("a", 1000)][1:3] == (2.0, 9.0)
    assert np.isnan(by[("b", 1000)][1]) and np.isnan(by[("b", 1000)][2])
    for k in ("z", "y"):
        lo, hi = by[(k, 3000)][1:3]
        assert lo == 0.0 and np.signbit(lo) and not np.signbit(hi)


def test_capacity_pressure_evicts_oldest_buckets():
    app = """
    define stream S (k string, v double, ts long);
    define aggregation A
    from S select k, sum(v) as total
    group by k aggregate by ts every sec;
    """
    rows = [("x", 1.0, 1_000 * i) for i in range(3600)]
    seen = parity(app, [("send", "S", rows), ("check", "A"),
                        ("send", "S", [("x", 1.0, 1_000 * 3600)]),
                        ("count", "A", 0),
                        ("query", f"from A within {3_599_000}, {3_601_000} "
                                  "per 'sec' select total")],
                  group_capacity=4096, batch_size=512)
    assert seen[0][1] <= 4096 // 2 + 64 and len(seen[1][1]) == 2


def test_growth_when_eviction_cannot_help():
    app = """
    define stream S (k long, v double, ts long);
    define aggregation A
    from S select k, sum(v) as total, count() as n
    group by k aggregate by ts every sec, min;
    """
    rows = [(k, float(k % 7), 1_000 + k % 900) for k in range(3700)]
    seen = parity(app, [("send", "S", rows), ("check", "A"),
                        ("send", "S", [(1, 1.0, 1_500)]),
                        ("capacity", "A"), ("count", "A", 0),
                        ("count", "A", 1),
                        ("query", "from A within 0, 10000 per 'min' "
                                  "select k, total, n"),
                        ("query", "from A within 1000, 2000 per 'sec' "
                                  "select sum(n) as events")],
                  group_capacity=4096, batch_size=512)
    assert seen[0] == ("capacity", 8192)
    assert len(seen[3][1]) == 3700 and seen[4][1] == [(3701,)]


def test_retention_purge():
    app = """
    define stream S (k string, v double, ts long);
    @purge(enable='true', @retentionPeriod(sec='10 sec', min='1 year'))
    define aggregation A
    from S select k, sum(v) as total
    group by k aggregate by ts every sec, min;
    """
    seen = parity(app, [("send", "S", [("x", 1.0, 1_000), ("x", 2.0, 50_000)]),
                        ("heartbeat", 60_000),
                        ("query", "from A within 0, 100000 per 'sec' "
                                  "select total"),
                        ("query", "from A within 0, 100000 per 'min' "
                                  "select total"),
                        ("count", "A", 0)])
    assert seen[0][1] == [(2.0,)] and seen[1][1] == [(3.0,)]


def test_stream_join_aggregation():
    app = APP + """
    define stream QueryStream (symbol string, qts long);
    @info(name='j')
    from QueryStream join TradeAgg
    on QueryStream.symbol == TradeAgg.symbol
    per 'sec'
    select QueryStream.symbol as symbol, TradeAgg.total as total,
           TradeAgg.AGG_TIMESTAMP as bucket
    insert into Out;
    @info(name='f')
    from QueryStream as q join TradeAgg as a
    on q.symbol == a.symbol and a.n > 1
    per 'min'
    select q.symbol as symbol, a.n as n insert into Out2;
    """
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = _build(pkg, app)
        rt.start()
        h = rt.get_input_handler("TradeStream")
        for row in [("IBM", 10.0, 1, 1_000), ("IBM", 20.0, 2, 1_500),
                    ("WSO2", 5.0, 1, 1_100), ("IBM", 1.0, 1, 2_100)]:
            h.send(row)
        rt.flush()
        got = {"j": [], "f": []}
        for q in got:
            rt.add_query_callback(q, lambda ts, i, r, q=q: got[q].extend(
                tuple(e.data) for e in i or []))
        for s in ("IBM", "WSO2", "NONE"):
            rt.get_input_handler("QueryStream").send((s, 0))
        rt.flush()
        outs.append(got)
    assert_same(outs[0]["j"], outs[1]["j"])
    assert_same(outs[0]["f"], outs[1]["f"])
    assert sorted(outs[1]["j"]) == [("IBM", 1.0, 2000), ("IBM", 30.0, 1000),
                                    ("WSO2", 5.0, 1000)]
    assert outs[1]["f"] == [("IBM", 3)]


# --------------------------------------------------------------------------- #
# a seeded random feed across a year boundary
# --------------------------------------------------------------------------- #

EVERY = """@app:playback
define stream T (symbol string, price double, mag double, volume long,
                 ts long);
define aggregation R
from T
select symbol, sum(price) as total, sum(mag) as mag, avg(price) as ap,
       min(price) as lo, max(price) as hi, count() as n,
       sum(volume) as vol, min(volume) as vmin, maxForever(volume) as vmax
group by symbol
aggregate by ts every sec ... year;
"""


def _random_feed(seed, n=2048):
    rng = np.random.default_rng(seed)
    t0 = _utc(2025, 12, 31, 23, 58)
    ts = t0 + np.cumsum(rng.integers(0, 300, n))
    ts = ts[rng.permutation(n)]  # out of order
    sym = rng.choice(np.array([f"S{i}" for i in range(23)]), n)
    price = np.round(rng.normal(50.0, 30.0, n), 3)
    vol = rng.integers(-50, 1000, n)
    return [(str(s), float(p), abs(float(p)), int(v), int(t))
            for s, p, v, t in zip(sym, price, vol, ts)]


def _mag_close(want, got):
    """Rows of (symbol, total, mag, ...): total within 1e-5 of mag, the
    other floats rtol 1e-5, the rest exact."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert abs(g[1] - w[1]) <= 1e-5 * max(w[2], 1.0), (w, g)
        assert_same(w[:1] + w[2:], g[:1] + g[2:])


def test_random_feed_every_duration_across_a_year_boundary():
    rows = _random_feed(7)
    script = [("send", "T", rows[i:i + 512]) for i in range(0, 2048, 512)]
    for d in ("sec", "min", "hours", "days", "months", "years"):
        script.append(("query", f"from R within 0, {_utc(2100, 1, 1)} per "
                                f"'{d}' select symbol, total, mag, ap, lo, "
                                "hi, n, vol, vmin, vmax, AGG_TIMESTAMP"))
    want = run_script(siddhi_tpu, EVERY, script, batch_size=64)
    got = run_script(siddhi_tpu_torch, EVERY, script, batch_size=64)
    assert [w[0] for w in want] == ["query"] * 6
    for w, g in zip(want, got):
        _mag_close(w[1], g[1])
    # the year store holds both sides of the boundary
    assert {r[-1] for r in got[5][1]} == {_utc(2025, 1, 1), _utc(2026, 1, 1)}
    assert sum(r[6] for r in got[5][1]) == 2048


# --------------------------------------------------------------------------- #
# interop: a JAX aggregation state carried into the port
# --------------------------------------------------------------------------- #


def test_load_aggregation_then_more_events():
    rows = _random_feed(11, n=1024)
    first, rest = rows[:512], rows[512:]
    jrt = _build(siddhi_tpu, EVERY, batch_size=64)
    h = jrt.get_input_handler("T")
    for r in first:
        h.send(r)
    jrt.flush()
    trt = _build(siddhi_tpu_torch, EVERY, batch_size=64)
    interop.load_strings(trt, jrt.ctx.global_strings.snapshot())
    interop.load_aggregation(trt, "R",
                             jax.device_get(jrt.aggregations["R"].state))
    for rt in (jrt, trt):
        h = rt.get_input_handler("T")
        for r in rest:
            h.send(r)
        rt.flush()
    for d in ("sec", "hours", "years"):
        q = (f"from R within 0, {_utc(2100, 1, 1)} per '{d}' select "
             "symbol, total, mag, lo, hi, n, vol, vmin, vmax, AGG_TIMESTAMP")
        _mag_close([tuple(e.data) for e in jrt.query(q)],
                   [tuple(e.data) for e in trt.query(q)])
    for a, b in zip(jax.device_get(jrt.aggregations["R"].state[0].key_table),
                    trt.aggregations["R"].state[0].key_table):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_load_aggregation_refuses_a_mismatched_state():
    trt = _build(siddhi_tpu_torch, EVERY, batch_size=64)
    with pytest.raises(ValueError, match="duration stores"):
        interop.load_aggregation(trt, "R", trt.aggregations["R"].state[:2])
