"""The aggregators of siddhi_tpu_torch against the JAX package on the CPU:
the sliding extrema (kernel K8's plain versions) and the HLL sketch
(kernel K9's plain version) directly, then min/max (sliding and monotone),
minForever/maxForever, stdDev, and/or and hll:distinctCount through the
public API, in joins and patterns too, and BASELINE config 3's HLL form
with the other aggregator apps of chip_smoke.py (J-M) at a reduced size,
also against that script's numpy oracles; interop of the new states.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: extrema, counts, registers and the drop count exact (min and
max select an input); float sums and means rtol 1e-5 with atol 1e-3 for
the float32 residues of removal (tests/test_numeric_parity.py); stdDev
within 1e-4 relative plus sqrt(4 eps32) * max|value|, the float32
cancellation of sumsq/n - mean^2, whose rounding the two packages take in
another order (XLA fuses it into a multiply-add) — times sqrt(W) where
expired events carry what removal leaves of sums over W rows; an HLL
estimate within max(1, 1e-5 E), since the two packages sum the
registers' 2^-R in float32 in other orders.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops import aggregators as ja
from siddhi_tpu.ops import extrema as jx
from siddhi_tpu.query_api.definition import AttributeType
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.ops import aggregators as ta
from siddhi_tpu_torch.ops import extrema as tx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3
PRICE_MAX = 100.0
SD_RTOL = 1e-4
SD_ATOL = float(np.sqrt(4 * np.finfo(np.float32).eps)) * PRICE_MAX

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.int64: np.int64}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------- K8 plain, bit for bit


def _chunk(rng, L, kind):
    """Chunk lanes: alternating EXPIRED/CURRENT ("steady"), only EXPIRED
    lanes so every range shrinks to empty ("draining"), or random."""
    if kind == "steady":
        types = np.tile(np.array([1, 0], np.int8), L // 2)
        valid = rng.random(L) < 0.95
    elif kind == "draining":
        types = np.ones(L, np.int8)
        valid = np.ones(L, bool)
    else:
        types = rng.integers(0, 4, L).astype(np.int8)
        valid = rng.random(L) < 0.8
    return types, valid


def _values(rng, dt, n, nan):
    if dt == torch.float32:
        v = rng.integers(-60, 60, n).astype(np.float32) / 4
        if nan:
            v[rng.choice(n, 3, replace=False)] = np.nan
        return v
    return rng.integers(-(2**30), 2**30, n).astype(_NP[dt])


K8_CASES = [  # (dtype, chunk kind, expired, winlen0, NaN)
    (torch.float32, "steady", 75, 30, False),
    (torch.float32, "random", 9, 40, True),
    (torch.int32, "steady", 40, 40, False),
    (torch.int64, "draining", 131, 12, False),
    (torch.int64, "random", 0, 0, False),
]


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dt,kind,expired,winlen0,nan", K8_CASES)
@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped"])
def test_sliding_extrema_lanes_match_jax(op, dt, kind, expired, winlen0, nan,
                                         grouped):
    """A ring of C = 48 rows holding `winlen0` of them from overall index
    `expired` on (wrapped unless expired % 48 == 0), a chunk of L = 40
    lanes; grouped by three 64-bit hashes."""
    rng = np.random.default_rng(expired + winlen0 + (7 if grouped else 0))
    C, L = 48, 40
    ring = _values(rng, dt, C, nan)
    cur = _values(rng, dt, L, nan)
    types, valid = _chunk(rng, L, kind)
    jb = JBatch(ts=jnp.zeros(L, jnp.int64), cols={}, valid=jnp.asarray(valid),
                types=jnp.asarray(types))
    tb = TBatch(ts=torch.zeros(L, dtype=torch.int64), cols={},
                valid=_t(valid), types=_t(types))
    e, a = expired, expired + winlen0
    if grouped:
        keys = np.array([-(2**62) + 5, 17, 2**61 + 3], np.int64)
        rk = keys[rng.integers(0, 3, C)]
        ck = keys[rng.integers(0, 3, L)]
        want = jx.grouped_sliding_extrema_lanes(
            op, jnp.asarray(ring), jnp.asarray(rk), jnp.int64(e),
            jnp.int64(a), jb, jnp.asarray(cur), jnp.asarray(ck))
        got = tx.grouped_sliding_extrema_lanes(
            op, _t(ring), _t(rk), torch.tensor(e), torch.tensor(a), tb,
            _t(cur), _t(ck))
    else:
        want = jx.sliding_extrema_lanes(op, jnp.asarray(ring), jnp.int64(e),
                                        jnp.int64(a), jb, jnp.asarray(cur))
        got = tx.sliding_extrema_lanes(op, _t(ring), torch.tensor(e),
                                       torch.tensor(a), tb, _t(cur))
    assert got.dtype == dt
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- K9 HLL plain


def _hll_specs(arg_type):
    return (ja._make_hll_distinct_count((arg_type,)),
            ta._make_hll_distinct_count((arg_type,)))


def _assert_estimates(got, want):
    want = np.asarray(want)
    tol = np.maximum(1, 1e-5 * np.abs(want))
    assert (np.abs(np.asarray(got) - want) <= tol).all()


@pytest.mark.parametrize("n_resets", [0, 1, 3])
@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped_past_G"])
def test_hll_custom_scan_matches_jax(n_resets, grouped):
    """Three chunks through the sketch: registers and the drop count
    exact, estimates within max(1, 1e-5 E); grouped slots run past the
    capacity G = 8."""
    rng = np.random.default_rng(10 * n_resets + grouped)
    jspec, tspec = _hll_specs(AttributeType.LONG)
    G = 8
    js = jspec.init_custom(G, grouped=grouped)
    ts = tspec.init_custom(G, torch.device("cpu"), grouped=grouped)
    L = 257
    for _ in range(3):
        vals = rng.integers(0, 400, L).astype(np.int64)
        slots = (rng.integers(0, G + 3, L) if grouped
                 else np.zeros(L)).astype(np.int32)
        types = np.where(rng.random(L) < 0.2, 1, 0).astype(np.int8)
        sign = np.where(types == 1, -1, 1).astype(np.int32)
        resets = np.zeros(L, bool)
        resets[rng.choice(L, n_resets, replace=False)] = True
        valid = (rng.random(L) < 0.9) & ~resets
        js, jo = jspec.custom_scan(
            js, jnp.asarray(slots), [jnp.asarray(vals)], jnp.asarray(sign),
            jnp.asarray(valid), jnp.asarray(resets), jnp.int32(0),
            grouped=grouped)
        ts, to = tspec.custom_scan(
            ts, _t(slots), [_t(vals)], _t(sign), _t(valid), _t(resets),
            torch.tensor(0, dtype=torch.int32), grouped=grouped)
        np.testing.assert_array_equal(ts.regs.numpy(), np.asarray(js.regs))
        assert int(ts.dropped) == int(js.dropped)
        _assert_estimates(to.numpy(), jo)
    if grouped:
        assert int(ts.dropped) > 0


def test_hll_rank_of_a_zero_word_is_33():
    """rank = clz of the low 32 bits of h >> log2(m), plus one: a hash
    whose mixed bits there are all zero ranks 33, as jax.lax.clz gives."""
    # fmix64 is a bijection with fmix64(0) = 0
    j, rho = ta._hll_rank(torch.zeros(1, dtype=torch.int64), 1024)
    assert int(j) == 0 and int(rho) == 33


# ------------------------------------------------- the public API

S = ("@app:playback\n"
     "define stream S (symbol string, price double, volume long, ts long, "
     "flag bool);\n")


@pytest.fixture
def small_rings():
    """Time windows size their ring from config.default_window_capacity
    (65536) in both packages; these feeds keep a few hundred rows, and the
    plain K8 builds its structure over the whole ring each step."""
    from siddhi_tpu.core import dtypes as jd
    from siddhi_tpu_torch.core import dtypes as td
    prev = (jd.config.default_window_capacity,
            td.config.default_window_capacity)
    jd.config.default_window_capacity = 1024
    td.config.default_window_capacity = 1024
    yield
    jd.config.default_window_capacity, td.config.default_window_capacity = \
        prev


def _trades(seed, n, n_keys, step_ms=7):
    rng = np.random.default_rng(seed)
    return ({"symbol": np.array([f"s{i}" for i in rng.integers(0, n_keys, n)],
                                dtype=object),
             "price": rng.uniform(1.0, PRICE_MAX, n),
             "volume": rng.integers(1, 1000, n).astype(np.int64),
             "ts": 5_000 + (np.arange(n, dtype=np.int64) // 2) * 11,
             "flag": rng.random(n) < 0.7},
            1_000 + np.arange(n, dtype=np.int64) * step_ms)


def _feeds(cols, ts, chunk):
    return [({k: v[s:s + chunk] for k, v in cols.items()}, ts[s:s + chunk])
            for s in range(0, ts.shape[0], chunk)]


def _run(pkg, app, feeds, heartbeat=None, batch_size=32, group_capacity=64,
         stream="S", out="Out", **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=batch_size, group_capacity=group_capacity)
    got = []
    rt.add_callback(out, lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    for feed in feeds:
        s, (cols, ts) = (stream, feed) if len(feed) == 2 else (feed[0],
                                                               feed[1:])
        rt.get_input_handler(s).send_columns(cols, timestamps=ts)
        rt.flush()
    if heartbeat is not None:
        rt.heartbeat(heartbeat)
    return got


def _close(g, w, kind):
    if isinstance(kind, tuple):  # ("sd", rows a removal runs over)
        return abs(g - w) <= SD_RTOL * abs(w) + SD_ATOL * np.sqrt(kind[1])
    if kind == "sd":
        return abs(g - w) <= SD_RTOL * abs(w) + SD_ATOL
    if kind == "hll":
        return abs(g - w) <= max(1, 1e-5 * abs(w))
    if isinstance(w, float):
        return bool(np.isclose(g, w, rtol=FLOAT_RTOL, atol=FLOAT_ATOL))
    return type(g) is type(w) and g == w


def assert_same(want, got, kinds=None):
    """Event for event: timestamps, expired flags, ints and strings
    exact; `kinds` maps a column index to the "sd" (or ("sd", W) with
    removal over W rows) or "hll" tolerance."""
    kinds = kinds or {}
    assert len(got) == len(want)
    for i, ((wt, wd, we), (gt, gd, ge)) in enumerate(zip(want, got)):
        assert (gt, ge) == (wt, we), i
        for c, (w, g) in enumerate(zip(wd, gd)):
            assert _close(g, w, kinds.get(c)), (i, c, w, g)


def parity(app, feeds, kinds=None, heartbeat=None, **kw):
    want = _run(siddhi_tpu, app, feeds, heartbeat=heartbeat, **kw)
    got = _run(siddhi_tpu_torch, app, feeds, heartbeat=heartbeat,
               device="cpu", **kw)
    assert_same(want, got, kinds)
    assert want
    return got


SLIDING = {
    "length": "length(40)",
    "time": "time(200)",
    "timeLength": "timeLength(200, 30)",
    "externalTime": "externalTime(ts, 150)",
}


@pytest.mark.parametrize("window", sorted(SLIDING))
@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped"])
def test_sliding_min_max_parity(window, grouped, small_rings):
    """Removal-capable min/max (K8) over the four sliding windows; with
    sum/count beside them (fused scans) and expired events out too."""
    key = "symbol, " if grouped else ""
    app = S + (f"@info(name = 'q') from S#window.{SLIDING[window]} "
               f"select {key}max(price) as hi, min(volume) as lo, "
               f"min(price) as lp, sum(volume) as v, count() as n "
               + ("group by symbol " if grouped else "")
               + "insert all events into Out;")
    cols, ts = _trades(21, 160, 5)
    parity(app, _feeds(cols, ts, 37), heartbeat=int(ts[-1]) + 10_000)


SLIDING_MINMAX_SHAPES = [
    # tests/test_sliding_minmax.py: (query, rows of (price, volume, ts))
    ("from S#window.length(3) select min(price) as mn insert into Out;",
     [(p, i, i) for i, p in enumerate([5.0, 1.0, 7.0, 9.0, 8.0, 2.0])]),
    ("from S#window.length(2) select max(price) as mx insert into Out;",
     [(p, i, i) for i, p in enumerate([5.0, 9.0, 1.0, 3.0, 2.0])]),
    ("from S#window.time(5 sec) select min(price) as mn insert into Out;",
     [(1.0, 0, 1_000), (4.0, 1, 2_000), (9.0, 2, 6_500)]),
    ("from S#window.length(4) select min(volume) as mn insert into Out;",
     [(1.0, v, i) for i, v in enumerate([7, 3, 9, 5, 8, 6])]),
    ("from S#window.lengthBatch(3) select min(price) as mn insert into Out;",
     [(p, i, i) for i, p in enumerate([5.0, 1.0, 7.0])]),
]


@pytest.mark.parametrize("query,rows", SLIDING_MINMAX_SHAPES,
                         ids=["length_min", "length_max", "time_min",
                              "carry_across_batches", "lengthBatch_min"])
def test_sliding_minmax_reference_shapes(query, rows):
    """The shapes of tests/test_sliding_minmax.py, one event a batch."""
    feeds = [({"symbol": np.array(["s"], dtype=object),
               "price": np.array([p]), "volume": np.array([v], np.int64),
               "ts": np.array([t], np.int64),
               "flag": np.array([True])}, np.array([t], np.int64))
             for p, v, t in rows]
    parity(S + "@info(name = 'q') " + query, feeds, batch_size=2)


@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped"])
def test_batch_window_min_max_and_stddev(grouped):
    """min/max over lengthBatch are monotone scans with resets (K5b),
    int32 and int64 included; stdDev and avg fused (K5)."""
    key = "symbol, " if grouped else ""
    app = S + ("define stream T (symbol string, v int, price double);\n"
               f"@info(name = 'q') from T#window.lengthBatch(25) "
               f"select {key}max(v) as hv, min(v) as lv, max(price) as hp, "
               f"avg(price) as a, stdDev(price) as sd "
               + ("group by symbol " if grouped else "")
               + "insert all events into Out;")
    rng = np.random.default_rng(4)
    n = 130
    cols = {"symbol": np.array([f"s{i}" for i in rng.integers(0, 4, n)],
                               dtype=object),
            "v": rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
            "price": rng.uniform(1, PRICE_MAX, n)}
    ts = 1_000 + np.arange(n, dtype=np.int64)
    feeds = [("T", c, t) for c, t in _feeds(cols, ts, 29)]
    # expired events carry the sums' removal residues over 25 rows
    parity(app, feeds, kinds={5 if grouped else 4: ("sd", 25)})


def test_min_max_forever_across_resets():
    """minForever/maxForever survive the batch window's RESET; min/max
    restart at every flush."""
    app = S + ("@info(name = 'q') from S#window.lengthBatch(12) "
               "select minForever(price) as a, maxForever(volume) as b, "
               "min(price) as c, max(volume) as d insert into Out;")
    cols, ts = _trades(5, 100, 3)
    got = parity(app, _feeds(cols, ts, 23))
    assert len({g[1][0] for g in got}) > 1


def test_stddev_reference_shapes():
    """The stdDev cases of tests/test_numeric_parity.py: over a
    lengthBatch, over a sliding window with removal, grouped."""
    rng = np.random.default_rng(14)
    q = ("define stream D (k string, v double);\n@info(name = 'q') "
         "from D#window.{} select {}stdDev(v) as sd, avg(v) as a {}"
         "insert into Out;")
    vals = rng.uniform(-50.0, 50.0, 300)
    for win, key, grp, data in (
            ("lengthBatch(300)", "", "", [("a", v) for v in vals]),
            ("length(3)", "", "", [("a", v) for v in (1.0, 5.0, 9.0, 13.0)]),
            ("lengthBatch(6)", "k, ", "group by k ",
             [("a", 1.0), ("b", 10.0), ("a", 3.0), ("b", 30.0), ("a", 5.0),
              ("b", 50.0)])):
        cols = {"k": np.array([d[0] for d in data], dtype=object),
                "v": np.array([d[1] for d in data])}
        ts = 1_000 + np.arange(len(data), dtype=np.int64)
        feeds = [("D", c, t) for c, t in _feeds(cols, ts, 128)]
        parity(q.format(win, key, grp), feeds, batch_size=128,
               kinds={0 if not key else 1: ("sd", 3) if "length(" in win
                      else "sd"})


def test_and_or_parity():
    app = S + ("@info(name = 'q') from S#window.length(6) "
               "select and(flag) as a, or(price > 90.0) as o, "
               "and(price > 5.0) as b insert all events into Out;")
    cols, ts = _trades(6, 120, 4)
    parity(app, _feeds(cols, ts, 31))


HLL_SHAPES = [
    # tests/test_hll.py
    ("define stream H (v long);\n@info(name='q') from H "
     "select hll:distinctCount(v) as d insert into Out;",
     lambda rng: np.repeat(rng.choice(10**12, 3000, replace=False), 2), 512),
    ("define stream H (v int);\n@info(name='q') from H "
     "select hll:distinctCount(v) as d insert into Out;",
     lambda rng: (np.arange(500) % 37).astype(np.int32), 512),
    ("define stream H (v int);\n@info(name='q') from H#window.lengthBatch(100)"
     " select hll:distinctCount(v) as d insert into Out;",
     lambda rng: np.r_[np.arange(100), np.zeros(100)].astype(np.int32), 100),
    ("define stream H (v int);\n@info(name='q') from H#window.lengthBatch(3) "
     "select hll:distinctCount(v) as d insert into Out;",
     lambda rng: np.array([1, 2, 3, 101, 102, 103], np.int32), 8),
]


@pytest.mark.parametrize("app,make,batch", HLL_SHAPES,
                         ids=["accuracy", "linear_counting", "reset",
                              "two_flushes_in_a_chunk"])
def test_hll_reference_shapes(app, make, batch):
    vals = make(np.random.default_rng(21))
    ts = 1_000 + np.arange(vals.shape[0], dtype=np.int64)
    feeds = [("H", {"v": c["v"]}, t)
             for c, t in _feeds({"v": vals}, ts, batch)]
    parity(app, feeds, kinds={0: "hll"}, batch_size=batch)


def test_hll_grouped_string_args_past_group_capacity():
    """Grouped by a string over a lengthBatch with more groups than
    config.hll_group_capacity allows: slots past it emit 0, as in JAX."""
    from siddhi_tpu.core import dtypes as jd
    from siddhi_tpu_torch.core import dtypes as td
    app = ("define stream H (k string, v string);\n@info(name='q') "
           "from H#window.lengthBatch(60) select k, hll:distinctCount(v) as d"
           " group by k insert into Out;")
    rng = np.random.default_rng(22)
    n = 240
    cols = {"k": np.array([f"k{i}" for i in rng.integers(0, 6, n)],
                          dtype=object),
            "v": np.array([f"u{i}" for i in rng.integers(0, 50, n)],
                          dtype=object)}
    ts = 1_000 + np.arange(n, dtype=np.int64)
    feeds = [("H", c, t) for c, t in _feeds(cols, ts, 64)]
    prev = (jd.config.hll_group_capacity, td.config.hll_group_capacity)
    jd.config.hll_group_capacity = td.config.hll_group_capacity = 5
    try:
        got = parity(app, feeds, kinds={1: "hll"}, batch_size=64)
    finally:
        jd.config.hll_group_capacity, td.config.hll_group_capacity = prev
    assert any(g[1][1] == 0 for g in got)


def test_min_max_refused_over_a_delay_window():
    app = S + ("@info(name = 'q') from S#window.delay(1 sec) "
               "select min(price) as mn insert into Out;")
    for pkg, err in ((siddhi_tpu, siddhi_tpu.errors.SiddhiAppCreationError),
                     (siddhi_tpu_torch, SiddhiAppCreationError)):
        mgr = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
               else pkg.SiddhiManager())
        with pytest.raises(err, match=r"over #window.delay is not "
                                      r"supported \(delay re-emits"):
            mgr.create_siddhi_app_runtime(app)


def test_union_set_is_not_yet_ported():
    """A raw unionSet runs: its live sets match the JAX package's
    (tests/test_torch_builtins.py covers the set idioms)."""
    app = S + ("@info(name = 'q') from S#window.length(3) "
               "select unionSet(symbol) as u insert into Out;")
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
              else pkg.SiddhiManager()).create_siddhi_app_runtime(app)
        got = []
        rt.add_query_callback("q", lambda ts, i, r, got=got: got.extend(
            e.data[0] for e in i or []))
        h = rt.get_input_handler("S")
        for k, sym in enumerate("abcab"):
            h.send((sym, 1.0, 1, k, True), timestamp=k)
            rt.flush()
        outs.append(got)
    assert outs[1] == outs[0] == [{"a"}, {"a", "b"}, {"a", "b", "c"},
                                  {"a", "b", "c"}, {"a", "b", "c"}]


# ------------------------------------------------- joins and patterns

KV = ("define stream L (k int, v double);\n"
      "define stream R (k int, v double);\n")


def _kv_feeds(seed, rounds, n):
    rng = np.random.default_rng(seed)
    feeds, t = [], 1_000
    for _ in range(rounds):
        for s in ("L", "R"):
            cols = {"k": rng.integers(1, 5, n).astype(np.int32),
                    "v": rng.uniform(0, PRICE_MAX, n)}
            feeds.append((s, cols, t + 3 * np.arange(n, dtype=np.int64)))
            t += 3 * n
    return feeds


def test_max_in_a_join():
    """A join's selector takes the monotone path (no sliding window)."""
    app = KV + ("@info(name = 'q') from L#window.length(8) as a "
                "join R#window.length(8) as b on a.k == b.k "
                "select a.k as k, max(b.v) as mx, minForever(a.v) as mn "
                "group by a.k insert into Out;")
    parity(app, _kv_feeds(31, 5, 7))


def test_max_in_a_pattern():
    app = KV + ("@info(name = 'q') from every a=L -> b=R[b.k == a.k] "
                "select a.k as k, max(b.v) as mx, stdDev(a.v) as sd "
                "insert into Out;")
    parity(app, _kv_feeds(32, 5, 6), kinds={2: "sd"})


# ------------------------------------------------- apps J-M


@pytest.mark.parametrize("name", ["J", "K", "L", "M"])
def test_aggregator_apps_match_jax_and_the_oracle(name, small_rings):
    """chip_smoke.py's apps J-M at 4 rounds of 512 with windows cut to the
    data (300 ms, 700 events, 100 ms buckets): the port against the JAX
    package event for event, and against the script's numpy oracle."""
    cs = _chip_smoke()
    rounds, batch = 4, 512
    sizes = {"J": 300, "K": 300, "L": 700, "M": 100}
    text, n_sym, _ = cs.agg_apps_plan(sizes)[name]
    sym, price, volume, ts = cs.agg_events(np.random.default_rng(8), n_sym,
                                           rounds, batch)
    pool = cs.symbols(n_sym)
    cols = {"symbol": pool[sym], "price": price, "volume": volume}
    feeds = [("TradeStream", c, t) for c, t in _feeds(cols, ts, batch)]
    kinds = {"J": {0: "hll"}, "M": {4: "sd"}}.get(name)
    parity(text, feeds, kinds=kinds, batch_size=batch, group_capacity=4096,
           out="OutStream")
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(text, batch_size=batch,
                                   group_capacity=4096)
    got = []
    rt.add_callback("OutStream", got.extend)
    h = rt.get_input_handler("TradeStream")
    for _, c, t in feeds:
        h.send_columns(c, timestamps=t)
        rt.flush()
    check = cs.expect_agg_app(name, sym, price, volume, ts, sizes[name],
                              rounds, batch, pool)
    assert check(got) == len(got) > 0


# ------------------------------------------------- interop


INTEROP_APPS = {
    "hll": ("from S#window.lengthBatch(20) select symbol, "
            "hll:distinctCount(volume) as d group by symbol "
            "insert into Out;", {1: "hll"}),
    "monotone": ("from S#window.lengthBatch(15) select symbol, "
                 "max(price) as hi, minForever(volume) as mf, "
                 "stdDev(price) as sd group by symbol insert into Out;",
                 {3: "sd"}),
    "timeBatch": ("from S#window.timeBatch(60) select symbol, "
                  "max(price) as hi, count() as n group by symbol "
                  "insert all events into Out;", None),
    "sliding": ("from S#window.time(90) select symbol, min(price) as lo, "
                "maxForever(price) as top group by symbol "
                "insert into Out;", None),
}


@pytest.mark.parametrize("name", sorted(INTEROP_APPS))
def test_interop_continues_jax_aggregator_state(name, small_rings):
    """HLLState, the monotone and forever GroupStates and a time-batch
    window's BatchState carried from a running JAX app into the port."""
    query, kinds = INTEROP_APPS[name]
    app = S + "@info(name = 'q') " + query
    cols, ts = _trades(13, 200, 6)
    feeds = _feeds(cols, ts, 32)
    head, tail = feeds[:3], feeds[3:]

    def feed(rt, out, fs):
        h = rt.get_input_handler("S")
        for c, t in fs:
            h.send_columns(c, timestamps=t)
            rt.flush()

    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        app, batch_size=32, group_capacity=64)
    jout = []
    jrt.add_callback("Out", lambda evs: jout.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    feed(jrt, jout, head)
    jstate = jax.device_get(jrt.query_runtimes["q"].state)
    strings = list(jrt.ctx.global_strings._to_str)
    n_head = len(jout)

    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app, batch_size=32, group_capacity=64)
    interop.load_app_state(trt, {"q": jstate}, strings)
    trt.ctx.timestamp_generator.observe_event_time(int(head[-1][1][-1]))
    tout = []
    trt.add_callback("Out", lambda evs: tout.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    feed(jrt, jout, tail)
    feed(trt, tout, tail)
    assert len(jout) > n_head
    assert_same(jout[n_head:], tout, kinds)
