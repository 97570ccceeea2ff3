"""The session windows (plain and keyed) and the sort window of
siddhi_tpu_torch against the JAX package on the CPU: the plain K7 argsort
against jnp.argsort on the JAX `_sort_chunk` keys and on `_rank_key`'s
float keys, each window operator alone (every emitted lane and the whole
state), the three windows through the public API on seeded random feeds,
the keyed-session shapes of tests/test_windows_extra.py and the key-drop
counter of tests/test_overflow.py, and interop of a mid-run state.

Inputs are made with numpy from a seed and handed to both packages. Orders,
strings, longs, timestamps and event types must be equal; floats within
rtol 1e-5 (float32 accumulation order, tests/test_numeric_parity.py) plus
atol 1e-3 for what removal leaves of a float32 sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import dtypes as jdtypes
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops import windows as jw
from siddhi_tpu.ops import windows_extra as jwx
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import dtypes as tdtypes
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops import search, windows as tw
from siddhi_tpu_torch.ops import windows_extra as twx

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3

LAYOUT_J = {"symbol": jnp.int32, "price": jnp.float32, "volume": jnp.int64}
LAYOUT_T = {"symbol": torch.int32, "price": torch.float32,
            "volume": torch.int64}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------- K7, plain


@pytest.mark.parametrize("B,width_of", [(64, "session"), (512, "session"),
                                        (64, "sort")])
def test_k7_plain_matches_the_jax_sort_chunk_order(B, width_of):
    """The JAX `_sort_chunk` order — invalid lanes set to BIG, stable,
    trimmed — against K7 with invalid lanes set to the static bound 4B+3:
    keys of the windows' form (trigger * 4 + kind, many ties)."""
    rng = np.random.default_rng(B)
    L = 3 * B if width_of == "session" else 2 * B + 37
    width = 2 * B if width_of == "session" else L
    keys = (rng.integers(0, B + 1, L) * 4
            + rng.choice([0, 2], L)).astype(np.int64)
    valid = rng.random(L) < 0.6
    want = np.asarray(jnp.argsort(jnp.where(valid, keys, jw.BIG),
                                  stable=True)[:width])
    bound = tw._chunk_key_bound(B)
    k = torch.where(_t(valid), _t(keys), bound).to(torch.int32)
    got = search.stable_radix_argsort(k, bound, width, counter="K7 rank")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _float_keys(rng, n, planted=True):
    x = rng.integers(-4, 5, n).astype(np.float64) * 0.5  # many ties
    if planted:
        for v in (0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf):
            x[rng.integers(0, n, 3)] = v
    return x


@pytest.mark.parametrize("sort_keys", [
    [("price", 1)], [("price", -1)], [("price", -1), ("volume", 1)],
    [("volume", -1), ("symbol", 1)]],
    ids=["asc", "desc", "desc_then_asc", "long_then_string"])
def test_k7_plain_matches_the_jax_rank_key(sort_keys):
    """SortWindow._rank_key: successive stable argsorts of float64 keys
    (ties, -0.0, NaN and ±inf planted, desc negated), then the valid
    partition, against the JAX method on the same columns."""
    rng = np.random.default_rng(len(sort_keys) + 7 * (sort_keys[0][1] < 0))
    M = 300
    cols = {"symbol": rng.integers(1, 5, M).astype(np.int32),
            "price": _float_keys(rng, M).astype(np.float32),
            "volume": rng.integers(-3, 3, M).astype(np.int64)}
    valid = rng.random(M) < 0.8
    jwin = jw.SortWindow(LAYOUT_J, 8, 10, sort_keys)
    twin = tw.SortWindow(LAYOUT_T, 8, 10, sort_keys)
    want = np.asarray(jwin._rank_key(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(valid)))
    got = twin._rank_key({k: _t(v) for k, v in cols.items()}, _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
def test_float64_sort_key_orders_as_jnp_argsort(descending):
    x = _float_keys(np.random.default_rng(3), 500)
    x[:8] = [0.0, -0.0, np.nan, 1.0, -np.nan, -np.inf, 0.0, -1.0]
    x[8:10] = [5e-324, -5e-324]  # subnormals compare as zero in XLA
    want = np.asarray(jnp.argsort(jnp.asarray(-x if descending else x),
                                  stable=True))
    got = search.stable_radix_argsort(
        search.float64_sort_key(_t(x), descending), counter="K7 rank")
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- the operators alone


def _batches(rng, B, rounds, gap_ms, n_keys=5):
    """Batches with bursts and idle jumps past the gap, some short and one
    empty (a heartbeat's)."""
    t = 1_000
    out = []
    for r in range(rounds):
        n = 0 if r == 3 else int(rng.integers(1, B + 1))
        steps = np.where(rng.random(B) < 0.15,
                         rng.integers(gap_ms + 1, 3 * gap_ms, B),
                         rng.integers(0, gap_ms // 3, B))
        stamps = t + np.cumsum(steps)
        cols = {"symbol": rng.integers(0, n_keys, B).astype(np.int32),
                "price": rng.integers(1, 9, B).astype(np.float32),
                "volume": rng.integers(0, 100, B).astype(np.int64)}
        valid = np.arange(B) < n
        now = int(stamps[n - 1]) if n else t + 2 * gap_ms
        t = now + 1
        out.append((stamps, cols, valid, now))
    return out


def _pair(stamps, cols, valid):
    B = stamps.shape[0]
    jb = JBatch(ts=jnp.asarray(stamps),
                cols={k: jnp.asarray(v) for k, v in cols.items()},
                valid=jnp.asarray(valid), types=jnp.zeros(B, jnp.int8))
    tb = TBatch(ts=_t(stamps), cols={k: _t(v) for k, v in cols.items()},
                valid=_t(valid), types=torch.zeros(B, dtype=torch.int8))
    return jb, tb


def _same_lanes(jc, tc):
    """Valid lanes come first, in emission order, in both chunks."""
    nv = int(np.asarray(jc.valid).sum())
    jv = np.asarray(jc.valid)
    jidx = np.nonzero(jv)[0]
    assert int(tc.valid.sum()) == nv and bool(tc.valid[:nv].all())
    np.testing.assert_array_equal(tc.ts[:nv].numpy(), np.asarray(jc.ts)[jidx])
    np.testing.assert_array_equal(tc.types[:nv].numpy(),
                                  np.asarray(jc.types)[jidx])
    for k in LAYOUT_T:
        np.testing.assert_array_equal(tc.cols[k][:nv].numpy(),
                                      np.asarray(jc.cols[k])[jidx], k)
    return nv


def _ring_eq(t_ring, j_ring):
    np.testing.assert_array_equal(t_ring[:-1].numpy(), np.asarray(j_ring))


def test_session_window_step_and_state_match_jax():
    rng = np.random.default_rng(21)
    B, C, gap = 32, 96, 30
    jwin = jw.SessionWindow(LAYOUT_J, B, gap, capacity=C)
    twin = tw.SessionWindow(LAYOUT_T, B, gap, capacity=C)
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    emitted = 0
    for stamps, cols, valid, now in _batches(rng, B, 8, gap):
        jb, tb = _pair(stamps, cols, valid)
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        emitted += _same_lanes(jc, tc)
        for f in ("appended", "flushed", "last_ts", "session", "has_events"):
            assert int(getattr(ts_, f)) == int(getattr(js, f)), f
        _ring_eq(ts_.ring_ts, js.ring_ts)
        _ring_eq(ts_.ring_session, js.ring_session)
        jlive = np.asarray(jwin.contents(js, jnp.int64(now))[2])
        np.testing.assert_array_equal(twin.contents(ts_, now)[2].numpy(),
                                      jlive)
    assert emitted > 2 * B and int(js.session) > 2


def test_sort_window_step_and_state_match_jax():
    rng = np.random.default_rng(22)
    B, N = 32, 20
    keys = [("price", -1), ("volume", 1)]
    jwin = jw.SortWindow(LAYOUT_J, B, N, keys)
    twin = tw.SortWindow(LAYOUT_T, B, N, keys)
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    for stamps, cols, valid, now in _batches(rng, B, 7, 30):
        jb, tb = _pair(stamps, cols, valid)
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        _same_lanes(jc, tc)
        for f in ("ts", "seq", "valid", "count"):
            np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        for k in LAYOUT_T:
            np.testing.assert_array_equal(ts_.cols[k].numpy(),
                                          np.asarray(js.cols[k]), k)
    assert int(js.count) > N


@pytest.mark.parametrize("C", [64, 256], ids=["ring_wraps", "roomy_ring"])
def test_keyed_session_window_step_and_state_match_jax(C):
    """With C = 64 the ring wraps over rows not yet emitted (the JAX
    package's documented overwrite); keys past K = 6 are dropped."""
    rng = np.random.default_rng(23 + C)
    B, gap = 32, 30
    from siddhi_tpu.query_api.definition import AttributeType as JA
    from siddhi_tpu_torch.query_api.definition import AttributeType as TA
    prev = (jdtypes.config.session_key_capacity,
            tdtypes.config.session_key_capacity)
    jdtypes.config.session_key_capacity = 6
    tdtypes.config.session_key_capacity = 6
    try:
        jl = jw.make_layout({"symbol": JA.INT, "price": JA.FLOAT,
                             "volume": JA.LONG})
        tl = tw.make_layout({"symbol": TA.INT, "price": TA.FLOAT,
                             "volume": TA.LONG})
        jwin = jwx.KeyedSessionWindow(jl, B, gap, "symbol", capacity=C)
        twin = twx.KeyedSessionWindow(tl, B, gap, "symbol", capacity=C)
    finally:
        (jdtypes.config.session_key_capacity,
         tdtypes.config.session_key_capacity) = prev
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    for stamps, cols, valid, now in _batches(rng, B, 9, gap, n_keys=8):
        jb, tb = _pair(stamps, cols, valid)
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        # an unsorted chunk: lane for lane
        for f in ("valid", "types"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)), f)
        v = np.asarray(jc.valid)
        np.testing.assert_array_equal(tc.ts.numpy()[v], np.asarray(jc.ts)[v])
        for k in LAYOUT_T:
            np.testing.assert_array_equal(tc.cols[k].numpy()[v],
                                          np.asarray(jc.cols[k])[v], k)
        for f in ("appended", "dropped"):
            assert int(getattr(ts_, f)) == int(getattr(js, f)), f
        for f in ("last_ts", "sess", "has"):
            np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        for f in ("ring_ts", "ring_key", "ring_sess", "ring_emitted"):
            _ring_eq(getattr(ts_, f), getattr(js, f))
        jlive = np.asarray(jwin.contents(js, jnp.int64(now))[2])
        np.testing.assert_array_equal(twin.contents(ts_, now)[2].numpy(),
                                      jlive)
    assert int(js.dropped) > 0


# ------------------------------------------------------------- the apps

S = ("@app:playback\n"
     "define stream S (symbol string, price double, volume long, k int);\n")

APPS = {
    "session_all": "from S#window.session(40) select symbol, price, volume "
                   "insert all events into Out;",
    "session_groupby": "from S#window.session(40) select symbol, "
                       "sum(price) as t, count() as n group by symbol "
                       "insert all events into Out;",
    "session_minmax": "from S#window.session(40) select max(price) as hi, "
                      "min(volume) as lo, count() as n insert into Out;",
    "keyed_all": "from S#window.session(40, symbol) select symbol, price, "
                 "volume insert all events into Out;",
    "keyed_int_groupby": "from S#window.session(25, k) select k, "
                         "sum(volume) as v, count() as n group by k "
                         "insert all events into Out;",
    "keyed_minmax": "from S#window.session(40, symbol) select symbol, "
                    "max(price) as hi, min(price) as lo group by symbol "
                    "insert into Out;",
    "sort_desc_all": "from S#window.sort(40, price, 'desc', volume) "
                     "select symbol, price, volume "
                     "insert all events into Out;",
    "sort_asc_groupby": "from S#window.sort(25, volume, 'asc') select "
                        "symbol, sum(price) as t, count() as n group by "
                        "symbol insert all events into Out;",
    "sort_minmax": "from S#window.sort(30, symbol) select max(price) as hi,"
                   " min(volume) as lo insert all events into Out;",
}


def _feeds(seed, rounds=4, n=512, gap=40):
    """`rounds` sends of n events: bursts 1-3 ms apart with idle jumps past
    the gap; prices and volumes with ties."""
    rng = np.random.default_rng(seed)
    t = 1_000
    feeds = []
    for _ in range(rounds):
        steps = np.where(rng.random(n) < 0.02,
                         rng.integers(gap + 1, 4 * gap, n),
                         rng.integers(0, 4, n))
        ts = t + np.cumsum(steps)
        t = int(ts[-1]) + 1
        cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 7, n)],
                                   dtype=object),
                "price": rng.integers(1, 60, n) * 0.5,
                "volume": rng.integers(1, 40, n).astype(np.int64),
                "k": rng.integers(0, 9, n).astype(np.int32)}
        feeds.append((cols, ts))
    return feeds


def _run(pkg, app, feeds, heartbeats=(), batch_size=512, out="Out", **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=batch_size, group_capacity=64)
    got = []
    rt.add_callback(out, lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    for cols, ts in feeds:
        rt.get_input_handler("S").send_columns(cols, timestamps=ts)
        rt.flush()
    for hb in heartbeats:
        rt.heartbeat(hb)
    return got


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


@pytest.mark.parametrize("name", sorted(APPS))
def test_window_app_parity(name):
    """4 rounds of 512 through the public API, closing heartbeats past
    the last gap so the final sessions expire."""
    feeds = _feeds(31 + len(name))
    end = int(feeds[-1][1][-1])
    app = S + "@info(name = 'q') " + APPS[name]
    hbs = (end + 20, end + 500)
    want = _run(siddhi_tpu, app, feeds, hbs)
    got = _run(siddhi_tpu_torch, app, feeds, hbs, device="cpu")
    assert_same(want, got)
    assert len(want) > 512
    if "all events" in APPS[name]:
        # expired rows come out beside the 2048 currents
        assert len(want) > 4 * 512


@pytest.mark.parametrize("side", ["session(30)", "session(30, k)",
                                  "sort(6, v, 'desc')"],
                         ids=["session", "keyed_session", "sort"])
def test_window_as_a_join_side(side):
    """A join probes each window's current contents (`contents`): the open
    session, the open keyed sessions, the kept top-N."""
    app = ("@app:playback\ndefine stream L (k int, v double);\n"
           "define stream R (k int, v double);\n@info(name = 'q') "
           f"from L#window.{side} as a join R#window.length(6) as b "
           "on a.k == b.k select a.k as k, a.v as av, b.v as bv "
           "insert into Out;")
    rng = np.random.default_rng(8)
    feeds, t = [], 1_000
    for _ in range(8):
        for stream in ("L", "R"):
            n = 9
            cols = {"k": rng.integers(1, 4, n).astype(np.int32),
                    "v": rng.integers(0, 20, n).astype(np.float64)}
            gaps = np.where(rng.random(n) < 0.2, 40, 3)
            feeds.append((stream, cols, t + np.cumsum(gaps)))
            t = int(feeds[-1][2][-1]) + 1
    outs = []
    for pkg, kw in ((siddhi_tpu, {}), (siddhi_tpu_torch, {"device": "cpu"})):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            app, batch_size=16)
        got = []
        rt.add_callback("Out", lambda evs, g=got: g.extend(
            (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
        for stream, cols, ts in feeds:
            rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
            rt.flush()
        outs.append(got)
    assert_same(*outs)
    assert len(outs[0]) > 20


# ----------------------------------- tests/test_windows_extra.py shapes

KS = ("@app:playback\n"
      "define stream S (symbol string, price float, volume long);\n")


def _keyed(pkg, sends, **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        KS + "@info(name='q') from S#window.session(2 sec, symbol) "
        "select symbol, price insert all events into Out;", batch_size=4)
    got = []
    rt.add_query_callback("q", lambda ts, i, r: got.append(
        ([tuple(e.data[:2]) for e in i or []],
         [tuple(e.data[:2]) for e in r or []])))
    h = rt.get_input_handler("S")
    for step in sends:
        if isinstance(step, int):
            rt.heartbeat(step)
            continue
        for row, ts in step:
            h.send(row, timestamp=ts)
        rt.flush()
    return got


@pytest.mark.parametrize("shape", ["close_independently", "in_batch_gap"])
def test_keyed_session_shapes(shape):
    if shape == "close_independently":
        sends = [[(("a", 1.0, 0), 1_000), (("b", 2.0, 0), 1_500),
                  (("a", 3.0, 0), 2_000)],
                 [(("b", 4.0, 0), 3_400)], [(("b", 5.0, 0), 4_600)],
                 4_700, 7_000]
        expired = [("a", 1.0), ("a", 3.0), ("b", 2.0), ("b", 4.0),
                   ("b", 5.0)]
    else:
        sends = [[(("a", 1.0, 0), 1_000), (("b", 2.0, 0), 1_100),
                  (("a", 9.0, 0), 5_000)]]
        expired = [("a", 1.0), ("b", 2.0)]
    want = _keyed(siddhi_tpu, sends)
    got = _keyed(siddhi_tpu_torch, sends, device="cpu")
    assert got == want
    assert sorted(e for _, r in got for e in r) == expired
    if shape == "in_batch_gap":
        currents = [e for i, _ in got for e in i]
        assert ("a", 9.0) in currents and ("b", 2.0) in currents


def test_keyed_session_key_drops_are_counted_as_in_jax():
    """tests/test_overflow.py::TestSessionKeyOverflow: keys 0..15 into a
    4-key session table; the drops reach Statistics.overflow through
    collect_overflow under the JAX name."""
    app = ("define stream S (k int, v double);\n@info(name='s') "
           "from S#window.session(1 sec, k) select k, sum(v) as total "
           "insert into Out;")
    overs = []
    for pkg, cfg, kw in ((siddhi_tpu, jdtypes.config, {}),
                         (siddhi_tpu_torch, tdtypes.config,
                          {"device": "cpu"})):
        prev = cfg.session_key_capacity
        cfg.session_key_capacity = 4
        try:
            rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
                app, batch_size=16)
        finally:
            cfg.session_key_capacity = prev
        h = rt.get_input_handler("S")
        for i in range(16):
            h.send((i, 1.0), timestamp=1000 + i)
        rt.flush()
        rt.collect_overflow()
        overs.append(dict(rt.ctx.statistics.overflow))
        rt.shutdown()
    assert overs[1] == overs[0]
    assert overs[1]["query:s.session_key_dropped"] >= 12


# -------------------------------------------------------------- interop


@pytest.mark.parametrize("name", ["session_groupby", "keyed_all",
                                  "sort_desc_all"])
def test_interop_continues_a_jax_window_state(name):
    """A SessionState, KeyedSessionState or SortState carried mid-run from
    the JAX app into the port: the next rounds give the same events."""
    app = S + "@info(name = 'q') " + APPS[name]
    feeds = _feeds(41, rounds=4, n=64)
    head, tail = feeds[:2], feeds[2:]

    def feed(rt, fs):
        for cols, ts in fs:
            rt.get_input_handler("S").send_columns(cols, timestamps=ts)
            rt.flush()

    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        app, batch_size=64, group_capacity=64)
    jout = []
    jrt.add_callback("Out", lambda evs: jout.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    feed(jrt, head)
    jstate = jax.device_get(jrt.query_runtimes["q"].state)
    n_head = len(jout)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app, batch_size=64, group_capacity=64)
    interop.load_app_state(trt, {"q": jstate},
                           list(jrt.ctx.global_strings._to_str))
    trt.ctx.timestamp_generator.observe_event_time(int(head[-1][1][-1]))
    tout = []
    trt.add_callback("Out", lambda evs: tout.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    feed(jrt, tail)
    feed(trt, tail)
    assert len(jout) > n_head
    assert_same(jout[n_head:], tout)


def test_a_session_step_past_b_plus_e_lanes_emits_every_row():
    """chip_smoke.py's app S cut to 50 ms sessions and 4 rounds of 1024:
    bursts of 20-900 events 1 ms apart, idle jumps of 60-200 ms. Where a
    step's expired rows and currents outnumber B + E lanes, the JAX
    session window keeps the first B + E of its chunk and loses the rest
    (its events fall short of chip_smoke.py's oracle); the port keeps
    every lane, as the oracle does (ROADMAP.md, Queue 3)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rounds, batch = 4, 1024
    cs.GAP_S, cs.S_BURST, cs.S_JUMP = 50, (20, 900), (60, 200)
    text = cs.APP_S.replace("session(5 sec)", "session(50 millisec)")
    sym, price, volume, ts = cs.session_events(np.random.default_rng(5),
                                               rounds, batch)
    cols = {"symbol": cs.symbols(30)[sym % 30], "price": price,
            "volume": volume}
    oi = cs.oracle_s(ts, batch)
    expect = [("symbol", cols["symbol"][oi].tolist(), False),
              ("price", price.astype(np.float32)[oi].astype(np.float64),
               "exact"), ("volume", volume[oi], False)]

    def run(pkg, **kw):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            text, batch_size=batch)
        got = []
        rt.add_callback("OutStream", got.extend)
        h = rt.get_input_handler("TradeStream")
        for r in range(rounds):
            s = slice(r * batch, (r + 1) * batch)
            h.send_columns({k: v[s] for k, v in cols.items()},
                           timestamps=ts[s])
            rt.flush()
        rt.heartbeat(int(ts[-1]) + 51)
        return got

    got = run(siddhi_tpu_torch, device="cpu")
    assert cs.check_sliding("S", got, ts[oi], expect) == 2 * ts.size
    want = run(siddhi_tpu)
    assert len(want) < len(got)
    with pytest.raises(cs.Failure):
        cs.check_sliding("S", want, ts[oi], expect)


def test_no_gap_breaks_a_session_in_the_first_batch_as_in_jax():
    """The reference fault the port keeps for parity (ROADMAP.md, Queue
    3): the JAX break reads `has_events` from before the batch, so the
    1200 ms arrival of the first batch ever does not close the session of
    1000 and 1010; all three expire at the heartbeat."""
    app = ("@app:playback\ndefine stream S (symbol string, price double, "
           "volume long);\nfrom S#window.session(50) select symbol, price, "
           "volume insert all events into Out;")
    outs = []
    for pkg, kw in ((siddhi_tpu, {}), (siddhi_tpu_torch, {"device": "cpu"})):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            app, batch_size=8)
        got = []
        rt.add_query_callback("query1", lambda ts, i, r, g=got: g.append(
            (ts, [e.timestamp for e in i or []],
             [e.timestamp for e in r or []])))
        rt.get_input_handler("S").send_columns(
            {"symbol": np.array(["a"] * 3, dtype=object),
             "price": np.ones(3), "volume": np.ones(3, dtype=np.int64)},
            timestamps=np.array([1000, 1010, 1200]))
        rt.flush()
        rt.heartbeat(2000)
        outs.append(got)
    assert outs[0] == outs[1] == [(1200, [1000, 1010, 1200], []),
                                  (2000, [], [1000, 1010, 1200])]
