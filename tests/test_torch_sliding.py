"""The sliding windows of siddhi_tpu_torch against the JAX package on the
CPU: the packed-ring helpers (kernel K2b's plain versions) bit for bit, and
whole apps through the public API — length, time, timeLength, delay and
externalTime windows, a short final batch, a heartbeat that drains a time
window, and interop of a running window's state.

Inputs are made with numpy from a seed and handed to both packages. Strings,
longs, timestamps and event types must be equal; floats within rtol 1e-5
(float32 accumulation order, tests/test_numeric_parity.py) plus atol 1e-3:
a sliding sum adds and removes values, and where it cancels to about zero
the two packages keep float32 residues of a few ulps of the running sum
(prices below 100, at most 100 in a window: ulp(1e4) ~ 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops import windows as jw
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops import windows as tw

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3

LAYOUT_J = {"symbol": jnp.int32, "price": jnp.float32, "volume": jnp.int64,
            "flag": jnp.bool_}
LAYOUT_T = {"symbol": torch.int32, "price": torch.float32,
            "volume": torch.int64, "flag": torch.bool}


def _cols(rng, n):
    return {"symbol": rng.integers(0, 1000, n).astype(np.int32),
            "price": rng.uniform(-50, 50, n).astype(np.float32),
            "volume": rng.integers(-(2**62), 2**62, n, dtype=np.int64),
            "flag": rng.random(n) < 0.5}


def _words(mat):
    """JAX uint32 words and the port's int32 words, compared as bits."""
    a = np.asarray(mat)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --------------------------------------------------------------- K2b plain


def test_layout_words_and_pack_unpack_match_jax():
    rng = np.random.default_rng(0)
    n = 57
    cols = _cols(rng, n)
    ts = rng.integers(0, 2**40, n, dtype=np.int64)
    assert tw._layout_words(LAYOUT_T) == jw._layout_words(LAYOUT_J) == 7
    jm = jw._pack_rows({k: jnp.asarray(v) for k, v in cols.items()},
                       jnp.asarray(ts), LAYOUT_J)
    tm = tw._pack_rows({k: _t(v) for k, v in cols.items()}, _t(ts), LAYOUT_T)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), _words(jm))
    tcols, tts = tw._unpack_rows(tm, LAYOUT_T)
    for k, v in cols.items():
        np.testing.assert_array_equal(tcols[k].numpy(), v)
    np.testing.assert_array_equal(tts.numpy(), ts)
    np.testing.assert_array_equal(tw._packed_ts(tm).numpy(), ts)


@pytest.mark.parametrize("p_live", [0.0, 0.6, 1.0])
def test_compact_packed_matches_jax(p_live):
    rng = np.random.default_rng(1)
    n = 48
    cols = _cols(rng, n)
    ts = np.sort(rng.integers(0, 10**6, n)).astype(np.int64)
    valid = rng.random(n) < p_live
    types = np.where(rng.random(n) < 0.2, 1, 0).astype(np.int8)
    jm, jn = jw.compact_packed(JBatch(
        ts=jnp.asarray(ts), cols={k: jnp.asarray(v) for k, v in cols.items()},
        valid=jnp.asarray(valid), types=jnp.asarray(types)), LAYOUT_J)
    tm, tn = tw.compact_packed(TBatch(
        ts=_t(ts), cols={k: _t(v) for k, v in cols.items()},
        valid=_t(valid), types=_t(types)), LAYOUT_T)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tm.numpy(), _words(jm))


# (W, C, B, E, base_idx, appended0): wraps, E > B, E < B, rel0 > E, rel0 = 0
FETCH_CASES = [(3, 64, 16, 32, 5, 20), (3, 64, 16, 32, 60, 70),
               (3, 64, 48, 16, 100, 110), (3, 64, 16, 16, 0, 40),
               (2, 40, 16, 40, 33, 33), (4, 128, 32, 128, -7, 1)]


@pytest.mark.parametrize("W,C,B,E,base,app0", FETCH_CASES)
def test_fetch_rel_packed_matches_jax(W, C, B, E, base, app0):
    rng = np.random.default_rng(C + B + E + base)
    ring = rng.integers(0, 2**32, (W, C), dtype=np.uint64).astype(np.uint32)
    comp = rng.integers(0, 2**32, (W, B), dtype=np.uint64).astype(np.uint32)
    want = jw._fetch_rel_packed(jnp.asarray(ring), jnp.asarray(comp),
                                jnp.int64(base), jnp.int64(app0), E)
    got = tw._fetch_rel_packed(_t(ring.view(np.int32)),
                               _t(comp.view(np.int32)),
                               torch.tensor(base), torch.tensor(app0), E)
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("C,B,app0,nv", [(64, 16, 5, 16), (64, 16, 58, 11),
                                         (32, 32, 31, 32), (40, 16, 39, 0)])
def test_append_packed_matches_jax(C, B, app0, nv):
    rng = np.random.default_rng(C + app0)
    ring = rng.integers(0, 2**32, (3, C), dtype=np.uint64).astype(np.uint32)
    comp = rng.integers(0, 2**32, (3, B), dtype=np.uint64).astype(np.uint32)
    want = jw._append_packed(jnp.asarray(ring), jnp.asarray(comp),
                             jnp.int64(app0), jnp.int32(nv))
    got = tw._append_packed(_t(ring.view(np.int32)), _t(comp.view(np.int32)),
                            torch.tensor(app0),
                            torch.tensor(nv, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), _words(want))


def test_gather_chunk_packed_matches_jax():
    rng = np.random.default_rng(3)
    L = 70
    cols = _cols(rng, L)
    ts = rng.integers(0, 2**40, L, dtype=np.int64)
    payload = np.asarray(jw._pack_rows(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(ts),
        LAYOUT_J))
    emit = rng.integers(0, 2**40, L, dtype=np.int64)
    valid = rng.random(L) < 0.5
    types = rng.integers(0, 4, L).astype(np.int8)
    order = rng.permutation(L).astype(np.int32)
    jb = jw._gather_chunk_packed(jnp.asarray(order), jnp.asarray(payload),
                                 jnp.asarray(emit), jnp.asarray(valid),
                                 jnp.asarray(types), LAYOUT_J)
    tb = tw._gather_chunk_packed(_t(order), _t(payload.view(np.int32)),
                                 _t(emit), _t(valid), _t(types), LAYOUT_T)
    np.testing.assert_array_equal(tb.ts.numpy(), np.asarray(jb.ts))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_array_equal(tb.types.numpy(), np.asarray(jb.types))
    for k in LAYOUT_T:
        np.testing.assert_array_equal(tb.cols[k].numpy(),
                                      np.asarray(jb.cols[k]))


@pytest.mark.parametrize("lo,hi", [(0, 0), (3, 20), (50, 90), (70, 75)])
def test_ring_live_mask_matches_jax(lo, hi):
    want = jw._ring_live_mask(32, jnp.int64(lo), jnp.int64(hi))
    got = tw._ring_live_mask(32, torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(length=20), dict(time_ms=50),
                                dict(time_ms=50, length=20, capacity=20),
                                dict(time_ms=30, ts_attr="volume")],
                         ids=["length", "time", "timeLength", "externalTime"])
def test_sliding_window_step_state_and_contents_match_jax(kw):
    """The window operator alone: every chunk, the whole state (ring words,
    counters, watermark) and `contents` after each step, bucketed batches
    (16 lanes into a 32-lane window) included. Values fit a float32
    exactly, so the float column compares exactly too."""
    rng = np.random.default_rng(sum(kw.values()) if "ts_attr" not in kw
                                else 9)
    jwin = jw.SlidingWindow(LAYOUT_J, 32, max_expired=24, **kw)
    twin = tw.SlidingWindow(LAYOUT_T, 32, max_expired=24, **kw)
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    t0 = 0
    for cap, n in [(32, 32), (32, 20), (16, 9), (32, 0), (32, 31)]:
        cols = _cols(rng, cap)
        cols["volume"] = 100 + t0 + np.arange(cap, dtype=np.int64) * 3
        cols["price"] = np.round(cols["price"]).astype(np.float32)
        stamps = t0 + np.arange(cap, dtype=np.int64) * 4
        valid = np.arange(cap) < n
        now = int(stamps[max(n - 1, 0)])
        t0 += 4 * max(n, 1)
        jb = JBatch(ts=jnp.asarray(stamps),
                    cols={k: jnp.asarray(v) for k, v in cols.items()},
                    valid=jnp.asarray(valid),
                    types=jnp.zeros(cap, jnp.int8))
        tb = TBatch(ts=_t(stamps), cols={k: _t(v) for k, v in cols.items()},
                    valid=_t(valid), types=torch.zeros(cap, dtype=torch.int8))
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        np.testing.assert_array_equal(ts_.ring.numpy(), _words(js.ring))
        for f in ("appended", "expired", "wm", "overflow"):
            assert int(getattr(ts_, f)) == int(getattr(js, f)), f
        for f in ("ts", "valid", "types"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))
        for k in LAYOUT_T:
            np.testing.assert_array_equal(tc.cols[k].numpy(),
                                          np.asarray(jc.cols[k]))
        jcols, jts, jlive = jwin.contents(js, jnp.int64(now))
        tcols, tts, tlive = twin.contents(ts_, now)
        np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
        np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))


# ---------------------------------------------------------------- the apps

STREAM = ("@app:playback\n"
          "define stream TradeStream (symbol string, price double, "
          "volume long, ts long);\n")

APPS = {
    "length": """
        @info(name = 'bench')
        from TradeStream#window.length(40)
        select symbol, sum(price) as total, count() as n
        group by symbol
        insert all events into SummaryStream;""",
    "time": """
        @info(name = 'bench')
        from TradeStream#window.time(200)
        select symbol, sum(volume) as v, count() as n
        group by symbol
        insert all events into SummaryStream;""",
    "timeLength": """
        @info(name = 'bench')
        from TradeStream#window.timeLength(200, 40)
        select sum(volume) as v, avg(price) as ap, count() as n
        insert all events into SummaryStream;""",
    "delay": """
        @info(name = 'bench')
        from TradeStream[price > 20.0]#window.delay(100)
        select symbol, price, volume
        insert into SummaryStream;""",
    "externalTime": """
        @info(name = 'bench')
        from TradeStream#window.externalTime(ts, 200)
        select symbol, count() as n, sum(volume) as v
        group by symbol
        insert all events into SummaryStream;""",
    # the north-star shape (app D): EXPIRED lanes feed K5 negative deltas
    "app_d": """
        @info(name = 'bench')
        from TradeStream#window.length(100)
        select symbol, sum(price) as total, count() as n
        group by symbol
        insert into SummaryStream;""",
}


def _trades(seed, n, n_keys, step_ms=7):
    rng = np.random.default_rng(seed)
    key = np.array([f"S{i}" for i in rng.integers(0, n_keys, n)],
                   dtype=object)
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_000 + np.arange(n, dtype=np.int64) * step_ms
    # the attribute clock runs ahead of the arrival clock, and repeats
    ext = 5_000 + (np.arange(n, dtype=np.int64) // 2) * 11
    return [{"symbol": key, "price": price, "volume": volume, "ts": ext}, ts]


def _feeds(cols, ts, chunk):
    n = ts.shape[0]
    return [({k: v[s:s + chunk] for k, v in cols.items()}, ts[s:s + chunk])
            for s in range(0, n, chunk)]


def _run(pkg, app, feeds, heartbeat=None, batch_size=32, group_capacity=64,
         **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=batch_size, group_capacity=group_capacity)
    out = []
    rt.add_callback("SummaryStream", lambda evs: out.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    h = rt.get_input_handler("TradeStream")
    for cols, ts in feeds:
        h.send_columns(cols, timestamps=ts)
        rt.flush()
    if heartbeat is not None:
        rt.heartbeat(heartbeat)
    return out


def _assert_same(want, got):
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
def test_sliding_app_parity(name):
    cols, ts = _trades(11, 150, 12)
    # chunks of 37 at batch size 32: every send ends with a short batch
    feeds = _feeds(cols, ts, 37)
    app = STREAM + APPS[name]
    want = _run(siddhi_tpu, app, feeds)
    got = _run(siddhi_tpu_torch, app, feeds, device="cpu")
    _assert_same(want, got)
    assert len(want) > 0


def test_heartbeat_drains_time_window():
    cols, ts = _trades(12, 60, 5)
    feeds = _feeds(cols, ts, 25)
    app = STREAM + APPS["time"]
    end = int(ts[-1]) + 10_000
    want = _run(siddhi_tpu, app, feeds, heartbeat=end)
    got = _run(siddhi_tpu_torch, app, feeds, heartbeat=end, device="cpu")
    _assert_same(want, got)
    # every arrival enters and leaves the window: 60 current and 60
    # expired events, forwarded into SummaryStream
    assert len(got) == 120


def test_window_parameters_are_checked():
    from siddhi_tpu_torch.errors import SiddhiAppCreationError
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    for bad in ("externalTime(200, 200)", "length(1.5)", "time()"):
        with pytest.raises(SiddhiAppCreationError):
            mgr.create_siddhi_app_runtime(
                STREAM + "from TradeStream#window." + bad
                + " select symbol insert into SummaryStream;")


@pytest.mark.parametrize("name", ["time", "length"])
def test_interop_continues_jax_sliding_state(name):
    cols, ts = _trades(13, 200, 9)
    feeds = _feeds(cols, ts, 32)
    head, tail = feeds[:3], feeds[3:]
    app = STREAM + APPS[name]

    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        app, batch_size=32, group_capacity=64)
    jout = []
    jrt.add_callback("SummaryStream", lambda evs: jout.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    h = jrt.get_input_handler("TradeStream")
    for c, t in head:
        h.send_columns(c, timestamps=t)
        jrt.flush()
    jstate = jax.device_get(jrt.query_runtimes["bench"].state)
    strings = list(jrt.ctx.global_strings._to_str)
    n_head = len(jout)

    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app, batch_size=32, group_capacity=64)
    interop.load_app_state(trt, {"bench": jstate}, strings)
    trt.ctx.timestamp_generator.observe_event_time(int(head[-1][1][-1]))
    tout = []
    trt.add_callback("SummaryStream", lambda evs: tout.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    th = trt.get_input_handler("TradeStream")
    for c, t in tail:
        h.send_columns(c, timestamps=t)
        jrt.flush()
        th.send_columns(c, timestamps=t)
        trt.flush()
    assert len(jout) > n_head
    _assert_same(jout[n_head:], tout)
