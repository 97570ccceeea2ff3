"""The tumbling time windows of siddhi_tpu_torch against the JAX package on
the CPU: the TimeBatchWindow operator alone (every emitted lane and the
whole state), then timeBatch (with and without a start time),
externalTimeBatch (with a start time), batch with and without a length
through the public API, a bucket flushed by a heartbeat, and a timeBatch
side in a join; and the one deliberate divergence: where a step flushes
more rows and buckets than the JAX window's chunk holds, the port emits
them all (ROADMAP.md, Queue 3).

Inputs are made with numpy from a seed and handed to both packages.
Strings, longs, timestamps and event types must be equal; floats within
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
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops import windows as jw
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.ops import windows as tw

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3

LAYOUT_J = {"symbol": jnp.int32, "price": jnp.float32, "volume": jnp.int64}
LAYOUT_T = {"symbol": torch.int32, "price": torch.float32,
            "volume": torch.int64}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("kw", [dict(), dict(start_time=1_003),
                                dict(ts_attr="volume"),
                                dict(expired_on=False)],
                         ids=["timeBatch", "start_time", "externalTimeBatch",
                              "no_expired"])
def test_time_batch_window_step_and_state_match_jax(kw):
    """The window operator alone: every emitted lane (the chunks differ in
    width only by invalid lanes past them), the whole BatchState and
    `contents` after each step; batches spanning several buckets, an
    empty batch (a heartbeat's) and a short one."""
    rng = np.random.default_rng(len(kw) + 3 * ("ts_attr" in kw))
    B, C = 32, 96
    jwin = jw.TimeBatchWindow(LAYOUT_J, B, 40, capacity=C, **kw)
    twin = tw.TimeBatchWindow(LAYOUT_T, B, 40, capacity=C, **kw)
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    t0 = 1_000
    for n, gap in [(32, 3), (20, 5), (0, 0), (32, 1), (7, 30), (32, 2)]:
        cols = {"symbol": rng.integers(1, 9, B).astype(np.int32),
                "price": rng.integers(1, 100, B).astype(np.float32),
                "volume": 2_000 + t0 + np.arange(B, dtype=np.int64) * gap}
        stamps = t0 + np.arange(B, dtype=np.int64) * gap
        valid = np.arange(B) < n
        now = int(stamps[n - 1]) if n else t0 + 200
        t0 = now + 1
        jb = JBatch(ts=jnp.asarray(stamps),
                    cols={k: jnp.asarray(v) for k, v in cols.items()},
                    valid=jnp.asarray(valid), types=jnp.zeros(B, jnp.int8))
        tb = TBatch(ts=_t(stamps), cols={k: _t(v) for k, v in cols.items()},
                    valid=_t(valid), types=torch.zeros(B, dtype=torch.int8))
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        # valid lanes come first, in emission order
        nv = int(np.asarray(jc.valid).sum())
        assert int(tc.valid.sum()) == nv and bool(tc.valid[:nv].all())
        for f in ("ts", "types"):
            np.testing.assert_array_equal(getattr(tc, f)[:nv].numpy(),
                                          np.asarray(getattr(jc, f))[:nv], f)
        for k in LAYOUT_T:
            np.testing.assert_array_equal(tc.cols[k][:nv].numpy(),
                                          np.asarray(jc.cols[k])[:nv], k)
        for f in ("appended", "flushed", "prev_start", "epoch_base",
                  "has_base", "wm"):
            assert int(getattr(ts_, f)) == int(getattr(js, f)), f
        np.testing.assert_array_equal(ts_.ring_ts[:C].numpy(),
                                      np.asarray(js.ring_ts))
        jcols, jts, jlive = jwin.contents(js, jnp.int64(now))
        tcols, tts, tlive = twin.contents(ts_, now)
        np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
        np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))


# ---------------------------------------------------------------- the apps

S = ("@app:playback\n"
     "define stream S (symbol string, price double, volume long, ts long);\n")

APPS = {
    "timeBatch": "from S#window.timeBatch(100) select symbol, "
                 "sum(volume) as v, max(price) as hi, count() as n "
                 "group by symbol insert all events into Out;",
    "timeBatch_start": "from S#window.timeBatch(100, 1030) select "
                       "sum(volume) as v, min(price) as lo, count() as n "
                       "insert into Out;",
    "externalTimeBatch": "from S#window.externalTimeBatch(ts, 120, 5003) "
                         "select symbol, count() as n, max(volume) as mv "
                         "group by symbol insert all events into Out;",
    "batch": "from S#window.batch() select symbol, sum(volume) as v, "
             "count() as n group by symbol insert into Out;",
    "batch_length": "from S#window.batch(12) select symbol, avg(price) as a,"
                    " count() as n insert all events into Out;",
}


def _trades(seed, n, n_keys, step_ms=7):
    rng = np.random.default_rng(seed)
    key = np.array([f"S{i}" for i in rng.integers(0, n_keys, n)],
                   dtype=object)
    return ({"symbol": key, "price": rng.uniform(1.0, 100.0, n),
             "volume": rng.integers(1, 1000, n).astype(np.int64),
             # the attribute clock runs ahead of the arrival clock, repeats
             "ts": 5_000 + (np.arange(n, dtype=np.int64) // 2) * 11},
            1_000 + np.arange(n, dtype=np.int64) * step_ms)


def _feeds(cols, ts, chunk):
    return [({k: v[s:s + chunk] for k, v in cols.items()}, ts[s:s + chunk])
            for s in range(0, ts.shape[0], chunk)]


def _run(pkg, app, feeds, heartbeats=(), batch_size=32, **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=batch_size, group_capacity=64)
    out = []
    rt.add_callback("Out", lambda evs: out.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    for feed in feeds:
        s, (cols, ts) = (("S", feed) if len(feed) == 2
                         else (feed[0], feed[1:]))
        rt.get_input_handler(s).send_columns(cols, timestamps=ts)
        rt.flush()
    for hb in heartbeats:
        rt.heartbeat(hb)
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


def _parity(app, feeds, heartbeats=()):
    want = _run(siddhi_tpu, app, feeds, heartbeats)
    got = _run(siddhi_tpu_torch, app, feeds, heartbeats, device="cpu")
    _assert_same(want, got)
    assert want
    return got


@pytest.mark.parametrize("name", sorted(APPS))
def test_batch_window_app_parity(name):
    cols, ts = _trades(11, 150, 5)
    # chunks of 37 at batch size 32: every send ends with a short batch
    _parity(S + "@info(name = 'q') " + APPS[name], _feeds(cols, ts, 37))


def test_heartbeat_flushes_an_idle_bucket():
    """With no later arrival, only the heartbeat's watermark crosses the
    last bucket's end: its events come out on the heartbeat."""
    cols, ts = _trades(12, 60, 4)
    app = S + ("@info(name = 'q') from S#window.timeBatch(100) select "
               "symbol, sum(volume) as v, count() as n group by symbol "
               "insert into Out;")
    feeds = _feeds(cols, ts, 25)
    end = int(ts[-1])
    quiet = _run(siddhi_tpu_torch, app, feeds, device="cpu")
    # the first heartbeat stays inside the last bucket, the second ends it
    got = _parity(app, feeds, heartbeats=(end + 50, end + 400))
    assert len(quiet) < len(got) == len(ts)


def test_time_batch_side_in_a_join():
    """Joins probe the accumulating (unflushed) bucket of a timeBatch
    side (`contents`)."""
    app = ("@app:playback\ndefine stream L (k int, v double);\n"
           "define stream R (k int, v double);\n@info(name = 'q') "
           "from L#window.timeBatch(50) as a join R#window.length(6) as b "
           "on a.k == b.k select a.k as k, a.v as av, b.v as bv "
           "insert into Out;")
    rng = np.random.default_rng(7)
    feeds, t = [], 1_000
    for _ in range(6):
        for s in ("L", "R"):
            n = 9
            cols = {"k": rng.integers(1, 4, n).astype(np.int32),
                    "v": rng.uniform(0, 100, n)}
            feeds.append((s, cols, t + 4 * np.arange(n, dtype=np.int64)))
            t += 4 * n
    _parity(app, feeds)


def test_batch_window_parameters_are_checked():
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    for bad in ("timeBatch()", "timeBatch(1.5)", "externalTimeBatch(100)",
                "externalTimeBatch(100, 100)", "batch(1, 2)"):
        with pytest.raises(SiddhiAppCreationError):
            mgr.create_siddhi_app_runtime(
                S + "from S#window." + bad
                + " select symbol insert into Out;")


def test_a_step_flushing_many_buckets_emits_every_row():
    """batch_size 1024, 10 ms buckets, 1 ms apart: each step flushes about
    100 buckets. The JAX window takes max(B, 1024) candidates and room for
    one RESET, so it cuts currents off and restarts a deferred bucket's
    aggregates (its events fall short of chip_smoke.py's oracle); the port
    emits every row of every flushed bucket, as the oracle does."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rounds, batch, period = 3, 1024, 10
    text, n_sym, _ = cs.agg_apps_plan({"J": 300, "K": 300, "L": 700,
                                       "M": period})["M"]
    sym, price, volume, ts = cs.agg_events(np.random.default_rng(9), 7,
                                           rounds, batch)
    pool = cs.symbols(7)
    cols = {"symbol": pool[sym], "price": price, "volume": volume}

    def run(pkg, **kw):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            text, batch_size=batch, group_capacity=64)
        got = []
        rt.add_callback("OutStream", got.extend)
        h = rt.get_input_handler("TradeStream")
        for r in range(rounds):
            s = slice(r * batch, (r + 1) * batch)
            h.send_columns({k: v[s] for k, v in cols.items()},
                           timestamps=ts[s])
            rt.flush()
        return got

    got = run(siddhi_tpu_torch, device="cpu")
    n = cs.check_m(got, sym, price.astype(np.float32), ts, period, pool)
    assert n == len(got) > 2 * batch
    with pytest.raises(cs.Failure):
        cs.check_m(run(siddhi_tpu), sym, price.astype(np.float32), ts,
                   period, pool)
