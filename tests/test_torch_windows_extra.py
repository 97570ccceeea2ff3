"""The cron, hopping, frequent and lossyFrequent windows of siddhi_tpu_torch
against the JAX package on the CPU: K13b's plain last-lane scatter against
the JAX scatter-max, each window operator alone step by step (every lane
and the whole state; cron's fire table against the JAX host callback), the
shapes of tests/test_windows_extra.py through both public APIs, interop of
each new window state (and the expression windows'), and chip_smoke.py's
apps Y and Z at 4 rounds of 512 against the JAX package and the script's
numpy oracles.

Inputs are made with numpy from a seed and handed to both packages.
Orders, strings, longs, timestamps and event types must be equal; floats
within rtol 1e-5 (float32 accumulation order, tests/test_numeric_parity.py)
plus atol 1e-3 for what removal leaves of a float32 sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.ops import windows_extra as jwx
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.ops import windows_extra as twx
from tests.test_torch_expression_window import (_chip_smoke,
                                                assert_apps_equal, run_app)
from tests.test_torch_session_sort import LAYOUT_J, LAYOUT_T, _pair

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------ K13b, plain


@pytest.mark.parametrize("N", [1, 8, 64])
def test_k13b_plain_matches_the_jax_scatter_max(N):
    """The last lane of each slot (slot N takes the untracked lanes) and
    the rows it remembers, against `.at[slot].max(lane)` and the JAX
    gather; slots with no lane keep their rows."""
    rng = np.random.default_rng(N)
    B = 256
    slot = np.where(rng.random(B) < 0.8, rng.integers(0, N + 1, B), N)
    slot = slot.astype(np.int32)
    comp = {k: rng.integers(-50, 50, B).astype(v)
            for k, v in (("symbol", np.int32), ("price", np.float32),
                         ("volume", np.int64))}
    comp_ts = rng.integers(0, 2**40, B)
    old = {k: rng.integers(-50, 50, N).astype(v.dtype)
           for k, v in comp.items()}
    old_ts = rng.integers(0, 2**40, N)
    last = jnp.full((N + 1,), -1, jnp.int32).at[jnp.asarray(slot)].max(
        jnp.arange(B, dtype=jnp.int32), mode="drop")[:N]
    g = jnp.clip(last, 0, B - 1)
    cols, ts = twx.frequent_last_lane_plain(
        _t(slot), {k: _t(v) for k, v in comp.items()}, _t(comp_ts),
        {k: _t(v) for k, v in old.items()}, _t(old_ts), N)
    for k in comp:
        want = jnp.where(last >= 0, jnp.asarray(comp[k])[g],
                         jnp.asarray(old[k]))
        np.testing.assert_array_equal(cols[k].numpy(), np.asarray(want), k)
    np.testing.assert_array_equal(
        ts.numpy(), np.asarray(jnp.where(last >= 0,
                                         jnp.asarray(comp_ts)[g],
                                         jnp.asarray(old_ts))))


# ------------------------------------------------ the operators alone


def _batches(rng, B, rounds, step_ms, n_keys=6, zipf=False):
    """Batches `step_ms` apart on average, one empty (a heartbeat's)."""
    t = 1_000
    out = []
    for r in range(rounds):
        n = 0 if r == 3 else int(rng.integers(1, B + 1))
        stamps = t + np.cumsum(rng.integers(0, 2 * step_ms + 1, B))
        sym = (np.minimum(rng.zipf(1.5, B), n_keys) - 1 if zipf
               else rng.integers(0, n_keys, B))
        cols = {"symbol": sym.astype(np.int32),
                "price": rng.integers(1, 9, B).astype(np.float32),
                "volume": rng.integers(0, 100, B).astype(np.int64)}
        valid = np.arange(B) < n
        now = int(stamps[n - 1]) if n else t + 40 * step_ms
        t = now + 1
        out.append((stamps, cols, valid, now))
    return out


def _lanes_equal(jc, tc):
    """An unsorted chunk: lane for lane (valid and type everywhere; the
    payload where valid)."""
    for f in ("valid", "types"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), f)
    v = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.ts.numpy()[v], np.asarray(jc.ts)[v])
    for k in LAYOUT_T:
        np.testing.assert_array_equal(tc.cols[k].numpy()[v],
                                      np.asarray(jc.cols[k])[v], k)
    return int(v.sum())


def _ring_eq(t_ring, j_ring):
    np.testing.assert_array_equal(t_ring[:-1].numpy(), np.asarray(j_ring))


def _make(kind, B):
    if kind == "cron":
        return (jwx.CronWindow(LAYOUT_J, B, "*/2 * * * * ?"),
                twx.CronWindow(LAYOUT_T, B, "*/2 * * * * ?"))
    if kind == "hopping":
        return (jwx.HoppingWindow(LAYOUT_J, B, 3_000, 1_000),
                twx.HoppingWindow(LAYOUT_T, B, 3_000, 1_000))
    if kind == "frequent":
        return (jwx.FrequentWindow(LAYOUT_J, B, 3, ["symbol"]),
                twx.FrequentWindow(LAYOUT_T, B, 3, ["symbol"]))
    kw = dict(support=0.2, error=0.05, lossy=True)
    return (jwx.FrequentWindow(LAYOUT_J, B, 20, ["symbol"], **kw),
            twx.FrequentWindow(LAYOUT_T, B, 20, ["symbol"], **kw))


@pytest.mark.parametrize("kind", ["cron", "hopping", "frequent", "lossy"])
def test_window_steps_and_state_match_jax(kind):
    """Each operator alone over batches 0-2 s apart (cron every 2 s,
    hops of 1 s over 3 s) or Zipf keys (frequent): every lane and the
    whole state after every step."""
    rng = np.random.default_rng(len(kind))
    B = 16
    jwin, twin = _make(kind, B)
    js, ts_ = jwin.init_state(), twin.init_state(torch.device("cpu"))
    jstep = jax.jit(jwin.step)
    emitted = 0
    freq = kind in ("frequent", "lossy")
    for stamps, cols, valid, now in _batches(
            rng, B, 10, 3 if freq else 90, n_keys=9, zipf=freq):
        jb, tb = _pair(stamps, cols, valid)
        js, jc = jstep(js, jb, jnp.int64(now))
        ts_, tc = twin.step(ts_, tb, now)
        emitted += _lanes_equal(jc, tc)
        for f in js._fields:
            j, t = getattr(js, f), getattr(ts_, f)
            if isinstance(j, dict):
                for k in j:
                    if f == "ring_cols":
                        _ring_eq(t[k], j[k])
                    else:
                        np.testing.assert_array_equal(t[k].numpy(),
                                                      np.asarray(j[k]), k)
            elif f == "ring_ts":
                _ring_eq(t, j)
            else:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j), f)
    assert emitted > B


def test_cron_fire_table_answers_as_the_schedule():
    """The next fire after any clock, and the lazy first schedule: an
    instant before the table's first fire gets an answer that differs from
    the schedule's only when both are at or before the clock."""
    from siddhi_tpu.core.trigger import CronSchedule as JCron
    from siddhi_tpu_torch.core.trigger import CronSchedule
    for expr in ("*/1 * * * * ?", "0 0/5 * * * ?", "0 0 12 ? * MON-FRI"):
        table = twx.CronFireTable(CronSchedule(expr))
        ref = JCron(expr)
        rng = np.random.default_rng(len(expr))
        for now in np.sort(rng.integers(1_700_000_000_000,
                                        1_700_900_000_000, 20)):
            now = int(now)
            dev = table.table(now, torch.device("cpu"))
            assert table.next_after(now) == ref.next_fire_ms(now)
            for back in (1, 999, 60_000, 3_600_000, 10**9):
                x = now - back
                got = int(table.first_schedule(dev, torch.tensor(x)))
                want = ref.next_fire_ms(x)
                assert got == want or (got <= now and want <= now)


# ------------------------------------------------ through the public API

S = "define stream S (symbol string, price float, volume long);\n"


def _api(pkg, app, script, batch_size=8):
    rt = pkg.SiddhiManager(
        **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
        .create_siddhi_app_runtime("@app:playback\n" + S + app,
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
        elif op[0] == "flush":
            rt.flush(now=op[1])
        else:
            rt.heartbeat(op[1])
    return got


def _sends(rows):
    return [("send", r, 1_000 + i) for i, r in enumerate(rows)]


# the app and event shapes of tests/test_windows_extra.py
SHAPES = {
    "cron_flush": (
        "@info(name='q') from S#window.cron('*/2 * * * * ?') select "
        "symbol, sum(price) as total insert into Out;",
        [("send", ("A", 10.0, 1), 100), ("send", ("B", 20.0, 1), 300),
         ("flush", 500), ("heartbeat", 2_100)], 8),
    "cron_expired": (
        "@info(name='q') from S#window.cron('*/2 * * * * ?') select symbol "
        "insert all events into Out;",
        [("send", ("A", 1.0, 1), 100), ("heartbeat", 2_100),
         ("send", ("B", 2.0, 1), 2_500), ("heartbeat", 4_100)], 8),
    "hop_overlap": (
        "@info(name='q') from S#window.hopping(2 sec, 1 sec) select symbol, "
        "count() as n insert into Out;",
        [("send", ("A", 1.0, 1), 200), ("send", ("B", 1.0, 1), 700),
         ("heartbeat", 1_050), ("send", ("C", 1.0, 1), 1_500),
         ("heartbeat", 2_050), ("heartbeat", 3_050)], 8),
    "frequent_top": (
        "@info(name='q') from S#window.frequent(2, symbol) select symbol, "
        "price insert into Out;",
        _sends([("A", 1.0, 1), ("B", 2.0, 1), ("A", 3.0, 1)])
        + [("flush", None), ("send", ("C", 9.0, 1), 1_010),
           ("flush", None)], 4),
    "frequent_eviction": (
        "@info(name='q') from S#window.frequent(1, symbol) select symbol "
        "insert all events into Out;",
        [("send", ("A", 1.0, 1), 1_000), ("flush", None),
         ("send", ("B", 1.0, 1), 1_001), ("flush", None)], 4),
    "frequent_no_phantom": (
        "@info(name='q') from S#window.frequent(1, symbol) select symbol "
        "insert into Out;",
        _sends([("A", 1.0, 1), ("B", 1.0, 1), ("B", 2.0, 1)])
        + [("flush", None)], 4),
    "lossy_support": (
        "@info(name='q') from S#window.lossyFrequent(0.5, 0.1, symbol) "
        "select symbol insert into Out;",
        _sends([("A", 1.0, 1)] * 6 + [("B", 1.0, 1)]) + [("flush", None)],
        4),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_shapes_match_jax(name):
    app, script, batch = SHAPES[name]
    want = _api(siddhi_tpu, app, script, batch)
    # the phantom shape's point is that nothing comes out
    assert any(i or r for _, i, r in want) != (name == "frequent_no_phantom")
    assert _api(siddhi_tpu_torch, app, script, batch) == want


@pytest.mark.parametrize("window,match", [
    ("cron('* * *')", "6 or 7 fields"),
    ("hopping(0, 1 sec)", "positive window and hop"),
    ("lossyFrequent(0.1, 0.2, symbol)", "errorBound"),
], ids=["cron_fields", "hopping_zero", "lossy_error"])
def test_refusals_match_jax(window, match):
    app = (S + f"@info(name='q') from S#window.{window} select symbol "
           "insert into Out;")
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match=match):
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    with pytest.raises(siddhi_tpu_torch.errors.SiddhiAppCreationError,
                       match=match):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app)


# ------------------------------------------------ interop

INTEROP = {
    "expression": "expression('sum(volume) <= 400')",
    "expression_batch": "expressionBatch('sum(price) < 30.0', true)",
    "cron": "cron('*/1 * * * * ?')",
    "hopping": "hopping(2 sec, 500 millisec)",
    "frequent": "frequent(6, symbol)",
}


@pytest.mark.parametrize("name", list(INTEROP))
def test_interop_continues_a_jax_state(name):
    """Three rounds through the JAX package, its state carried into the
    port (SlidingState, GeneralBatchState, CronState, HopState,
    FrequentState), two more rounds through both: the same events."""
    app = ("@app:playback\n" + S + f"@info(name='q') from S#window."
           f"{INTEROP[name]} select symbol, price, volume "
           "insert all events into Out;")
    rng = np.random.default_rng(len(name))
    feeds = []
    t = 1_000
    for _ in range(5):
        n = 64
        ts = t + np.cumsum(rng.integers(5, 40, n))
        t = int(ts[-1]) + 1
        feeds.append(({"symbol": np.array([f"S{k}" for k in np.minimum(
            rng.zipf(1.6, n), 7)], dtype=object),
            "price": rng.integers(1, 9, n).astype(np.float64),
            "volume": rng.integers(1, 30, n).astype(np.int64)}, ts))

    def run(rt, part):
        got = []
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        for cols, ts in part:
            rt.get_input_handler("S").send_columns(cols, timestamps=ts)
            rt.flush()
        return got

    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        app, batch_size=64)
    run(jrt, feeds[:3])
    state = jax.device_get(jrt.query_runtimes["q"].state)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app, batch_size=64)
    interop.load_app_state(trt, {"q": state},
                           jrt.ctx.global_strings.snapshot())
    trt.ctx.timestamp_generator.observe_event_time(int(feeds[2][1][-1]))
    want = run(jrt, feeds[3:])
    got = run(trt, feeds[3:])
    assert len(want) > 0 and len(got) == len(want)
    for (wt, wd), (gt, gd) in zip(want, got):
        assert gt == wt and gd == wd


# ------------------------------------------------ apps Y and Z


@pytest.mark.parametrize("name", ["Y", "Z"])
def test_apps_match_jax_and_the_oracle(name):
    """Apps Y (`frequent(64, symbol)`, `frequent(250, symbol)` and
    `lossyFrequent(0.001, 0.0001, symbol)` over Zipf(1.2) symbols) and Z (pol2Cart, a 10 s hopping
    window of 1 s hops, `[x > 0.0]`, per-symbol sums; and a cron tumble
    every second, events ~12 ms apart) at 4 rounds of 512: the port
    against the JAX package event for event (Z's sums within rtol 1e-5),
    and against chip_smoke.py's numpy oracles."""
    cs = _chip_smoke()
    _, want = run_app(siddhi_tpu, cs, name)
    check, got = run_app(siddhi_tpu_torch, cs, name, device="cpu")
    if name == "Y":
        # frequent(64) keeps nothing here: each batch holds more distinct
        # keys than slots, and the batched decrement clears every counter
        # (ROADMAP.md Queue 3); frequent(250) tracks a batch's ~240 keys
        # and evicts at the decrements, lossyFrequent's 10,000 slots keep
        # them
        assert want["OutStream"] == [] and got["OutStream"] == []
        assert_apps_equal({"WideOut": want["WideOut"],
                           "LossyOut": want["LossyOut"]}, got)
    else:
        assert_apps_equal({"CronOut": want["CronOut"]}, got)
        w, g = want["OutStream"], got["OutStream"]
        assert len(g) == len(w) > 0
        for a, b in zip(w, g):
            assert a.timestamp == b.timestamp and a.data[0] == b.data[0]
            assert a.data[2] == b.data[2]
            assert b.data[1] == pytest.approx(a.data[1], rel=FLOAT_RTOL,
                                              abs=FLOAT_ATOL)
    assert check(got) == sum(len(v) for v in got.values())


# ------------------------------------------------ cron across a DST change


@pytest.fixture
def new_york():
    """The process time zone set to America/New_York, restored after."""
    import os
    import time
    old = os.environ.get("TZ")
    os.environ["TZ"] = "America/New_York"
    time.tzset()
    yield
    if old is None:
        os.environ.pop("TZ", None)
    else:
        os.environ["TZ"] = old
    time.tzset()


def _cron_dst_run(pkg, **kw):
    """cron('0 30 1 * * ?') over 6 rounds of 64 events a minute apart from
    2026-11-01T03:00Z (the fall-back night: 01:30 local comes twice), then
    a heartbeat an hour after the last event."""
    app = ("@app:playback define stream S (symbol string, price double, "
           "volume long, k int); from S#window.cron('0 30 1 * * ?') select "
           "symbol, price insert all events into Out;")
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(app,
                                                           batch_size=64)
    got = []
    rt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    t0 = 1_793_502_000_000  # 2026-11-01T03:00Z
    h = rt.get_input_handler("S")
    for r in range(6):
        i = np.arange(r * 64, (r + 1) * 64)
        h.send_columns({"symbol": np.array([f"s{j % 7}" for j in i],
                                           dtype=object),
                        "price": i * 0.5, "volume": i.astype(np.int64),
                        "k": (i % 5).astype(np.int32)},
                       timestamps=t0 + i * 60_000)
        rt.flush()
    rt.heartbeat(t0 + 383 * 60_000 + 3_600_000)
    return got


def test_cron_repeats_the_jax_fire_after_a_fall_back_change(new_york):
    """The reference's next fire inside the repeated hour is the hour's
    first 01:30 (05:30Z), before its argument (06:11Z), so it fires again
    one step later: 192 events at the 01:30 EDT fire, 256 more at the next
    step, 448 in all. The port keeps that order of events exactly."""
    want = _cron_dst_run(siddhi_tpu)
    assert len(want) == 448
    assert _cron_dst_run(siddhi_tpu_torch, device="cpu") == want


@pytest.mark.parametrize("expr", ["0 30 1 * * ?", "0 */20 * * * ?",
                                  "30 0 2 * * ?"])
def test_cron_fire_table_is_exact_across_dst_changes(new_york, expr):
    """The table's answer against `next_fire_ms` itself at instants 7 s
    apart through both 2026 changes (March 8 and November 1), the fall-back
    hour and the spring-forward gap included."""
    from siddhi_tpu.core.trigger import CronSchedule as JCron
    from siddhi_tpu_torch.core.trigger import CronSchedule
    ref = JCron(expr)
    for start in (1_772_935_200_000, 1_793_498_400_000):  # 02:00Z those days
        table = twx.CronFireTable(CronSchedule(expr))
        xs = start + np.arange(0, 6 * 3_600_000, 7_001)
        for x in xs.tolist():
            dev = table.table(x, torch.device("cpu"))
            assert table.next_after(x) == ref.next_fire_ms(x), x
            got = int(table.first_schedule(dev, torch.tensor(x - 1)))
            assert got == ref.next_fire_ms(x - 1), x
