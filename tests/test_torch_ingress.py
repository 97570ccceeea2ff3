"""@Async ingestion of siddhi_tpu_torch (core/stream.py, core/ingress.py,
the native rings of csrc/host_columnar.c, the auto-flusher of
core/app_runtime.py) against the JAX package on the CPU.

`@Async(buffer.size=N)` sets the junction's micro-batch: the frequent
window's witness below emits the JAX package's events only when it does.
The parallel pipeline must be invisible downstream: one producer's rows
and columns give the blocks the JAX package's pipeline gives (timestamps,
expiry, every column including string codes, exact), on the native ring
and on the Python ring. Several producers keep every row. The drop
policies count every shed row exactly on an unstarted runtime (no feeder:
the admission decisions are deterministic). Every runtime is shut down in
`finally`, no thread the port started outlives it, and a drain that does
not finish raises.
"""

import threading
import time

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core import ingress as tingress
from siddhi_tpu_torch.errors import SiddhiAppCreationError

BS = 64
DRAIN_S = 30.0

APP_PIPE = f"""
@app:name('Pipe')
@Async(buffer.size='{BS}', workers='2')
define stream TradeStream (symbol string, price double, volume long);
@info(name='q')
from TradeStream[price < 700.0]
select symbol, price, volume
insert into OutStream;
"""


@pytest.fixture(autouse=True)
def _bounded_drain(monkeypatch):
    monkeypatch.setattr(tingress, "DRAIN_TIMEOUT_S", DRAIN_S)
    monkeypatch.delenv("SIDDHI_SUPERSTEP_K", raising=False)
    monkeypatch.delenv("SIDDHI_INGRESS_WORKERS", raising=False)


def _ours():
    return {t for t in threading.enumerate() if t.name.startswith("siddhi-")}


def _rows(n: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 40, n)
    ps = rng.uniform(1.0, 1000.0, n)
    vs = rng.integers(1, 1000, n)
    rows = [(f"S{int(k)}", float(p), int(v)) for k, p, v in zip(ks, ps, vs)]
    for i in range(0, n, 17):  # nulls through the string column
        rows[i] = (None,) + rows[i][1:]
    return rows


def _columns(rows):
    return {"symbol": np.array([r[0] for r in rows], dtype=object),
            "price": np.array([r[1] for r in rows]),
            "volume": np.array([r[2] for r in rows], dtype=np.int64)}


def _manager(torch_side: bool):
    return (siddhi_tpu_torch.SiddhiManager(device="cpu") if torch_side
            else siddhi_tpu.SiddhiManager())


def run(app: str, feed, torch_side: bool = True, out: str = "OutStream",
        start: bool = True, **kw):
    """Build, feed via `feed(runtime)`, drain, shut down; returns (columnar
    blocks, runtime)."""
    before = _ours()
    rt = _manager(torch_side).create_siddhi_app_runtime(app, **kw)
    blocks: list = []
    rt.add_callback(out, lambda b: blocks.append(
        (b.timestamps.copy(), {k: v.copy() for k, v in b.columns.items()},
         b.is_expired.copy())), columnar=True)
    if start:
        rt.start()
    try:
        feed(rt)
        rt.drain()
    finally:
        rt.shutdown()
    if torch_side:
        assert not (_ours() - before), "threads left after shutdown"
    return blocks, rt


def assert_blocks_identical(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for (gt, gc, ge), (wt, wc, we) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge, we)
        assert gc.keys() == wc.keys()
        for k in wc:
            assert gc[k].dtype == wc[k].dtype, k
            np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)


def test_async_buffer_size_sets_the_batch():
    """The witness: frequent(3, symbol) is batch-shaped, so it emits the
    JAX package's events only with its micro-batch of 4."""
    app = ("@Async(buffer.size='4') define stream S (symbol string, v long);"
           "\n@info(name='q') from S#window.frequent(3, symbol) "
           "select symbol, v insert into Out;")

    def feed(rt):
        h = rt.get_input_handler("S")
        for i in range(16):
            h.send((f"s{(i // 2) % 4}", i), timestamp=1000 + i)

    got = {}
    for torch_side in (False, True):
        rt = _manager(torch_side).create_siddhi_app_runtime(app)
        evs: list = []
        rt.add_callback("Out", lambda e, evs=evs: evs.extend(
            (x.timestamp, tuple(x.data)) for x in e))
        try:
            feed(rt)
            rt.flush()
            assert rt.junctions["S"].batch_size == 4
        finally:
            rt.shutdown()
        got[torch_side] = evs
    assert got[True] == got[False]
    assert [d for _, d in got[True]] == [
        ("s0", 0), ("s0", 1), ("s1", 2), ("s1", 3),
        ("s0", 8), ("s0", 9), ("s1", 10), ("s1", 11)]


@pytest.mark.parametrize("path", ["rows", "columns"])
def test_pipeline_bit_parity_with_jax(path):
    rows = _rows(500 if path == "rows" else 300, seed=12)
    tss = np.arange(1, len(rows) + 1, dtype=np.int64)

    def feed(rt):
        h = rt.get_input_handler("TradeStream")
        if path == "rows":
            h.send_batch(rows, timestamps=tss)
        else:
            h.send_columns(_columns(rows), timestamps=tss)
        rt.flush()

    want, _ = run(APP_PIPE, feed, torch_side=False)
    seen: dict = {}

    def feed_t(rt):
        p = rt.junctions["TradeStream"]._pipeline
        assert p is not None, "the pipeline did not engage"
        feed(rt)
        seen.update(p.stats_snapshot())

    got, _ = run(APP_PIPE, feed_t)
    assert sum(len(b[0]) for b in got) > 0
    assert_blocks_identical(got, want)
    assert seen["rows_in"] == len(rows)
    assert seen["batches_delivered"] >= len(rows) // BS
    assert seen["ring_depth_hwm"] >= 1
    assert set(seen["stage_ms"]) == {"decode", "intern", "h2d", "device"}


def test_python_ring_selected_without_native(monkeypatch):
    rows = _rows(300, seed=13)
    tss = np.arange(1, 301, dtype=np.int64)
    rings = []

    def feed(rt):
        rings.append(type(rt.junctions["TradeStream"]._pipeline.ring))
        rt.get_input_handler("TradeStream").send_batch(rows, timestamps=tss)

    native_blocks, _ = run(APP_PIPE, feed)
    monkeypatch.setenv("SIDDHI_NATIVE", "0")
    py_blocks, _ = run(APP_PIPE, feed)
    assert rings[1] is tingress._PyColRing
    assert_blocks_identical(py_blocks, native_blocks)


def test_multi_producer_conservation():
    n_prod, per = 4, 700
    counts = {"out": 0}
    app = APP_PIPE.replace("[price < 700.0]", "")

    def feed(rt):
        h = rt.get_input_handler("TradeStream")

        def producer(p):
            rows = _rows(per, seed=100 + p)
            for i in range(0, per, 50):  # runs of 50, interleaved
                h.send_batch(rows[i:i + 50], timestamps=p * 10_000 + i)

        ts = [threading.Thread(target=producer, args=(p,))
              for p in range(n_prod)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=DRAIN_S)
        assert not any(t.is_alive() for t in ts)

    blocks, rt = run(app, feed)
    counts["out"] = sum(len(b[0]) for b in blocks)
    assert counts["out"] == n_prod * per


def test_mpsc_ring_feeder_delivers_every_row():
    """workers = 0: the native MPSC ring and its feeder thread."""
    app = APP_PIPE.replace(", workers='2'", "")
    rows = _rows(400, seed=14)

    def feed(rt):
        j = rt.junctions["TradeStream"]
        assert j._pipeline is None and j._ring is not None
        h = rt.get_input_handler("TradeStream")
        for i, r in enumerate(rows):
            h.send(r, timestamp=i + 1)

    want = [r for r in rows if r[1] < 700.0]
    blocks, _ = run(app, feed)
    assert sum(len(b[0]) for b in blocks) == len(want)


def _bounded(policy: str, cap: int = 8):
    app = ("@app:name('BP')\n"
           f"@Async(buffer.size='4', overflow.policy='{policy}', "
           f"max.staged='{cap}')\n"
           "define stream S (v long);\n"
           "@info(name='q') from S select v insert into Out;")
    rt = siddhi_tpu_torch.SiddhiManager(
        device="cpu").create_siddhi_app_runtime(app)
    got: list = []
    rt.add_callback("Out", lambda evs: got.extend(e.data[0] for e in evs))
    return rt, got


@pytest.mark.parametrize("policy,kept", [("drop.new", list(range(8))),
                                         ("drop.old", list(range(12, 20)))])
def test_overflow_policy_counts_exactly(policy, kept):
    rt, got = _bounded(policy)
    try:
        h = rt.get_input_handler("S")
        for i in range(20):
            h.send((i,))
        rt.flush()
        rep = rt.statistics_report()
    finally:
        rt.shutdown()
    assert got == kept
    assert rep["ingress_dropped"] == {"S": {policy: 12}}
    assert rep["backpressure"]["queue_hwm"]["S"] == 8


@pytest.mark.parametrize("ann,match", [
    ("@Async(buffer.size='4', overflow.policy='fault')",
     "ROADMAP Queue 1 item 5"),
    ("@Async(buffer.size='4', overflow.policy='spill')",
     "must be block | drop.new | drop.old | fault"),
    ("@Async(buffer.size='16', overflow.policy='drop.new', max.staged='8')",
     r"max.staged \(8\) must be >= buffer.size \(16\)"),
    ("@Async(buffer.size='4', high.watermark='0.2', low.watermark='0.5')",
     "need 0 <= low.watermark < high.watermark <= 1"),
    ("@app:superstep(k='eight')\n@Async(buffer.size='4')",
     "@app:superstep k must be an integer, got 'eight'"),
])
def test_async_annotation_refusals(ann, match):
    """The JAX package's refusal texts; `fault` names the item it waits
    for."""
    app = ann + "\ndefine stream S (v long);\nfrom S select v insert into Out;"
    with pytest.raises(SiddhiAppCreationError, match=match):
        siddhi_tpu_torch.SiddhiManager(
            device="cpu").create_siddhi_app_runtime(app)


def test_auto_flush_delivers_without_a_caller_flush():
    before = _ours()
    app = ("define stream S (v double);\n"
           "from S[v > 0.0] select v insert into Out;")
    rt = siddhi_tpu_torch.SiddhiManager(
        device="cpu").create_siddhi_app_runtime(
        app, batch_size=256, auto_flush_ms=10)
    got: list = []
    rt.add_callback("Out", lambda evs: got.extend(e.data for e in evs))
    rt.start()
    try:
        rt.get_input_handler("S").send((1.0,))
        t0 = time.perf_counter()
        while not got and time.perf_counter() - t0 < 10:
            time.sleep(0.005)
    finally:
        rt.shutdown()
    assert got == [(1.0,)]
    assert not (_ours() - before)


def test_auto_flush_annotation_enables_the_flusher():
    app = ("@app:autoFlush(interval='25 ms')\n"
           "define stream S (v double);\n"
           "from S select v insert into Out;")
    rt = siddhi_tpu_torch.SiddhiManager(
        device="cpu").create_siddhi_app_runtime(app)
    assert rt.auto_flush_ms == 25
    rt.start()
    try:
        assert rt._flusher_thread is not None
        assert rt._flusher_thread.is_alive()
    finally:
        rt.shutdown()
    assert rt._flusher_stop is None and rt._flusher_thread is None
