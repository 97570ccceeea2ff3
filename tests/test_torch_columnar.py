"""The columnar output and ingest path of siddhi_tpu_torch against the JAX
package on the CPU: the wire packing (kernel K12a's plain version) against
`_wire_pack` / `_wire_unpack`, ColumnarBlock and Event callbacks, sync and
with `async_callbacks=True` + `drain()`, for BASELINE configs 1 and 2, a
sliding `insert all events` query, a join and a pattern; the async
decoder's ordering and error handling; the capacity-overflow sweep; and
`interop.load_strings` with a snapshot holding transient codes.

Inputs are made with numpy from a seed and handed to both packages.
Timestamps, `is_expired`, integer columns, string codes, strings and block
counts are exact; float columns within rtol 1e-5 plus atol 1e-3 (the
float32 accumulation order and removal residues of sliding sums,
tests/test_numeric_parity.py); the packed buffer's words exact.
"""

import logging
import warnings

import jax
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import dtypes as jdtypes
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.core.stream import _wire_pack, _wire_unpack
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import dtypes as tdtypes
from siddhi_tpu_torch.ops import wire

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3
BATCH = 128
ROUNDS = 4

# ---------------------------------------------------------------- K12a plain

B = 96
_DTYPES = {"i32": np.int32, "i64": np.int64, "f32": np.float32,
           "f64": np.float64, "b": np.bool_, "i8": np.int8}
_TORCH = {np.int32: torch.int32, np.int64: torch.int64,
          np.float32: torch.float32, np.float64: torch.float64,
          np.bool_: torch.bool, np.int8: torch.int8}


def _wire_inputs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    ts = 1_700_000_000_000 + np.cumsum(rng.integers(0, 5, B)).astype(np.int64)
    valid = rng.random(B) < 0.4
    if case == "all":
        valid[:] = True
    elif case == "none":
        valid[:] = False
    valid[0] = case != "none"
    ts_v = np.nonzero(valid)[0]
    if case == "span_max":  # the largest span that fits 32 bits
        ts[ts_v[-1]] = ts[ts_v[0]] + 0xFFFFFFFF
    elif case == "span_over":  # one past it
        ts[ts_v[-1]] = ts[ts_v[0]] + (1 << 32)
    elif case == "wrap":  # the int64 delta itself wraps
        ts[ts_v[0]] = -(1 << 62) - 10
        ts[ts_v[-1]] = (1 << 62) + 10
    elif case == "sentinel":  # every valid ts at or past _wire_pack's 2^62
        ts[valid] = (1 << 62) + np.arange(valid.sum())
    types = rng.choice(np.array([0, 1, 3], np.int8), B)  # CURRENT/EXPIRED/RESET
    cols = {"i32": rng.integers(-2**31, 2**31, B).astype(np.int32),
            "i64": rng.integers(-2**62, 2**62, B),
            "f32": rng.normal(size=B).astype(np.float32),
            "f64": rng.normal(size=B),
            "b": rng.random(B) < 0.5,
            "i8": rng.integers(-128, 128, B).astype(np.int8)}
    cols["f32"][3] = np.nan
    return ts, valid, types, cols


@pytest.mark.parametrize("case", ["all", "none", "sparse", "span_max",
                                  "span_over", "wrap", "sentinel"])
def test_wire_pack_plain_matches_jax(case):
    ts, valid, types, cols = _wire_inputs(case)
    jb = JBatch(ts=jax.numpy.asarray(ts),
                cols={k: jax.numpy.asarray(v) for k, v in cols.items()},
                valid=jax.numpy.asarray(valid),
                types=jax.numpy.asarray(types))
    packed = jax.device_get(jax.jit(_wire_pack)(jb))
    ts0, dts, flags, _, over = packed
    jhost = _wire_unpack(packed)
    idx = np.nonzero(np.asarray(jhost.valid))[0]
    # the JAX reader re-reads the raw batch when `over` is set
    want_ts = ts[idx] if bool(over) else np.asarray(jhost.ts)[idx]

    tcols = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
    layout = wire.layout_of(torch.from_numpy(ts), tcols)
    buf = wire.wire_pack_plain(torch.from_numpy(ts), torch.from_numpy(valid),
                               torch.from_numpy(types), tcols, layout)
    assert buf.dtype == torch.uint8 and buf.shape == (layout.nbytes,)
    host = buf.numpy()
    got = wire.wire_unpack(host, layout)
    assert (got.count, got.ts0, got.over) == (idx.size, int(ts0), bool(over))
    # the packed words over the valid lanes are _wire_pack's
    n = idx.size
    assert np.array_equal(
        host[layout.dts_offset:layout.dts_offset + 4 * n].view(np.uint32),
        np.asarray(dts)[idx])
    assert np.array_equal(
        host[layout.flags_offset:layout.flags_offset + n],
        np.asarray(flags)[idx])
    assert np.array_equal(got.ts, want_ts)
    assert np.array_equal(got.types, np.asarray(jhost.types)[idx])
    for k, v in cols.items():
        g, w = got.cols[k], np.asarray(jhost.cols[k])[idx]
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes(), k  # bit for bit, NaN included
    # the payload a reader uses: the header and `count` entries a region
    width = sum(v.itemsize for v in cols.values())
    payload = wire.wire_payload(buf, layout).numpy()
    assert payload.size == wire.HEADER_BYTES + n * (4 + 4 + 1 + width)
    assert np.array_equal(payload[:wire.HEADER_BYTES],
                          host[:wire.HEADER_BYTES])


def test_wire_layout_regions_are_aligned_and_dense():
    cols = {k: torch.zeros(37, dtype=_TORCH[v]) for k, v in _DTYPES.items()}
    layout = wire.layout_of(torch.zeros(37, dtype=torch.int64), cols)
    regions = sorted([(0, wire.HEADER_BYTES),
                      (layout.dts_offset, 4 * 37), (layout.hi_offset, 4 * 37),
                      (layout.flags_offset, 37)]
                     + [(o, cols[k].element_size() * 37)
                        for k, o in zip(layout.names, layout.col_offsets)])
    at = 0
    for off, size in regions:
        assert off == at
        at += size
    assert at == layout.nbytes
    for k, o in zip(layout.names, layout.col_offsets):
        assert o % cols[k].element_size() == 0


def test_cuda_batch_never_reaches_the_plain_pack(monkeypatch):
    # the dispatcher sends a CUDA tensor to K12a: on a machine without the
    # kernel built it raises, it never runs wire_pack_plain
    calls = []
    monkeypatch.setattr(wire, "wire_pack_cuda",
                        lambda *a: calls.append("cuda") or torch.zeros(1))
    monkeypatch.setattr(wire, "wire_pack_plain",
                        lambda *a: pytest.fail("plain pack on a CUDA batch"))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    ts = torch.zeros(16, dtype=torch.int64).as_subclass(FakeCuda)
    wire.wire_pack(ts, torch.zeros(16, dtype=torch.bool),
                   torch.zeros(16, dtype=torch.int8), {})
    assert calls == ["cuda"]


# ------------------------------------------------------- ColumnarBlock parity

TRADES = "define stream TradeStream (symbol string, price double, volume long);\n"
APPS = {
    "config1": (TRADES + "@info(name = 'bench')\n"
                "from TradeStream[700.0 > price]\n"
                "select symbol, price\ninsert into OutStream;",
                "trades", {"n_keys": 50, "price_hi": 1000.0}),
    "config2": (TRADES + "@info(name = 'bench')\n"
                "from TradeStream#window.lengthBatch(16)\n"
                "select symbol, sum(price) as total, avg(price) as avgPrice\n"
                "group by symbol\ninsert into OutStream;",
                "trades", {"n_keys": 20, "price_hi": 100.0}),
    "sliding_all": (TRADES + "@info(name = 'bench')\n"
                    "from TradeStream#window.length(40)\n"
                    "select symbol, sum(price) as total, count() as n, "
                    "volume > 500 as big\ngroup by symbol\n"
                    "insert all events into OutStream;",
                    "trades", {"n_keys": 12, "price_hi": 100.0}),
    "join": ("define stream L (k int, v double);\n"
             "define stream R (k int, v double);\n"
             "@info(name = 'bench')\n"
             "from L#window.length(64) as a join R#window.length(64) as b\n"
             "on a.k == b.k\n"
             "select a.k as k, a.v as lv, b.v as rv\ninsert into OutStream;",
             "join", {}),
    "pattern": ("@app:playback\n"
                "define stream StreamA (val int, sym string);\n"
                "define stream StreamB (val int, sym string);\n"
                "@info(name = 'bench')\n"
                "from every a=StreamA -> b=StreamB[b.val == a.val] "
                "within 5 sec\n"
                "select a.sym as sym, a.val as val, b.val as bval\n"
                "insert into OutStream;",
                "pattern", {}),
}


def _feeds(kind: str, seed: int, n_keys=0, price_hi=0.0):
    """[(stream, columns, timestamps)] sends, each followed by a flush."""
    rng = np.random.default_rng(seed)
    feeds = []
    base = 1_000
    for r in range(ROUNDS):
        if kind == "trades":
            pool = np.array([f"S{i}" for i in range(n_keys)] + [None],
                            dtype=object)
            sym = pool[rng.integers(0, n_keys + 1, BATCH)]
            cols = {"symbol": sym, "price": rng.uniform(0, price_hi, BATCH),
                    "volume": rng.integers(1, 1000, BATCH)}
            feeds.append(("TradeStream", cols,
                          base + r * BATCH + np.arange(BATCH)))
        elif kind == "join":
            for side, off in (("L", 0), ("R", BATCH)):
                cols = {"k": rng.integers(1, 40, BATCH).astype(np.int32),
                        "v": rng.uniform(1, 100, BATCH)}
                feeds.append((side, cols, base + 2 * r * BATCH + off
                              + np.arange(BATCH)))
        else:
            for side, off in (("StreamA", 0), ("StreamB", BATCH)):
                cols = {"val": rng.integers(0, 60, BATCH).astype(np.int32),
                        "sym": np.array([f"P{v}" for v in
                                         rng.integers(0, 9, BATCH)],
                                        dtype=object)}
                feeds.append((side, cols, base + 2 * r * BATCH + off
                              + np.arange(BATCH)))
    return feeds


def _run_blocks(pkg, app, feeds, async_cb, **mgr_kw):
    """Blocks (as plain data) and the Event lists of both callback forms
    subscribed to OutStream."""
    rt = pkg.SiddhiManager(**mgr_kw).create_siddhi_app_runtime(
        app, batch_size=BATCH, group_capacity=256,
        async_callbacks=async_cb)
    blocks, events, q_events = [], [], []
    rt.add_callback("OutStream", blocks.append, columnar=True)
    rt.add_callback("OutStream", events.append)

    def on_query(ts, ins, rems):
        q_events.extend((e.timestamp, tuple(e.data), e.is_expired)
                        for e in (ins or []) + (rems or []))

    rt.add_query_callback("bench", on_query)
    rt.start()
    for stream, cols, ts in feeds:
        rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
        rt.flush()
    rt.drain()
    # shutdown joins the decoder's delivery thread: drain can return while
    # the last batch's callback is still running on it
    rt.shutdown()
    out = []
    for b in blocks:
        strs = {a.name: b.strings(a.name)
                for a in b._codec.definition.attributes
                if a.type.name == "STRING"}
        out.append((b.count, len(b), b.timestamps, b.is_expired,
                    dict(b.columns), strs,
                    [(e.timestamp, tuple(e.data), e.is_expired)
                     for e in b.to_events()]))
    evs = [[(e.timestamp, tuple(e.data), e.is_expired) for e in batch]
           for batch in events]
    return out, evs, q_events


def _same_event(w, g):
    assert (g[0], g[2]) == (w[0], w[2])
    for a, b in zip(w[1], g[1]):
        if isinstance(a, float):
            assert isinstance(b, float)
            np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        else:
            assert b == a


@pytest.mark.parametrize("async_cb", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("name", list(APPS))
def test_columnar_blocks_match_jax(name, async_cb):
    app, kind, kw = APPS[name]
    feeds = _feeds(kind, seed=list(APPS).index(name), **kw)
    want, want_ev, want_q = _run_blocks(siddhi_tpu, app, feeds, async_cb)
    got, got_ev, got_q = _run_blocks(siddhi_tpu_torch, app, feeds, async_cb,
                                     device="cpu")
    assert len(want) > 0
    assert [b[0] for b in got] == [b[0] for b in want]  # block boundaries
    for w, g in zip(want, got):
        assert g[1] == w[1]
        assert g[2].dtype == np.int64 and np.array_equal(g[2], w[2])
        assert g[3].dtype == np.bool_ and np.array_equal(g[3], w[3])
        assert set(g[4]) == set(w[4])
        for k, wc in w[4].items():
            gc = g[4][k]
            assert gc.dtype == wc.dtype, k
            if wc.dtype.kind == "f":
                np.testing.assert_allclose(gc, wc, rtol=FLOAT_RTOL,
                                           atol=FLOAT_ATOL)
            else:
                assert np.array_equal(gc, wc), k
        assert g[5] == w[5]
        assert len(g[6]) == len(w[6])
        for we, ge in zip(w[6], g[6]):
            _same_event(we, ge)
    # the Event callback sees the same batches
    assert [len(b) for b in got_ev] == [len(b) for b in want_ev]
    for wb, gb in zip(want_ev, got_ev):
        for we, ge in zip(wb, gb):
            _same_event(we, ge)
    # the query callback reads back through the same packed path
    assert len(got_q) == len(want_q)
    for we, ge in zip(want_q, got_q):
        _same_event(we, ge)
    if name == "sliding_all":
        # expired rows reach the stream as rows, and the query callback as
        # remove events
        assert sum(b[0] for b in got) > ROUNDS * BATCH
        assert any(e[2] for e in got_q)


# ------------------------------------------------------- the async decoder

FILTER = APPS["config1"][0]


def _filter_rt(async_cb=True):
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(FILTER, batch_size=64,
                                   async_callbacks=async_cb)
    return rt


def test_async_order_across_fifty_batches():
    rng = np.random.default_rng(7)
    n = 64 * 50
    price = rng.uniform(0, 1000, n)
    sym = np.array([f"S{i % 97}" for i in range(n)], dtype=object)
    ts = 5_000 + np.arange(n)
    rt = _filter_rt()
    blocks, events = [], []
    rt.add_callback("OutStream", blocks.append, columnar=True)
    rt.add_callback("OutStream", events.extend)
    rt.start()
    assert rt.ctx.decoder is not None
    h = rt.get_input_handler("TradeStream")
    for r in range(50):
        s = slice(r * 64, (r + 1) * 64)
        h.send_columns({"symbol": sym[s], "price": price[s],
                        "volume": np.ones(64, np.int64)}, timestamps=ts[s])
        rt.flush()
    rt.drain()
    keep = price.astype(np.float32) < np.float32(700.0)
    assert len(blocks) == 50
    got_ts = np.concatenate([b.timestamps for b in blocks])
    assert np.array_equal(got_ts, ts[keep])
    assert [e.timestamp for e in events] == ts[keep].tolist()
    assert [e.data[0] for e in events] == sym[keep].tolist()
    rt.shutdown()
    assert rt.ctx.decoder is None


def test_raising_async_callback_is_logged_and_delivery_goes_on(caplog):
    rt = _filter_rt()
    seen = []

    def cb(block):
        seen.append(int(block.timestamps[0]))
        if len(seen) == 2:
            raise RuntimeError("callback fault")

    rt.add_callback("OutStream", cb, columnar=True)
    rt.start()
    h = rt.get_input_handler("TradeStream")
    with caplog.at_level(logging.ERROR, logger="siddhi_tpu_torch"):
        for r in range(5):
            h.send_columns({"symbol": np.array(["A"] * 8, dtype=object),
                            "price": np.full(8, 1.0),
                            "volume": np.ones(8, np.int64)},
                           timestamps=100 * r + np.arange(8))
            rt.flush()
        rt.drain()
    assert seen == [0, 100, 200, 300, 400]
    assert any("async stream callback failed" in r.message
               for r in caplog.records)
    rt.shutdown()


def test_async_decoder_keeps_order_under_stress(monkeypatch):
    """More fetch workers than cores, a short switch interval and readbacks
    that finish out of order: every submission is delivered once, in
    submit order, and every thread ends."""
    import sys
    import threading
    import time

    from siddhi_tpu_torch.core.stream import AsyncDecoder

    monkeypatch.setattr(AsyncDecoder, "N_FETCH", 16)
    delays = np.random.default_rng(11).uniform(0, 0.002, 300)

    class FakeReadback:
        def __init__(self, i):
            self.i = i

        def result(self):
            time.sleep(delays[self.i])
            return self.i

    got = []

    class Receiver:
        def on_host(self, host, now):
            got.append((host, now))

    decoders = []

    def run():
        dec = AsyncDecoder(maxsize=8)
        decoders.append(dec)
        r = Receiver()
        for i in range(300):
            dec.submit(r, FakeReadback(i), i)
        dec.stop()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert got == [(i, i) for i in range(300)]
    assert not any(th.is_alive() for th in decoders[0]._threads)


def test_sync_callbacks_need_no_drain_and_flush_delivers():
    rt = _filter_rt(async_cb=False)
    got = []
    rt.add_callback("OutStream", got.append, columnar=True)
    rt.start()
    assert rt.ctx.decoder is None
    rt.get_input_handler("TradeStream").send(("A", 5.0, 1), timestamp=9)
    rt.flush()
    assert [b.count for b in got] == [1]
    assert got[0].strings("symbol") == ["A"]
    rt.shutdown()


# ------------------------------------------------------- the overflow sweep

HLL_WITNESS = ("define stream T (symbol string, price double, volume long);\n"
               "from T#window.length(50) select symbol, "
               "hll:distinctCount(volume) as d group by symbol "
               "insert into O;")


def _overflow_run(pkg, app, sends, *, batch_size, group_capacity=0,
                  config=None, heartbeat_at=None, **mgr_kw):
    """Run `sends` ([(stream, rows, ts)]), heartbeat, and return the
    statistics' overflow dict and the overflow warnings."""
    cfg = (jdtypes if pkg is siddhi_tpu else tdtypes).config
    prev = {k: getattr(cfg, k) for k in (config or {})}
    for k, v in (config or {}).items():
        setattr(cfg, k, v)
    try:
        rt = pkg.SiddhiManager(**mgr_kw).create_siddhi_app_runtime(
            app, batch_size=batch_size, group_capacity=group_capacity)
    finally:
        for k, v in prev.items():
            setattr(cfg, k, v)
    out = "O" if "insert into O;" in app else "Out"
    rt.add_callback(out, lambda evs: None)
    rt.start()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for stream, rows, ts in sends:
            rt.get_input_handler(stream).send_batch(rows, timestamps=ts)
            rt.flush()
        rt.heartbeat(heartbeat_at)
        rt.heartbeat(heartbeat_at)  # a second sweep warns no more
    over = dict(rt.ctx.statistics.overflow)
    rt.shutdown()
    return over, [str(x.message) for x in w
                  if "exceeded a fixed device capacity" in str(x.message)]


def test_hll_witness_warns_once_with_the_jax_text():
    # the witness's shape: 400 events over 200 symbols in 7 batches of at
    # most 64, group_capacity 64, then a heartbeat; seeded data
    rng = np.random.default_rng(0)
    rows = [(f"S{int(k)}", float(p), int(v)) for k, p, v in zip(
        rng.integers(0, 200, 400), rng.uniform(1, 100, 400),
        rng.integers(1, 1000, 400))]
    sends = [("T", rows[i:i + 64], list(range(1000 + i, 1000 + i + 64))[
        :len(rows[i:i + 64])]) for i in range(0, 400, 64)]
    want, want_w = _overflow_run(siddhi_tpu, HLL_WITNESS, sends,
                                 batch_size=64, group_capacity=64,
                                 heartbeat_at=2000)
    got, got_w = _overflow_run(siddhi_tpu_torch, HLL_WITNESS, sends,
                               batch_size=64, group_capacity=64,
                               heartbeat_at=2000, device="cpu")
    assert want == {"query:query1.hll_groups_dropped": 225}
    assert got == want
    assert len(got_w) == 1 and got_w == want_w
    assert got_w[0].startswith("query:query1.hll_groups_dropped: 225 rows "
                               "exceeded a fixed device capacity")


def test_window_ring_overflow_matches_jax():
    app = ("define stream S (k int);\n@info(name='q')\n"
           "from S#window.time(1 hour) select count() as n insert into Out;")
    n = 2048
    sends = [("S", [(i,) for i in range(s, s + 256)],
              list(range(10_000 + s, 10_000 + s + 256)))
             for s in range(0, n, 256)]
    kw = dict(batch_size=256, config={"default_window_capacity": 16},
              heartbeat_at=10_000 + n)
    want, want_w = _overflow_run(siddhi_tpu, "@app:playback\n" + app, sends,
                                 **kw)
    got, got_w = _overflow_run(siddhi_tpu_torch, "@app:playback\n" + app,
                               sends, device="cpu", **kw)
    assert want.get("query:q.window_ring_overflow", 0) >= n - 1024
    assert got == want and got_w == want_w


def test_key_table_misses_match_jax():
    app = ("define stream S (k int, v double);\n@info(name='g')\n"
           "from S select k, sum(v) as total group by k insert into Out;")
    sends = [("S", [(i, 1.0) for i in range(64)], list(range(64)))]
    want, want_w = _overflow_run(siddhi_tpu, app, sends, batch_size=64,
                                 group_capacity=8, heartbeat_at=100)
    got, got_w = _overflow_run(siddhi_tpu_torch, app, sends, batch_size=64,
                               group_capacity=8, heartbeat_at=100,
                               device="cpu")
    assert want.get("query:g.key_table_unresolved", 0) > 0
    assert got == want and got_w == want_w


def test_pattern_pending_drops_match_jax():
    app = ("define stream A (v int);\ndefine stream B (v int);\n"
           "@info(name='p')\nfrom every a=A -> b=B[b.v == a.v]\n"
           "select a.v as av insert into Out;")
    sends = [("A", [(i,) for i in range(64)], list(range(64)))]
    kw = dict(batch_size=64, config={"pattern_pending_capacity": 8},
              heartbeat_at=100)
    want, want_w = _overflow_run(siddhi_tpu, app, sends, **kw)
    got, got_w = _overflow_run(siddhi_tpu_torch, app, sends, device="cpu",
                               **kw)
    assert want.get("query:p.pattern_pending_dropped", 0) >= 64 - 8
    assert got == want and got_w == want_w


def test_join_pair_drops_match_jax():
    app = ("define stream L (k int);\ndefine stream R (k int);\n"
           "@info(name='j')\nfrom L#window.length(1000) as a\n"
           "join R#window.length(1000) as b\non a.k == b.k\n"
           "select a.k as k\ninsert into Out;")
    sends = [("R", [(7,)] * 64, list(range(64 * r, 64 * r + 64)))
             for r in range(8)]
    sends.append(("L", [(7,)] * 64, list(range(600, 664))))
    want, want_w = _overflow_run(siddhi_tpu, app, sends, batch_size=64,
                                 heartbeat_at=700)
    got, got_w = _overflow_run(siddhi_tpu_torch, app, sends, batch_size=64,
                               heartbeat_at=700, device="cpu")
    assert want.get("query:j.join_pairs_dropped", 0) > 0
    assert got == want and got_w == want_w


# ------------------------------------------------------- interop

def test_load_strings_takes_a_jax_snapshot_with_transient_codes():
    app = TRADES + ("@info(name = 'bench')\nfrom TradeStream select symbol, "
                    "price insert into OutStream;")
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    jt = jrt.ctx.global_strings
    for s in ("IBM", "WSO2", "ORCL"):
        jt.encode(s)
    codes = [jt.encode_transient(f"uuid-{i}", capacity=4) for i in range(6)]
    snap = jt.snapshot()
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app)
    interop.load_strings(trt, snap)
    tt = trt.ctx.global_strings
    assert tt.snapshot() == snap
    for c in [0, 1, 2, 3] + codes[2:]:
        assert tt.decode(c) == jt.decode(c)
    from siddhi_tpu_torch.errors import StaleTransientCodeError
    with pytest.raises(StaleTransientCodeError):
        tt.decode(codes[0])  # recycled by uuid-4
    # a live transient string round-trips to its code; new ones append
    assert tt.encode("uuid-5") == jt.encode("uuid-5") == codes[5]
    assert tt.encode("NEW") == jt.encode("NEW")
    # a block holding a transient code decodes through the Python path
    out = []
    trt.add_callback("OutStream", out.append, columnar=True)
    h = trt.get_input_handler("TradeStream")
    h.send_columns({"symbol": np.array([codes[5], 2], dtype=np.int32),
                    "price": np.ones(2), "volume": np.ones(2, np.int64)},
                   timestamps=[1, 2])
    trt.flush()
    assert out[0].strings("symbol") == ["uuid-5", "WSO2"]
    jrt.shutdown()
    trt.shutdown()
