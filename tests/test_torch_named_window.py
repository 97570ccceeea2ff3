"""Named windows (`define window`, `insert into W`, `from W`) of
siddhi_tpu_torch against the JAX package on the CPU: the first four cases
of tests/test_named_windows.py, a named session window closed by
heartbeats, the named-versus-inline equality behind chip_smoke.py's app U
(checked in the JAX package itself, then in the port), interop of a named
window's state, and what stays refused.

Strings, longs, timestamps and event types must be equal; floats within
rtol 1e-5 (float32 accumulation order, tests/test_numeric_parity.py) plus
atol 1e-3 for what removal leaves of a float32 sum.
"""

import jax
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.errors import SiddhiAppCreationError

from tests.test_torch_session_sort import assert_same

STOCK = ("define stream StockStream (symbol string, price float, "
         "volume long);\n")


def _build(pkg, text, batch_size=8):
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        text, batch_size=batch_size)
    rt.start()
    return rt


def _collect(rt, query_name):
    got = []
    rt.add_query_callback(query_name, lambda ts, i, r: got.append(
        ([tuple(e.data) for e in i or []], [tuple(e.data) for e in r or []])))
    return got


BASICS = {
    "insert_and_consume": (
        "define window StockWindow (symbol string, price float, volume "
        "long) lengthBatch(2);\nfrom StockStream insert into StockWindow;\n"
        "@info(name='q2') from StockWindow select symbol, sum(price) as "
        "total insert into OutputStream;",
        [("IBM", 10.0, 1), ("IBM", 20.0, 1)], False),
    "length_window_expired_events": (
        "define window W (symbol string, price float, volume long) "
        "length(2) output all events;\nfrom StockStream insert into W;\n"
        "@info(name='q2') from W select symbol, sum(price) as total "
        "insert into OutputStream;",
        [("A", 10.0, 1), ("B", 20.0, 1), ("C", 40.0, 1)], True),
    "output_current_events_only": (
        "define window W (symbol string, price float, volume long) "
        "length(1) output current events;\nfrom StockStream insert into W;\n"
        "@info(name='q2') from W select symbol, price insert into "
        "OutputStream;",
        [("A", 10.0, 1), ("B", 20.0, 1)], True),
    "positional_rename_on_insert": (
        "define window W (sym string, p float) length(5);\n"
        "from StockStream select symbol, price insert into W;\n"
        "@info(name='q2') from W select sym, max(p) as maxP insert into "
        "Out;",
        [("IBM", 12.5, 3)], True),
}


@pytest.mark.parametrize("name", sorted(BASICS))
def test_named_window_basics(name):
    """The same callbacks as the JAX package, and the assertions of
    tests/test_named_windows.py::TestNamedWindowBasics."""
    text, rows, flush_each = BASICS[name]
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = _build(pkg, STOCK + text)
        got = _collect(rt, "q2")
        h = rt.get_input_handler("StockStream")
        for row in rows:
            h.send(row)
            if flush_each:
                rt.flush()
        rt.flush()
        outs.append(got)
    want, got = outs
    assert len(got) == len(want)
    for (wi, wr), (gi, gr) in zip(want, got):
        assert len(gi) == len(wi) and len(gr) == len(wr)
        for w, g in zip(wi + wr, gi + gr):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5, atol=1e-3)
    ins = [e for i, _ in got for e in i]
    removes = [e for _, r in got for e in r]
    if name == "insert_and_consume":
        assert ins[-1][1] == pytest.approx(30.0)
    elif name == "length_window_expired_events":
        assert ins[-1][1] == pytest.approx(60.0)
    elif name == "output_current_events_only":
        assert removes == [] and [e[0] for e in ins] == ["A", "B"]
    else:
        assert ins[0] == ("IBM", pytest.approx(12.5))


SESSION_APP = (
    "@app:playback\n"
    "define stream S (symbol string, price double, volume long);\n"
    "define window SW (symbol string, price double, volume long) "
    "session(50) output all events;\n"
    "from S insert into SW;\n"
    "@info(name = 'q') from SW select symbol, sum(price) as t, count() as n "
    "group by symbol insert all events into Out;")


def _session_feeds(seed, rounds=4, n=64):
    rng = np.random.default_rng(seed)
    t, feeds = 1_000, []
    for _ in range(rounds):
        steps = np.where(rng.random(n) < 0.05, rng.integers(51, 200, n),
                         rng.integers(0, 5, n))
        ts = t + np.cumsum(steps)
        t = int(ts[-1]) + 1
        feeds.append(({"symbol": np.array(
            [f"S{i}" for i in rng.integers(0, 5, n)], dtype=object),
            "price": rng.integers(1, 40, n) * 0.25,
            "volume": rng.integers(1, 9, n).astype(np.int64)}, ts))
    return feeds


def _run(pkg, text, feeds, heartbeats=(), batch_size=64, out="Out",
         stream="S"):
    rt = _build(pkg, text, batch_size)
    got = []
    rt.add_callback(out, lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    for cols, ts in feeds:
        rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
        rt.flush()
    for hb in heartbeats:
        rt.heartbeat(hb)
    return got, rt


def test_named_session_window_closes_on_heartbeats():
    """The last sessions close only on the heartbeats past the gap: a
    named window with time semantics is stepped by rt.heartbeat."""
    feeds = _session_feeds(5)
    end = int(feeds[-1][1][-1])
    hbs = (end + 10, end + 100)
    want, _ = _run(siddhi_tpu, SESSION_APP, feeds, hbs)
    got, rt = _run(siddhi_tpu_torch, SESSION_APP, feeds, hbs)
    assert_same(want, got)
    quiet, _ = _run(siddhi_tpu_torch, SESSION_APP, feeds, (end + 10,))
    assert len(quiet) < len(got)
    assert rt.windows["SW"].has_time_semantics


TRADES = "define stream TradeStream (symbol string, price double, " \
         "volume long);\n"
#: chip_smoke.py app D's query, inline and through a named window (app U)
INLINE_D = (TRADES + "@info(name = 'bench') from TradeStream#window."
            "length(300) select symbol, sum(price) as total, count() as n "
            "group by symbol insert into OutStream;")
NAMED_D = (TRADES + "define window TradeWindow (symbol string, price "
           "double, volume long) length(300) output all events;\n"
           "from TradeStream insert into TradeWindow;\n"
           "@info(name = 'bench') from TradeWindow select symbol, "
           "sum(price) as total, count() as n group by symbol insert into "
           "OutStream;")


def _trade_feeds(seed, rounds=4, n=256):
    rng = np.random.default_rng(seed)
    return [({"symbol": np.array([f"S{i}" for i in rng.integers(1, 40, n)],
                                 dtype=object),
              "price": rng.uniform(1.0, 100.0, n),
              "volume": rng.integers(1, 1000, n).astype(np.int64)},
             1_000 + r * n + np.arange(n, dtype=np.int64))
            for r in range(rounds)]


def test_named_window_equals_the_inline_window():
    """What makes chip_smoke.py's app U checkable against oracle_d: in the
    JAX package the named form gives the inline form's events, and so
    does the port."""
    feeds = _trade_feeds(9)
    kw = dict(out="OutStream", stream="TradeStream", batch_size=256)
    j_inline, _ = _run(siddhi_tpu, INLINE_D, feeds, **kw)
    j_named, _ = _run(siddhi_tpu, NAMED_D, feeds, **kw)
    assert_same(j_inline, j_named)
    t_named, _ = _run(siddhi_tpu_torch, NAMED_D, feeds, **kw)
    assert_same(j_named, t_named)
    assert len(t_named) == 4 * 256


def test_interop_continues_a_jax_named_window():
    """The named window's state (JAX `rt.windows[name].state`) and the
    consuming query's state carried mid-run into the port."""
    feeds = _session_feeds(6)
    head, tail = feeds[:2], feeds[2:]
    jout, jrt = _run(siddhi_tpu, SESSION_APP, head)
    n_head = len(jout)
    wstate = jax.device_get(jrt.windows["SW"].state)
    qstate = jax.device_get(jrt.query_runtimes["q"].state)
    tout, trt = _run(siddhi_tpu_torch, SESSION_APP, [])
    interop.load_app_state(trt, {"q": qstate},
                           list(jrt.ctx.global_strings._to_str),
                           window_states={"SW": wstate})
    trt.ctx.timestamp_generator.observe_event_time(int(head[-1][1][-1]))
    for rt in (jrt, trt):
        for cols, ts in tail:
            rt.get_input_handler("S").send_columns(cols, timestamps=ts)
            rt.flush()
    assert len(jout) > n_head
    assert_same(jout[n_head:], tout)


@pytest.mark.parametrize("text,match", [
    ("define window W (symbol string, price float, volume long) "
     "length(5);\nfrom StockStream insert into W;\n"
     "from W#window.length(2) select symbol insert into Out;",
     "cannot take a further window"),
    ("define stream Check (symbol string);\n"
     "define window W (symbol string, price float, volume long) "
     "length(5);\nfrom StockStream insert into W;\n"
     "from Check join W on Check.symbol == W.symbol "
     "select Check.symbol as symbol insert into Out;",
     None),
    ("define window W (sym string, p float) length(5);\n"
     "from StockStream select symbol, price, volume insert into W;",
     "query emits 3 attributes, window has 2"),
    ("define window W (sym string, p double) length(5);\n"
     "from StockStream select symbol, price insert into W;",
     "attribute 'price' is FLOAT, window attribute 'p' is DOUBLE"),
], ids=["window_of_a_window", "join_side", "rename_arity", "rename_type"])
def test_refusals_match(text, match):
    """The JAX package refuses the first and last two with the same text;
    both build a join against a named window (its parity is in
    tests/test_torch_tables.py)."""
    if match is None:
        _build(siddhi_tpu, STOCK + text)
        _build(siddhi_tpu_torch, STOCK + text)
        return
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match=match):
        _build(siddhi_tpu, STOCK + text)
    with pytest.raises(SiddhiAppCreationError, match=match):
        _build(siddhi_tpu_torch, STOCK + text)


def test_pull_queries_stay_refused():
    """An on-demand query over a named window finds the window's rows as
    the JAX package does."""
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = _build(pkg, "@app:playback\n" + STOCK + "define window W "
                    "(symbol string, price float, volume long) length(3);\n"
                    "from StockStream insert into W;")
        h = rt.get_input_handler("StockStream")
        for k, sym in enumerate("abcd"):
            h.send((sym, float(k), k), timestamp=k)
        rt.flush()
        outs.append([(e.timestamp, tuple(e.data))
                     for e in rt.query("from W select symbol, price")])
    assert outs[1] == outs[0] and len(outs[0]) == 3
