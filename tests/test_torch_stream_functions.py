"""Stream functions (`#pol2Cart`, `#log`) and post-window filters of
siddhi_tpu_torch against the JAX package on the CPU, through both public
APIs on seeded feeds: pol2Cart before and after a window (two and three
arguments), log, post-window filters on their own and after a stream
function, and the refusals — min/max beside a post-window filter with the
JAX package's text, and stream functions on a join side.

Strings, longs, timestamps and event types must be equal; floats within
rtol 1e-5 (float32 accumulation order and cos/sin of float32 angles in
two libraries, tests/test_numeric_parity.py) plus atol 1e-3 for what
removal leaves of a float32 sum.
"""

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from tests.test_torch_session_sort import S, _run, assert_same

APPS = {
    "pol2cart_before_window": (
        "from S#pol2Cart(price, volume)#window.length(20) select symbol, x, "
        "y, sum(x) as sx insert all events into Out;"),
    "pol2cart_after_window": (
        "from S#window.lengthBatch(16)#pol2Cart(price, volume) select "
        "symbol, x, y insert all events into Out;"),
    "pol2cart_three_args": (
        "from S#pol2Cart(k, price, volume) select symbol, x, y, z "
        "insert into Out;"),
    "log": "from S#log(symbol)#window.length(8) select symbol, price "
           "insert all events into Out;",
    "post_filter": (
        "from S#window.length(30)[price > 12.0] select symbol, price, "
        "count() as n insert all events into Out;"),
    "pol2cart_post_filter": (
        "from S#pol2Cart(price, volume)#window.time(60)[x > 0.0 and y < "
        "20.0] select symbol, x, count() as n group by symbol insert all "
        "events into Out;"),
    "filter_fn_window_filter": (
        "from S[volume > 3]#pol2Cart(volume, price)#window.lengthBatch(10)"
        "[x < 5.0] select symbol, x, y insert all events into Out;"),
}


@pytest.mark.parametrize("name", list(APPS))
def test_apps_match_jax(name):
    """4 rounds of 512 events (prices 0.5-30 degrees on 0.5 steps, volumes
    1-40) through both packages, event for event."""
    from tests.test_torch_session_sort import _feeds
    feeds = _feeds(40 + len(name))
    want = _run(siddhi_tpu, S + APPS[name], feeds)
    got = _run(siddhi_tpu_torch, S + APPS[name], feeds, device="cpu")
    assert len(want) > 0
    assert_same(want, got)


def test_pol2cart_values():
    """x, y of one event: rho cos/sin of theta degrees (float64 args)."""
    app = ("define stream P (theta double, rho double);\n"
           "from P#pol2Cart(theta, rho) select x, y insert into Out;")
    outs = []
    for pkg, kw in ((siddhi_tpu, {}), (siddhi_tpu_torch,
                                       {"device": "cpu"})):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs, got=got: got.extend(
            tuple(e.data) for e in evs))
        rt.get_input_handler("P").send((30.0, 2.0))
        rt.flush()
        outs.append(got)
    assert outs[0] == pytest.approx(outs[1], rel=1e-12)
    x, y = outs[1][0]
    assert x == pytest.approx(2.0 * np.cos(np.pi / 6), rel=1e-6)
    assert y == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("text,match", [
    ("from S#window.length(5)[price > 1.0] select max(price) as m "
     "insert into Out;", "cannot combine with a post-window filter"),
    ("from S#pol2Cart(price) select x insert into Out;",
     r"pol2Cart needs \(theta, rho\)"),
], ids=["minmax_post_filter", "pol2cart_one_arg"])
def test_refusals_match_jax(text, match):
    with pytest.raises(siddhi_tpu.errors.SiddhiAppCreationError,
                       match=match):
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(S + text)
    with pytest.raises(SiddhiAppCreationError, match=match):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(S + text)


def test_join_sides_keep_refusing_stream_functions():
    """The JAX package accepts stream functions on a join side and does
    not apply them (ROADMAP.md Queue 3), and so does the port: the same
    output."""
    app = (S + "define stream R (symbol string, w double);\n"
           "@info(name='j') from S#pol2Cart(price, volume)#window.length(5) "
           "as a join R#window.length(5) as b on a.symbol == b.symbol "
           "select a.symbol as s, a.price as p insert into Out;")
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
              else pkg.SiddhiManager()).create_siddhi_app_runtime(
                  app, batch_size=8)
        got = []
        rt.add_query_callback("j", lambda ts, i, r, got=got: got.extend(
            tuple(e.data) for e in i or []))
        rt.get_input_handler("S").send(("a", 1.5, 2, 0), timestamp=1)
        rt.get_input_handler("S").send(("b", 2.5, 3, 0), timestamp=2)
        rt.flush()
        rt.get_input_handler("R").send(("a", 0.5), timestamp=3)
        rt.flush()
        outs.append(got)
    assert outs[1] == outs[0] == [("a", 1.5)]
