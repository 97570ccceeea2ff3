"""Device supersteps of siddhi_tpu_torch (core/superstep.py, the ingress
feeder's K-staging and kernel K12b's plain version) against the JAX package
on the CPU.

The JAX side runs at K = 1 only: its own tests/test_superstep.py holds its
K > 1 bit for bit against its K = 1, so here the port's K = 4 and K = 1 are
both held against the JAX package's K = 1, and no JAX scan is compiled.
Inputs are made with numpy from a seed and handed to both packages. The
port's K = 4 against its K = 1 is exact in every column. Against the JAX
package timestamps, `is_expired`, integer columns, string codes and dtypes
are exact; float columns within rtol 1e-6 (XLA's float32 `avg` division
differs from torch's by one ulp on some lanes; the sums are equal).
"""

import threading

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import superstep as jsuperstep
from siddhi_tpu.ops.search import stable_partition_order
from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core import ingress as tingress
from siddhi_tpu_torch.core import superstep as tsuperstep
from siddhi_tpu_torch.ops import superstep_pack as sp

BS = 64
K = 4
N_ROWS = 2048  # 32 full chunks at BS = 64: 8 supersteps at K = 4
DRAIN_S = 30.0

ASYNC_HDR = ("@Async(buffer.size='64', workers='2')\n"
             "define stream TradeStream (symbol string, price double, "
             "volume long);\n")

APPS = {
    "filter": (
        "@info(name='filt') from TradeStream[price < 700.0] "
        "select symbol, price, volume insert into OutStream;"),
    "chain": (
        "@info(name='filt') from TradeStream[price < 700.0] "
        "select symbol, price, volume insert into MidStream;\n"
        "@info(name='agg') from MidStream#window.lengthBatch(50) "
        "select symbol, sum(price) as total, avg(price) as avgPrice "
        "group by symbol insert into OutStream;"),
    "sliding": (
        "@info(name='slide') from TradeStream#window.length(40) "
        "select symbol, sum(price) as s, count() as n "
        "insert into OutStream;"),
    "distinct": (
        "@info(name='dq') from TradeStream#window.length(64) "
        "select distinctCount(symbol) as d insert into OutStream;"),
    "join": (
        "define stream QuoteStream (symbol string, bid double);\n"
        "@info(name='jq') from TradeStream#window.length(32) join "
        "QuoteStream#window.length(16) "
        "on TradeStream.symbol == QuoteStream.symbol "
        "select TradeStream.symbol as symbol, TradeStream.price as price, "
        "QuoteStream.bid as bid insert into OutStream;"),
}


@pytest.fixture(autouse=True)
def _bounded_drain(monkeypatch):
    """A drain that does not finish raises instead of hanging the run; the
    superstep knob comes from the annotation alone."""
    monkeypatch.setattr(tingress, "DRAIN_TIMEOUT_S", DRAIN_S)
    monkeypatch.delenv("SIDDHI_SUPERSTEP_K", raising=False)


def _rows(n, seed=11):
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 12, n)
    ps = rng.uniform(1.0, 1000.0, n)
    vs = rng.integers(1, 1000, n)
    return [(f"S{int(k)}", float(p), int(v)) for k, p, v in zip(ks, ps, vs)]


def app_text(shape: str, k: int, tag: str = "") -> str:
    ann = f"@app:superstep(k='{k}')\n" if k > 1 else ""
    return (f"@app:name('SS{shape}{k}{tag}')\n" + ann + ASYNC_HDR
            + APPS[shape])


def feed(rt, shape: str) -> None:
    if shape == "join":
        q = rt.get_input_handler("QuoteStream")
        for i in range(12):
            q.send((f"S{i % 12 + 1}", 10.0 + i))
        rt.flush()
    rt.get_input_handler("TradeStream").send_batch(
        _rows(N_ROWS), timestamps=np.arange(1, N_ROWS + 1, dtype=np.int64))


def _ours():
    return {t for t in threading.enumerate() if t.name.startswith("siddhi-")}


def capture(app: str, shape: str, torch_side: bool = True,
            feeder=feed, on_rt=None):
    """Run `app` on one package, collect OutStream blocks columnar; returns
    (blocks, TradeStream pipeline stats_snapshot, statistics)."""
    before = _ours()
    if torch_side:
        rt = siddhi_tpu_torch.SiddhiManager(
            device="cpu").create_siddhi_app_runtime(app)
    else:
        rt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    blocks = []
    rt.add_callback("OutStream", lambda b: blocks.append(
        (b.timestamps.copy(), {k: v.copy() for k, v in b.columns.items()},
         b.is_expired.copy())), columnar=True)
    if on_rt is not None:
        on_rt(rt)
    rt.start()
    try:
        feeder(rt, shape)
        rt.drain()
        snap = rt.junctions["TradeStream"]._pipeline.stats_snapshot()
        stats = (rt.ctx.statistics.report()["batches"] if torch_side
                 else None)
    finally:
        rt.shutdown()
    if torch_side:
        assert not (_ours() - before), "threads left after shutdown"
    return blocks, snap, stats


def assert_blocks_identical(got, want, float_rtol=0.0):
    assert len(got) == len(want), (len(got), len(want))
    for (gt, gc, ge), (wt, wc, we) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge, we)
        assert gc.keys() == wc.keys()
        for k in wc:
            assert gc[k].dtype == wc[k].dtype, k
            if float_rtol and wc[k].dtype.kind == "f":
                np.testing.assert_allclose(gc[k], wc[k], rtol=float_rtol,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)


@pytest.mark.parametrize("shape", list(APPS))
def test_superstep_parity(shape):
    """Port K = 4 == port K = 1, bit for bit, and both == JAX K = 1 (floats
    within rtol 1e-6); the superstep
    engaged (every chunk in one), with no decline; the replay counts the
    same batches a stream as the per-batch path."""
    want, _, _ = capture(app_text(shape, 1), shape, torch_side=False)
    one, s1, b1 = capture(app_text(shape, 1), shape)
    got, sk, bk = capture(app_text(shape, K), shape)
    assert sum(len(b[0]) for b in want) > 0
    assert s1["supersteps_dispatched"] == 0
    assert sk["superstep_decline"] is None, sk
    assert sk["superstep_k"] == K
    assert sk["supersteps_dispatched"] == N_ROWS // BS // K
    assert_blocks_identical(one, want, float_rtol=1e-6)
    assert_blocks_identical(got, one)
    assert bk == b1


def test_non_query_ingress_receiver_declines():
    taps = []

    def on_rt(rt):
        # a callback on the ingress stream itself is not a step: the whole
        # plan declines and the per-batch path delivers everything
        rt.add_callback("TradeStream", lambda b: taps.append(b.count),
                        columnar=True)

    got, snap, _ = capture(app_text("filter", K, "decl"), "filter",
                           on_rt=on_rt)
    assert snap["supersteps_dispatched"] == 0
    assert snap["superstep_decline"] == (
        f"FunctionBatchCallback: {jsuperstep.DECLINE_RECEIVER}")
    assert tsuperstep.DECLINE_RECEIVER == jsuperstep.DECLINE_RECEIVER
    assert sum(taps) == N_ROWS
    assert sum(len(b[0]) for b in got) > 0


def test_decline_texts_are_the_jax_texts():
    names = [n for n in dir(jsuperstep) if n.startswith("DECLINE_")]
    assert names and all(getattr(tsuperstep, n) == getattr(jsuperstep, n)
                         for n in names)


def test_k1_never_builds_a_runner(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("K = 1 built a superstep runner")

    monkeypatch.setattr(tsuperstep, "build_runner", refuse)
    _, snap, _ = capture(app_text("filter", 1, "k1"), "filter")
    assert snap["superstep_k"] == 1
    assert snap["supersteps_dispatched"] == 0
    assert snap["superstep_decline"] is None


def test_env_knob_overrides_annotation(monkeypatch):
    monkeypatch.setenv("SIDDHI_SUPERSTEP_K", "1")
    _, snap, _ = capture(app_text("filter", K, "env1"), "filter")
    assert snap["superstep_k"] == 1 and snap["supersteps_dispatched"] == 0
    monkeypatch.setenv("SIDDHI_SUPERSTEP_K", str(K))
    _, snap, _ = capture(app_text("filter", 1, "env4"), "filter")
    assert snap["superstep_k"] == K and snap["supersteps_dispatched"] > 0


class _Boom:
    def __init__(self, exc):
        self.exc = exc

    def revalidate(self):
        return True

    def dispatch(self, block):
        raise self.exc


def _pipeline():
    rt = siddhi_tpu_torch.SiddhiManager(
        device="cpu").create_siddhi_app_runtime(app_text("filter", K, "f"))
    return tingress.IngressPipeline(rt.junctions["TradeStream"], 1)


def test_kernel_fault_propagates_instead_of_declining():
    """A kernel that does not build or launch is not the app's error: the
    feeder re-raises it (the per-batch path launches the same kernels),
    while an error of the app's own step declines to that path."""
    p = _pipeline()
    p._ss_k = K
    p._ss_runner = _Boom(kernels.KernelError("k12b: launch failed"))
    with pytest.raises(kernels.KernelError):
        p._superstep_dispatch(None)
    assert p._ss_decline is None
    p._ss_runner = _Boom(ValueError("bad step"))
    assert p._superstep_dispatch(None) == 0
    assert p._ss_decline.startswith("runtime error during dispatch")


def test_step_error_mid_superstep_keeps_the_finished_iterations():
    """The app's step fails at iteration 2 of the first superstep: the
    outputs of iterations 0 and 1 (whose states were applied in place) are
    delivered, the failing chunk is counted as dropped, supersteps stop and
    every later chunk goes through the per-batch path."""
    calls = []
    held = {}

    def on_rt(rt):
        qr = rt.query_runtimes["filt"]
        step = qr.step

        def flaky(state, batch, now):
            calls.append(1)
            if len(calls) == 3:
                raise ValueError("step failed")
            return step(state, batch, now)

        qr.step = flaky
        held["rt"] = rt

    one, _, _ = capture(app_text("filter", 1, "ok"), "filter")
    got, snap, _ = capture(app_text("filter", K, "err"), "filter",
                           on_rt=on_rt)
    assert snap["superstep_decline"].startswith(
        "runtime error during dispatch")
    dropped = held["rt"].ctx.statistics.report()["ingress_dropped"]
    assert dropped == {"TradeStream": {"superstep.error": BS}}
    assert snap["rows_delivered"] == N_ROWS - BS
    ts1 = np.concatenate([b[0] for b in one])
    keep = (ts1 <= 2 * BS) | (ts1 > 3 * BS)  # chunk 2 is ts 129..192
    assert (~keep).any()
    np.testing.assert_array_equal(np.concatenate([b[0] for b in got]),
                                  ts1[keep])
    for name in one[0][1]:
        np.testing.assert_array_equal(
            np.concatenate([b[1][name] for b in got]),
            np.concatenate([b[1][name] for b in one])[keep], err_msg=name)


def test_feeder_error_surfaces_at_drain():
    p = _pipeline()
    p._error = kernels.KernelError("k12b: build failed")
    with pytest.raises(kernels.KernelError):
        p.drain(timeout=1.0)


# ------------------------------------------------- K12b plain against JAX

def _pack_inputs(case: str, seed: int):
    rng = np.random.default_rng(seed)
    Kp, W = (8, 97) if case != "wide" else (3, 2500)
    ts = 1_700_000_000_000 + rng.integers(0, 1 << 40, (Kp, W))
    valid = rng.random((Kp, W)) < 0.45
    valid[1] = False  # an iteration with no valid lane
    valid[2] = True  # and one with every lane valid
    cols = {"sym": rng.integers(0, 5000, (Kp, W)).astype(np.int32),
            "f": rng.normal(size=(Kp, W)).astype(np.float32),
            "l": rng.integers(-2**62, 2**62, (Kp, W)),
            "d": rng.normal(size=(Kp, W)),
            "b": rng.random((Kp, W)) < 0.5,
            "h": rng.integers(-2**15, 2**15, (Kp, W)).astype(np.int16)}
    cols["f"][0, 3] = np.nan
    return ts, valid, cols


@pytest.mark.parametrize("case,seed", [("narrow", 0), ("narrow", 1),
                                       ("wide", 2)])
def test_superstep_pack_plain_matches_jax_compaction(case, seed):
    """The packed buffer's counts and each iteration's rows equal the JAX
    compaction (superstep.py:417-428: the sum, one stable partition of the
    flattened lanes, a gather a column), bit for bit."""
    import jax.numpy as jnp
    ts, valid, cols = _pack_inputs(case, seed)
    j_cnt = np.asarray(jnp.sum(jnp.asarray(valid).astype(jnp.int32), axis=1))
    perm = np.asarray(stable_partition_order(jnp.asarray(valid.reshape(-1))))
    total = int(valid.sum())
    j_ts = ts.reshape(-1)[perm][:total]
    j_cols = {a: v.reshape(-1)[perm][:total] for a, v in cols.items()}

    buf = sp.superstep_pack_plain(
        torch.from_numpy(ts), torch.from_numpy(valid),
        {a: torch.from_numpy(v) for a, v in cols.items()})
    layout = sp.layout_of(torch.from_numpy(ts),
                          {a: torch.from_numpy(v) for a, v in cols.items()})
    host = sp.PackedHost(buf.numpy(), layout)
    np.testing.assert_array_equal(host.counts, j_cnt)
    head = buf[:32].view(torch.int64).tolist()
    assert head == [total, ts.shape[0], ts.shape[1], 0]
    for k in range(ts.shape[0]):
        lo, hi = int(host.offsets[k]), int(host.offsets[k + 1])
        sl = host.slice(k)
        assert sl.count == hi - lo == int(j_cnt[k])
        np.testing.assert_array_equal(sl.ts, j_ts[lo:hi])
        for a in cols:
            assert sl.cols[a].dtype == cols[a].dtype
            np.testing.assert_array_equal(sl.cols[a].view(np.uint8),
                                          j_cols[a][lo:hi].view(np.uint8),
                                          err_msg=a)


def test_superstep_pack_refuses_ragged_stacks():
    ts = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[K, W\]"):
        sp.superstep_pack(ts, torch.zeros((2, 8), dtype=torch.bool),
                          {"x": torch.zeros((2, 7), dtype=torch.int32)})
