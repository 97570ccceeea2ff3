"""Exact distinctCount and the single-component scans (kernel K5b's plain
versions) of siddhi_tpu_torch against the JAX package on the CPU: the
scans under sum/min/max, both branches of distinctCount (string codes
without GROUP BY; the (group, value) pair table) through the public API,
compaction of the pair table, and interop of a running distinctCount.

Inputs are made with numpy from a seed and handed to both packages. Integer
results and table state must be bit-exact; float scans within rtol 1e-5
plus atol 1e-3 (signed float32 sums in another order than XLA's tree,
tests/test_numeric_parity.py; values below 100 in magnitude, ulp(1e4) ~
1e-3 where a sum cancels).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.ops import aggregators as jagg
from siddhi_tpu.ops import groupby as jgb
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.ops import aggregators as tagg
from siddhi_tpu_torch.ops import groupby as tgb

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3


@functools.lru_cache(maxsize=None)
def _j_scan(grouped: bool, op: str):
    fn = jgb.grouped_scan if grouped else jgb.ungrouped_scan
    return jax.jit(functools.partial(fn, op=op))


def _scan_inputs(seed, L, K, n_reset, dtype):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, K, L).astype(np.int32)
    valid = rng.random(L) < 0.85
    resets = np.zeros(L, bool)
    resets[rng.choice(L, n_reset, replace=False)] = True
    valid &= ~resets
    if dtype == np.float32:
        d = rng.uniform(-100, 100, L).astype(dtype)
        vals = rng.uniform(-50, 50, K).astype(dtype)
    else:
        d = rng.integers(-1000, 1000, L).astype(dtype)
        vals = rng.integers(-50, 50, K).astype(dtype)
    epochs = rng.integers(0, 4, K).astype(np.int32)
    return slots, d, valid, resets, vals, epochs


def _check(got, want, dtype):
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.float32],
                         ids=["int64", "float32"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_k5b_grouped_scan_matches_jax(op, dtype):
    slots, d, valid, resets, vals, epochs = _scan_inputs(7, 400, 24, 3,
                                                         dtype)
    js, jo = _j_scan(True, op)(
        jgb.GroupState(jnp.asarray(vals), jnp.asarray(epochs)),
        jnp.asarray(slots), jnp.asarray(d), jnp.asarray(valid),
        jnp.asarray(resets), jnp.int32(2))
    t = torch.from_numpy
    ts, to = tgb.grouped_scan(
        tgb.GroupState(t(vals.copy()), t(epochs.copy())), t(slots), t(d),
        t(valid), t(resets), torch.tensor(2, dtype=torch.int32), op=op)
    np.testing.assert_array_equal(ts.epoch.numpy(), np.asarray(js.epoch))
    assert to.numpy().dtype == np.asarray(jo).dtype
    _check(ts.values.numpy(), np.asarray(js.values), dtype)
    _check(to.numpy(), np.asarray(jo), dtype)


@pytest.mark.parametrize("n_reset", [0, 4], ids=["no_resets", "resets"])
@pytest.mark.parametrize("dtype", [np.int64, np.float32],
                         ids=["int64", "float32"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_k5b_ungrouped_scan_matches_jax(op, dtype, n_reset):
    _, d, valid, resets, vals, _ = _scan_inputs(8, 300, 1, n_reset, dtype)
    cell, ep = vals[:1], np.array([1], np.int32)
    js, jo = _j_scan(False, op)(
        jgb.GroupState(jnp.asarray(cell), jnp.asarray(ep)), jnp.asarray(d),
        jnp.asarray(valid), jnp.asarray(resets), jnp.int32(1))
    t = torch.from_numpy
    ts, to = tgb.ungrouped_scan(
        tgb.GroupState(t(cell.copy()), t(ep.copy())), t(d), t(valid),
        t(resets), torch.tensor(1, dtype=torch.int32), op=op)
    np.testing.assert_array_equal(ts.epoch.numpy(), np.asarray(js.epoch))
    _check(ts.values.numpy(), np.asarray(js.values), dtype)
    _check(to.numpy(), np.asarray(jo), dtype)


# ---------------------------------------------------------------- the apps

STREAM = ("@app:playback\n"
          "define stream TradeStream (symbol string, price double, "
          "volume long);\n")

APPS = {
    # BASELINE config 3 (app C): the string-code branch, no GROUP BY
    "app_c": """
        @info(name = 'bench')
        from TradeStream#window.time(200)
        select distinctCount(symbol) as distinctSymbols
        insert into SummaryStream;""",
    # app E: the pair-table branch, grouped
    "app_e": """
        @info(name = 'bench')
        from TradeStream#window.time(200)
        select symbol, distinctCount(volume) as n
        group by symbol
        insert all events into SummaryStream;""",
    # the pair-table branch without GROUP BY, beside a sum component
    "ungrouped_long": """
        @info(name = 'bench')
        from TradeStream#window.length(30)
        select distinctCount(volume) as n, sum(volume) as v
        insert all events into SummaryStream;""",
    # RESET lanes: epochs of both scans
    "batch_window": """
        @info(name = 'bench')
        from TradeStream#window.lengthBatch(20)
        select symbol, distinctCount(volume) as n, count() as c
        group by symbol
        insert all events into SummaryStream;""",
}


def _trades(seed, n, n_keys, n_volumes):
    rng = np.random.default_rng(seed)
    key = np.array([f"S{i}" for i in rng.integers(0, n_keys, n)],
                   dtype=object)
    cols = {"symbol": key, "price": rng.uniform(1.0, 100.0, n),
            "volume": rng.integers(1, n_volumes + 1, n).astype(np.int64)}
    return cols, 1_000 + np.arange(n, dtype=np.int64) * 7


def _feeds(cols, ts, chunk):
    return [({k: v[s:s + chunk] for k, v in cols.items()}, ts[s:s + chunk])
            for s in range(0, ts.shape[0], chunk)]


def _runtime(pkg, app, group_capacity, **kw):
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=32, group_capacity=group_capacity)
    out = []
    rt.add_callback("SummaryStream", lambda evs: out.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    return rt, out


def _run(pkg, app, feeds, group_capacity=64, **kw):
    rt, out = _runtime(pkg, app, group_capacity, **kw)
    h = rt.get_input_handler("TradeStream")
    for cols, ts in feeds:
        h.send_columns(cols, timestamps=ts)
        rt.flush()
    return rt, out


@pytest.mark.parametrize("name", sorted(APPS))
def test_distinct_count_app_parity(name):
    # 9 symbols x 6 volumes: 54 pairs fit the 64 pair ids
    cols, ts = _trades(21, 150, 9, 6)
    feeds = _feeds(cols, ts, 37)  # every send ends with a short batch
    app = STREAM + APPS[name]
    _, want = _run(siddhi_tpu, app, feeds)
    _, got = _run(siddhi_tpu_torch, app, feeds, device="cpu")
    assert got == want and len(want) > 0


def test_pair_table_compaction_matches_jax():
    # 4 symbols x 40 volumes = 160 lifetime pairs against 64 pair ids; the
    # 200 ms window holds ~29 events, so compaction keeps the table usable
    cols, ts = _trades(22, 32 * 24, 4, 40)
    feeds = _feeds(cols, ts, 32)
    app = STREAM + APPS["app_e"]
    jrt, want = _run(siddhi_tpu, app, feeds)
    trt, got = _run(siddhi_tpu_torch, app, feeds, device="cpu")
    assert got == want
    assert trt.query_runtimes["bench"]._last_compacted_live
    # the rebuild itself: the same live pairs, ids and counts as JAX's
    jstate = jax.device_get(jrt.query_runtimes["bench"].state)
    epoch = int(jstate[1].epoch)
    tq = trt.query_runtimes["bench"]
    interop.load_query_state(tq, jstate)
    want_g = jagg.compact_distinct_state(jstate[1].groups[0], epoch)
    got_g = tagg.compact_distinct_state(tq.state[1].groups[0], epoch)
    for w, g in zip(jax.tree_util.tree_leaves(want_g),
                    [t for part in got_g for t in part]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["app_c", "app_e"])
def test_interop_continues_jax_distinct_state(name):
    cols, ts = _trades(23, 200, 9, 6)
    feeds = _feeds(cols, ts, 32)
    head, tail = feeds[:3], feeds[3:]
    app = STREAM + APPS[name]
    jrt, jout = _run(siddhi_tpu, app, head)
    jstate = jax.device_get(jrt.query_runtimes["bench"].state)
    n_head = len(jout)

    trt, tout = _runtime(siddhi_tpu_torch, app, 64, device="cpu")
    interop.load_app_state(trt, {"bench": jstate},
                           list(jrt.ctx.global_strings._to_str))
    trt.ctx.timestamp_generator.observe_event_time(int(head[-1][1][-1]))
    jh = jrt.get_input_handler("TradeStream")
    th = trt.get_input_handler("TradeStream")
    for c, t in tail:
        jh.send_columns(c, timestamps=t)
        jrt.flush()
        th.send_columns(c, timestamps=t)
        trt.flush()
    assert len(jout) > n_head
    assert tout == jout[n_head:]


def test_key_table_places_keys_the_jax_window_drops():
    """Deliberate divergence (ROADMAP.md, Queue 3): the JAX key table
    probes 16 slots and drops a new key whose 16 slots are all taken; the
    port probes 32 and places it. With room in the first 16 slots the two
    give the same table state."""
    K, H = 64, 128
    key = np.int64(0x1234_5678_9ABC_DEF1)
    window = tgb._probe_windows(torch.tensor([key]), H)[0].numpy()
    assert len(set(window.tolist())) == 32
    for full in (15, 16):
        keys = np.full(H, np.iinfo(np.int64).max, np.int64)
        keys[window[:full]] = 1000 + np.arange(full)
        ids = np.zeros(H, np.int32)
        ids[window[:full]] = np.arange(full)
        state = (keys, ids, np.int32(full), np.int32(0))
        jt, jids, jres = jax.jit(jgb.key_lookup_or_insert)(
            jgb.KeyTable(*[jnp.asarray(a) for a in state]),
            jnp.asarray([key]), jnp.asarray([True]))
        tt, tids, tres = tgb.key_lookup_or_insert(
            tgb.KeyTable(*[torch.tensor(a) for a in state]),
            torch.tensor([key]), torch.tensor([True]))
        assert bool(tres[0]) and int(tids[0]) == full
        if full == 15:
            for a, b in zip(tt, jt):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert not bool(jres[0]) and int(jt.misses) == 1
            assert int(tt.keys[window[16]]) == key and int(tt.misses) == 0
