"""Edges of K11a's first match and K13a's walks that the card tests lean
on, with the port's plain versions held against the JAX package on the
CPU: a `within` that fails on a lane and passes on a later one (unsorted
timestamps), a sliding expression walk whose 2B + E + 8 iteration cap
bites, and expressionBatch flushes on an empty window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.core.pattern_runtime import PendingTable as JPending
from siddhi_tpu.ops import expression_general as jeg
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops import expression_general as teg
from siddhi_tpu_torch.ops import pattern as tp
from tests.test_torch_expression_window import (  # noqa: F401
    LAYOUT_J, LAYOUT_T, S, _api, _ring_and_batch, small_capacity)
from tests.test_torch_pattern import (PRIM_APP, _jax_mask, _prim_inputs,
                                      _runtimes, _t)


def test_within_failing_mid_run_matches_the_jax_step():
    """Shuffled timestamps: some entry's first lane past last_seq with its
    values fails `within`, and a later one passes and is its match."""
    B, P, seq0, within = 48, 96, 500, 5000
    jqr, tqr = _runtimes(PRIM_APP.format(sep=" ->"), P, B)
    valid, cols, ts, arr_seq, pend, f = _prim_inputs(7, B, P, seq0)
    rng = np.random.default_rng(7)
    ts = (10_000 + rng.integers(-3000, 3000, B)).astype(np.int64)
    cols["x"] = np.full(B, 15.0, np.float32)  # the residual holds
    pend["x"] = np.zeros(P, np.float32)
    f["valid"] = np.ones(P, bool)
    f["fvalid"] = np.ones(P, bool)
    jbatch = JBatch(ts=jnp.asarray(ts), cols={k: jnp.asarray(v)
                                              for k, v in cols.items()},
                    valid=jnp.asarray(valid), types=jnp.zeros(B, jnp.int8))
    jpend = JPending(
        frames={"a": {k: jnp.asarray(v) for k, v in pend.items()}},
        frame_valid={"a": jnp.asarray(f["fvalid"])},
        frame_ts={"a": jnp.asarray(f["fts"])},
        start_ts=jnp.asarray(f["start_ts"]),
        last_seq=jnp.asarray(f["last_seq"]),
        armed_ts=jnp.asarray(f["armed_ts"]), valid=jnp.asarray(f["valid"]),
        leg_done=jnp.zeros((P, 2), bool),
        origin=jnp.full((P,), -1, jnp.int32))
    want = _jax_mask(jqr, jbatch, jpend, jnp.asarray(arr_seq),
                     jnp.asarray(f["last_seq"]), 13_000, False, within)
    tbatch = TBatch(ts=_t(ts), cols={k: _t(v) for k, v in cols.items()},
                    valid=_t(valid), types=torch.zeros(B, dtype=torch.int8))
    tpend = tp.PendingTable(
        frames={"a": {k: _t(v) for k, v in pend.items()}},
        frame_valid={"a": _t(f["fvalid"])}, frame_ts={"a": _t(f["fts"])},
        start_ts=_t(f["start_ts"]), last_seq=_t(f["last_seq"]),
        armed_ts=_t(f["armed_ts"]), valid=_t(f["valid"]),
        leg_done=torch.zeros((P, 2), dtype=torch.bool),
        origin=torch.full((P,), -1, dtype=torch.int32))
    leg = tqr.plan.positions[1].legs[0]
    got = tqr._match(leg, tbatch, tpend, _t(arr_seq), tpend.last_seq,
                     torch.tensor(seq0), False, within)
    for name, g, w in zip(("b_star", "matched", "killed"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    # the case the walk must not stop at: the first candidate lane fails
    # `within` and the match is a later lane
    b_star, matched = got[0].numpy(), got[1].numpy()
    same = ((cols["v"][:, None] == pend["v"][None, :])
            & (cols["k"][:, None] == pend["k"][None, :])
            & valid[:, None] & (arr_seq[:, None] > f["last_seq"][None, :]))
    late = 0
    for p in np.flatnonzero(matched):
        first = np.flatnonzero(same[:, p])[0]
        late += first < b_star[p] and ts[first] - f["start_ts"][p] > within
    assert late > 0


@pytest.mark.parametrize("cond,k", [("sum(volume) <= 20", 0),
                                    ("price > 3.0 and count() < 9", 3)],
                         ids=["aggregate", "current"])
def test_sliding_walk_at_its_iteration_cap_matches_jax(cond, k,
                                                       small_capacity):
    """E = -2B + k on both windows: every pop stops at once, so the walk
    needs at least one check an arrival, more than 2B + E + 8 = 8 + k for
    B of them, and bails out there; the lanes past it take the final
    frontier."""
    B = 64
    jwin = jeg.GeneralExpressionWindow(LAYOUT_J, B, cond)
    twin = teg.GeneralExpressionWindow(LAYOUT_T, B, cond)
    jwin.E = twin.E = -2 * B + k
    assert 2 * B + jwin.E + 8 < B  # the cap bites
    C = twin.C
    rng = np.random.default_rng(11 + k)
    ring_cols, ring_ts, comp_cols, comp_ts = _ring_and_batch(rng, B, C)
    for expired, winlen0, n_valid in ((C - 40, 100, B), (5, 30, B - 3)):
        q = winlen0 + np.arange(B, dtype=np.int32)
        want = jax.jit(jwin._frontiers)(
            {c: jnp.asarray(v) for c, v in ring_cols.items()},
            jnp.asarray(ring_ts),
            {c: jnp.asarray(v) for c, v in comp_cols.items()},
            jnp.asarray(comp_ts), jnp.int64(expired), jnp.int32(winlen0),
            jnp.int32(n_valid), jnp.asarray(q))
        got = twin._frontiers(
            {c: _t(v) for c, v in ring_cols.items()}, _t(ring_ts),
            {c: _t(v) for c, v in comp_cols.items()}, _t(comp_ts),
            torch.tensor(expired), torch.tensor(winlen0, dtype=torch.int32),
            torch.tensor(n_valid, dtype=torch.int32), _t(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tail = got.numpy()[8 + k:]
        assert (tail == tail[-1]).all()  # the final frontier past the bail


@pytest.mark.parametrize("inc", ["false", "true"])
def test_expression_batch_flush_on_an_empty_window_matches_jax(inc):
    """Prices over the budget arriving on an empty accumulating window (the
    first event, and right after a flush), each alone and in batches."""
    app = (S + "@info(name='q') from S#window.expressionBatch('sum(price) "
           f"<= 10.0', {inc}) select symbol, price insert all events into "
           "Out;")
    prices = [50.0, 4.0, 5.0, 30.0, 12.0, 3.0, 9.0, 11.0, 2.0, 40.0]
    rows = [(f"s{i}", p, i) for i, p in enumerate(prices)]
    for flush_each in (True, False):
        script = []
        for i, row in enumerate(rows):
            script.append(("send", row, i))
            if flush_each:
                script.append(("flush",))
        want = _api(siddhi_tpu, app, script)
        assert any(i or r for _, i, r in want)
        assert _api(siddhi_tpu_torch, app, script) == want
