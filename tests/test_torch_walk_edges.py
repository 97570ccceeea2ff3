"""Edges of K11a's first match, K11c's absent scan, K11d's match count and
K13a's walks that the card tests lean on, with the port's plain versions
held against the JAX package on the CPU: a `within` that fails on a lane
and passes on a later one (unsorted timestamps), a run where a lane past
the deadline precedes one before it, a leg with no equality and a
residual, a sliding expression walk whose 2B + E + 8 iteration cap bites,
and expressionBatch flushes on an empty window; and the pattern step's
one index a leg and batch."""

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
from siddhi_tpu_torch.core import pattern_runtime as tpr
from tests.test_torch_pattern import (PRIM_APP, _jax_mask, _prim_inputs,
                                      _run, _runtimes, _t)

BIGSEQ = 2**62
S_DEF = "define stream S (v int, k string, x float);\n@info(name = 'q')\n"


def _tables(valid, cols, ts, pend, f):
    """(JAX batch, JAX table, torch batch, torch table) of numpy inputs in
    _prim_inputs' form; the table's start_ts and armed_ts from `f`."""
    B, P = ts.shape[0], f["valid"].shape[0]
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
    tbatch = TBatch(ts=_t(ts), cols={k: _t(v) for k, v in cols.items()},
                    valid=_t(valid), types=torch.zeros(B, dtype=torch.int8))
    tpend = tp.PendingTable(
        frames={"a": {k: _t(v) for k, v in pend.items()}},
        frame_valid={"a": _t(f["fvalid"])}, frame_ts={"a": _t(f["fts"])},
        start_ts=_t(f["start_ts"]), last_seq=_t(f["last_seq"]),
        armed_ts=_t(f["armed_ts"]), valid=_t(f["valid"]),
        leg_done=torch.zeros((P, 2), dtype=torch.bool),
        origin=torch.full((P,), -1, dtype=torch.int32))
    return jbatch, jpend, tbatch, tpend


def _jax_q(jqr, jbatch, jpend, arr_seq):
    """numpy bool[B, P]: the JAX step's leg condition of position 1 on
    live entries past last_seq (`pattern_runtime.py:871-882, 1318-1331`
    before their time tests)."""
    leg = jqr.plan.positions[1].legs[0]
    q = jqr._leg_cond(leg, jbatch, jpend, jnp.int64(13_000))
    q = q & (jnp.asarray(arr_seq)[:, None] > jpend.last_seq[None, :])
    return np.asarray(q & jpend.valid[None, :])


def _unsorted_inputs(seed, B, P, seq0):
    """_prim_inputs with shuffled timestamps and live entries armed around
    the batch, so one entry's run has lanes on both sides of its deadline
    (armed + 2 s) and of `within` (5 s from start_ts) in any order."""
    valid, cols, ts, arr_seq, pend, f = _prim_inputs(seed, B, P, seq0)
    rng = np.random.default_rng(seed)
    ts = (10_000 + rng.integers(0, 3000, B)).astype(np.int64)
    f["armed_ts"] = (8_000 + rng.integers(0, 3500, P)).astype(np.int64)
    f["start_ts"] = (6_000 + rng.integers(0, 4000, P)).astype(np.int64)
    f["valid"] = rng.random(P) < 0.8
    return valid, cols, ts, arr_seq, pend, f


def _out_of_order(q, ts, bound, late):
    """Entries with a qualifying lane on the `late` side of `bound` (ts >=
    bound) before one on the other side, per `late(ts, bound) -> bool`."""
    n = 0
    for p in range(q.shape[1]):
        side = late(ts[q[:, p]], bound[p])
        n += bool(side.any() and not side[np.argmax(side):].all())
    return n


def test_absent_scan_after_lane_before_a_before_lane_matches_jax():
    """`not S[v == a.v] for 2 sec` on shuffled timestamps: some entry's
    run meets a lane at or past its deadline before one inside it, and the
    scan still finds both sides (K11c's walk does not stop at either)."""
    B, P, seq0 = 48, 96, 500
    jqr, tqr = _runtimes(S_DEF + "from every a=S -> not S[v == a.v] for "
                         "2 sec select a.v as av insert into OutStream;",
                         P, B)
    valid, cols, ts, arr_seq, pend, f = _unsorted_inputs(3, B, P, seq0)
    jbatch, jpend, tbatch, tpend = _tables(valid, cols, ts, pend, f)
    q = _jax_q(jqr, jbatch, jpend, arr_seq)
    deadline = f["armed_ts"] + 2000
    early = ts[:, None] < deadline[None, :]
    want = (np.where(q, arr_seq[:, None], BIGSEQ).min(0),
            (q & early).any(0), (q & ~early).any(0))
    tleg = tqr.plan.positions[1].legs[0]
    assert len(tleg.eq) == 1 and not tleg.resid
    got = tqr._absent(tleg, tbatch, tpend, _t(arr_seq), _t(deadline))
    for name, g, w in zip(("first", "before", "after"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert _out_of_order(q, ts, deadline, lambda t, d: t >= d) > 0


def test_match_count_within_failing_mid_run_matches_jax():
    """`every b=S[b.v == a.v] within 5 sec` on shuffled timestamps: runs
    whose lanes fail `within` and pass it again later, counted whole."""
    B, P, seq0 = 48, 96, 500
    jqr, tqr = _runtimes(S_DEF + "from every a=S -> every b=S[b.v == a.v] "
                         "within 5 sec select a.v as av, b.v as bv "
                         "insert into OutStream;", P, B)
    valid, cols, ts, arr_seq, pend, f = _unsorted_inputs(4, B, P, seq0)
    jbatch, jpend, tbatch, tpend = _tables(valid, cols, ts, pend, f)
    q = _jax_q(jqr, jbatch, jpend, arr_seq)
    fails = ts[:, None] - f["start_ts"][None, :] > 5000
    want = int((q & ~fails).sum())
    tleg = tqr.plan.positions[1].legs[0]
    got = tqr._count(tleg, tbatch, tpend, _t(arr_seq), 5000)
    assert int(got) == want > 0
    assert _out_of_order(q, ts, f["start_ts"] + 5000,
                         lambda t, b: t > b) > 0


@pytest.mark.parametrize("kind", ["absent", "count"])
def test_no_equality_with_a_residual_matches_jax(kind):
    """A leg whose only condition is a residual (`x > a.x`): every lane_ok
    lane is one run, masked tile by tile."""
    B, P, seq0 = 48, 96, 500
    pos = ("not S[x > a.x] for 2 sec select a.v as av" if kind == "absent"
           else "every b=S[b.x > a.x] within 5 sec select a.v as av, "
           "b.v as bv")
    jqr, tqr = _runtimes(S_DEF + f"from every a=S -> {pos} "
                         "insert into OutStream;", P, B)
    valid, cols, ts, arr_seq, pend, f = _unsorted_inputs(5, B, P, seq0)
    jbatch, jpend, tbatch, tpend = _tables(valid, cols, ts, pend, f)
    q = _jax_q(jqr, jbatch, jpend, arr_seq)
    tleg = tqr.plan.positions[1].legs[0]
    assert not tleg.eq and len(tleg.resid) == 1
    if kind == "absent":
        deadline = f["armed_ts"] + 2000
        early = ts[:, None] < deadline[None, :]
        want = (np.where(q, arr_seq[:, None], BIGSEQ).min(0),
                (q & early).any(0), (q & ~early).any(0))
        got = tqr._absent(tleg, tbatch, tpend, _t(arr_seq), _t(deadline))
        for name, g, w in zip(("first", "before", "after"), got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert got[1].any() and got[2].any()
    else:
        want = int((q & (ts[:, None] - f["start_ts"][None, :]
                         <= 5000)).sum())
        assert int(tqr._count(tleg, tbatch, tpend, _t(arr_seq),
                              5000)) == want > 0


STEP_APPS = {
    "sticky": ("define stream A (val int);\ndefine stream B (val int);\n"
               "@info(name = 'q')\nfrom every a=A -> every "
               "b=B[b.val == a.val] within 1 sec select a.val as av, "
               "b.val as bv insert into OutStream;", ["K11a"]),
    "absent": ("define stream A (val int);\ndefine stream B (val int);\n"
               "@info(name = 'q')\nfrom every a=A -> not B[val == a.val] "
               "for 20 millisec select a.val as av insert into OutStream;",
               ["K11c"]),
    "timed notand": ("define stream A (val int);\n"
                     "define stream B (val int);\n@info(name = 'q')\n"
                     "from every a=A -> not B[val == a.val] for 20 millisec "
                     "and e3=B[val < 3] select a.val as av, e3.val as cv "
                     "insert into OutStream;",
                     ["K11c", "K11a"]),
}


@pytest.mark.parametrize("name", sorted(STEP_APPS))
def test_a_step_builds_one_index_a_leg(name, monkeypatch):
    """Each B step asks `match_index` once for each leg it probes, under
    the counter of the leg's first call: the sticky position's four K11a
    passes and its K11d count share one, an absent leg and a notand's
    present leg each have their own."""
    app, counters = STEP_APPS[name]
    calls = []

    def counting(arr_seq, ts, lane_ok, arrivals, counter):
        calls.append(counter)
        return tp.match_index(arr_seq, ts, lane_ok, arrivals, counter)

    monkeypatch.setattr(tpr, "match_index", counting)
    rng = np.random.default_rng(8)
    script, t = [], 1000
    for _ in range(3):
        for sid in ("A", "B"):
            script += [("cols", sid, {"val": rng.integers(0, 6, 40).astype(
                np.int32)}, t + np.arange(40)), ("flush",)]
            t += 10
    got = _run(siddhi_tpu_torch, "@app:playback\n" + app, script,
               batch_size=64, device="cpu")
    assert got
    assert sorted(calls) == sorted(counters * 3)


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
    jbatch, jpend, tbatch, tpend = _tables(valid, cols, ts, pend, f)
    want = _jax_mask(jqr, jbatch, jpend, jnp.asarray(arr_seq),
                     jnp.asarray(f["last_seq"]), 13_000, False, within)
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
