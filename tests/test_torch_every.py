"""Every-groups, the mid-pattern `every` and multi-stream sequences of
siddhi_tpu_torch against the JAX package on the CPU: the plain versions of
kernels K11d (`match_count`) and K11e (`release_origin`) against the JAX
step's expressions, the shapes of tests/test_absent_patterns.py
(TestMidPatternEvery, TestGroupedHeadEvery) and tests/test_patterns.py
(TestMultiStreamSequence, TestLogicalSequences) through the public API,
multi-stream interleaves sent row by row, by send_batch and by
send_columns, seeded random feeds of each form, and mid-run JAX states of
a sticky and a mid-group app that the port continues.

Inputs are made with numpy from a seed and handed to both packages. Every
event must be equal, in order (output is pass-major across the every
passes, slot order within a pass): timestamps, ints, strings and captured
floats exactly, and the `dropped` counters too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.core.pattern_runtime import PendingTable as JPending
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops import pattern as tp
from tests.test_torch_absent import _feed, _hb, _parity_dropped, _send
from tests.test_torch_pattern import (BIGSEQ, F, THREE, TWO, _assert_same,
                                      _pending_capacity, _runtimes, _t)

PB = "@app:playback\n"

MID = (THREE + "from e1=S1[price>10] -> every e2=S2[price>20] "
       "select e1.symbol as a, e2.symbol as b insert into OutStream;")
HEAD_GROUP = (THREE + "from every (e1=S1[price>20.0] -> e3=S1[price>20.0]) -> "
              "e2=S2[price>e1.price] "
              "select e1.price as p1, e3.price as p3, e2.price as p2 "
              "insert into OutStream;")
SEQ = (TWO + "from every e1=S1[price > 20.0], e2=S2[price > 30.0] "
       "select e1.symbol as s1, e2.symbol as s2 insert into OutStream;")
LSEQ = (THREE + "from every e1=S1[price > 20.0], e2=S2[price > 30.0] "
        "and e3=S3[price > 40.0] "
        "select e1.symbol as s1, e2.symbol as s2, e3.symbol as s3 "
        "insert into OutStream;")


def _ones(*rows, t0=1000):
    """("one", stream, (symbol, price), ts) sends 1 ms apart, no flush."""
    return [("one", sid, (sym, p), t0 + i)
            for i, (sid, sym, p) in enumerate(rows)]


def _burst(sid, rows, t0):
    """One send_batch of rows 1 ms apart, then a flush."""
    return [("send", sid, list(rows), [t0 + i for i in range(len(rows))]), F]


SHAPES = {
    # TestMidPatternEvery
    "mid_every_second_element_repeats": (MID, [
        *_send("S1", "A", 15.0, 1_000), *_send("S2", "X", 25.0, 1_100),
        *_send("S2", "Y", 25.0, 1_101), *_send("S2", "Z", 25.0, 1_102)]),
    "mid_every_multiple_matches_in_one_batch": (MID, [
        *_send("S1", "A", 15.0, 1_000),
        *_burst("S2", [("X", 25.0), ("Y", 25.0), ("Z", 25.0)], 1_100)]),
    "mid_every_head_every_times_mid_every": (
        THREE + "from every e1=S1[price>10] -> every e2=S2[price>20] "
        "select e1.symbol as a, e2.symbol as b insert into OutStream;",
        [*_send("S1", "A1", 15.0, 1_000), *_send("S1", "A2", 16.0, 1_001),
         *_send("S2", "B", 25.0, 1_100)]),
    "mid_every_within_bounds_the_rearming": (
        THREE + "from e1=S1[price>10] -> every e2=S2[price>20] within 1 sec "
        "select e2.symbol as b insert into OutStream;",
        [*_send("S1", "A", 15.0, 1_000), *_send("S2", "in", 25.0, 1_500),
         *_send("S2", "out", 25.0, 2_500)]),
    "mid_every_pass_bound_counts_dropped": (MID, [
        *_send("S1", "A", 15.0, 1_000),
        *_burst("S2", [(f"B{i}", 25.0) for i in range(6)], 1_100),
        *_send("S2", "B9", 25.0, 1_200)]),
    "mid_grouped_every": (
        THREE + "from e4=S1[symbol == 'MSFT'] -> "
        "every (e1=S1[price>20.0] -> e3=S1[price>20.0]) -> "
        "e2=S2[price>e1.price] "
        "select e1.price as p1, e3.price as p3, e2.price as p2 "
        "insert into OutStream;",
        [op for i, (sym, p) in enumerate([
            ("MSFT", 55.6), ("WSO2", 55.7), ("GOOG", 54.0), ("WSO2", 53.6),
            ("GOOG", 53.0)]) for op in _send("S1", sym, p, 1000 + i * 100)]
        + _send("S2", "IBM", 57.7, 2000)),
    # TestGroupedHeadEvery
    "head_group_single_iteration": (HEAD_GROUP, [
        *_send("S1", "WSO2", 55.6, 1000), *_send("S1", "GOOG", 54.0, 1100),
        *_send("S2", "IBM", 57.7, 1200)]),
    "head_group_iterations_pair_up": (HEAD_GROUP, [
        op for i, p in enumerate([55.6, 54.0, 53.6, 53.0])
        for op in _send("S1", "X", p, 1000 + i * 100)]
        + _send("S2", "IBM", 57.7, 2000)),
    "head_group_iterations_pair_up_single_batch": (HEAD_GROUP, [
        *_burst("S1", [("X", p) for p in (55.6, 54.0, 53.6, 53.0)], 1000),
        *_send("S2", "IBM", 57.7, 2000)]),
    "head_group_bare_emits_per_completion": (
        THREE + "from every (e1=S1[price>20.0] -> e3=S1[price>20.0]) "
        "select e1.price as p1, e3.price as p3 insert into OutStream;",
        [op for i, p in enumerate([55.6, 54.0, 53.6, 53.0, 52.0])
         for op in _send("S1", "X", p, 1000 + i * 100)]),
    "head_group_within_bounds_each_iteration": (
        THREE + "from every ((e1=S1[price>20.0] -> "
        "e3=S1[price>20.0]) within 1 sec) "
        "select e1.price as p1, e3.price as p3 insert into OutStream;",
        [*_send("S1", "X", 55.6, 1000), *_hb(2500),
         *_send("S1", "X", 54.0, 3000), *_send("S1", "X", 53.0, 3500)]),
    # the every_group and mid_every forms the port once refused
    "every_group_two_streams": (
        THREE + "from every (e1=S1 -> e2=S2) select e1.price as p "
        "insert into OutStream;",
        [*_send("S1", "A", 1.0, 1000), *_send("S1", "B", 2.0, 1001),
         *_send("S2", "C", 3.0, 1002), *_send("S1", "D", 4.0, 1003),
         *_send("S2", "E", 5.0, 1004), *_send("S2", "G", 6.0, 1005)]),
    "mid_every_any_s2": (
        THREE + "from e1=S1 -> every e2=S2 select e1.price as p "
        "insert into OutStream;",
        [*_send("S1", "A", 1.0, 1000),
         *_burst("S2", [("B", 2.0), ("C", 3.0)], 1001),
         *_send("S2", "D", 4.0, 1010)]),
    # TestMultiStreamSequence (with the multi-stream form once refused)
    "seq_cross_stream_match": (SEQ, [
        *_ones(("S1", "IBM", 25.0), ("S2", "WSO2", 35.0)), F]),
    "seq_intervening_event_breaks": (SEQ, [
        *_ones(("S1", "IBM", 25.0), ("S1", "DOX", 26.0),
               ("S2", "WSO2", 35.0)), F]),
    "seq_non_matching_next_kills": (SEQ, [
        *_ones(("S1", "IBM", 25.0), ("S2", "BAD", 5.0),
               ("S2", "WSO2", 35.0)), F]),
    "seq_every_rearms_across_streams": (SEQ, [
        *_ones(("S1", "A", 21.0), ("S2", "B", 31.0), ("S1", "C", 22.0),
               ("S2", "D", 32.0)), F]),
    "seq_interleave_within_one_flush": (SEQ, [
        *_ones(("S1", "A", 25.0), ("S2", "B", 35.0), ("S2", "X", 36.0),
               ("S1", "C", 27.0), ("S2", "D", 37.0)), F]),
    "seq_three_streams": (
        THREE + "from every e1=S1[price > 20.0], e2=S2[price > 30.0], "
        "e3=S3[price > 40.0] "
        "select e1.symbol as s1, e2.symbol as s2, e3.symbol as s3 "
        "insert into OutStream;",
        [*_ones(("S1", "A", 25.0), ("S2", "B", 35.0), ("S3", "C", 45.0)),
         F]),
    "seq_condition_referencing_earlier_stream": (
        TWO + "from every e1=S1[price > 20.0], e2=S2[price > e1.price] "
        "select e1.price as p1, e2.price as p2 insert into OutStream;",
        [*_ones(("S1", "A", 25.0), ("S2", "B", 26.0)), F]),
    "seq_any_two_streams": (
        THREE + "from every e1=S1, e2=S2 select e1.price as p "
        "insert into OutStream;",
        [*_ones(("S1", "A", 1.0), ("S2", "B", 2.0), ("S2", "C", 3.0),
                ("S1", "D", 4.0), ("S1", "E", 5.0), ("S2", "G", 6.0)), F]),
    # TestLogicalSequences
    "seq_and_completes_in_either_order": (LSEQ, [
        *_ones(("S1", "A", 25.0), ("S2", "B", 35.0), ("S3", "C", 45.0)), F,
        *_ones(("S1", "D", 25.0), ("S3", "E", 45.0), ("S2", "F", 35.0),
               t0=2000), F]),
    "seq_non_matching_intervening_event_kills": (LSEQ, [
        *_ones(("S1", "A", 25.0), ("S2", "X", 5.0), ("S2", "B", 35.0),
               ("S3", "C", 45.0)), F]),
    "seq_or_completes_on_first_matching_leg": (
        TWO + "from every e1=S1[price > 20.0], e2=S2[price > 30.0] "
        "or e3=S1[price > 90.0] "
        "select e1.symbol as s1, e2.symbol as s2 insert into OutStream;",
        [*_ones(("S1", "A", 25.0), ("S2", "B", 35.0)), F]),
}

QUIET = {"seq_non_matching_next_kills",
         "seq_non_matching_intervening_event_kills"}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_every_and_sequence_shape_parity(name):
    app, script = SHAPES[name]
    want = _parity_dropped(PB + app, script)
    assert bool(want) == (name not in QUIET)


def test_pass_bound_truncation_is_counted():
    app, script = SHAPES["mid_every_pass_bound_counts_dropped"]
    rts = []
    from tests.test_torch_pattern import _run
    got = _run(siddhi_tpu_torch, PB + app, script, runtimes=rts,
               device="cpu")
    assert len(got) == 5
    assert int(rts[0].query_runtimes["query1"].state.dropped) == 2


# ------------------------------------------- multi-stream sequence interleaves


def _interleave(rng, rounds, batch, form):
    """`rounds` of `batch` rows over S and R in a random interleave, values
    over 0..3, 1 ms apart, sent one row at a time, or as runs of one stream
    by send_batch or by send_columns; a flush after each round."""
    script, t = [], 1000
    for _ in range(rounds):
        sid = np.where(rng.random(batch) < 0.5, "S", "R")
        k = rng.integers(0, 4, batch).astype(np.int32)
        v = rng.integers(0, 8, batch).astype(np.int32)
        start = 0
        while start < batch:
            end = start + 1
            if form != "send":
                while end < batch and sid[end] == sid[start]:
                    end += 1
            ts = t + np.arange(start, end)
            if form == "send":
                script.append(("one", sid[start], (int(k[start]),
                                                   int(v[start])),
                               int(ts[0])))
            elif form == "send_batch":
                script.append(("send", sid[start],
                               list(zip(k[start:end].tolist(),
                                        v[start:end].tolist())),
                               ts.tolist()))
            else:
                script.append(("cols", sid[start],
                               {"k": k[start:end], "v": v[start:end]}, ts))
            start = end
        script.append(F)
        t += batch
    return script


SEQ_APPS = {
    "pair": ("from every e1=S[v > 1], e2=R[k == e1.k] "
             "select e1.k as a, e1.v as b, e2.v as c insert into OutStream;"),
    "triple_logical": (
        "from every e1=S, e2=R[k == e1.k] and e3=S[v > e1.v] "
        "select e1.v as a, e2.v as b, e3.v as c insert into OutStream;"),
}


@pytest.mark.parametrize("form", ["send", "send_batch", "send_columns"])
@pytest.mark.parametrize("app", sorted(SEQ_APPS))
def test_multi_stream_sequence_interleaves(app, form):
    text = (PB + "define stream S (k int, v int);\n"
            "define stream R (k int, v int);\n" + SEQ_APPS[app])
    rounds, batch = (2, 128) if form == "send" else (4, 512)
    script = _interleave(np.random.default_rng(len(app) + len(form)),
                         rounds, batch, form)
    assert _parity_dropped(text, script, batch_size=512, pending=1024)


def test_merged_sequence_reads_the_send_order_not_the_batches():
    # the S rows and the R rows of one flush are different batches of
    # their own junctions; only the merged junction sees A, B, C, D
    text = (PB + "define stream S (k int, v int);\n"
            "define stream R (k int, v int);\n" + SEQ_APPS["pair"])
    script = [("one", "S", (1, 5), 1000), ("one", "R", (1, 6), 1001),
              ("one", "S", (2, 5), 1002), ("one", "R", (2, 7), 1003), F]
    assert [d for _, d in _parity_dropped(text, script)] == \
        [(1, 5, 6), (2, 5, 7)]


# --------------------------------------------------- random feeds, each form

RANDOM_APPS = {
    "mid_every": (
        "from every e1=S[v > 5] -> every e2=R[k == e1.k] within 150 "
        "milliseconds select e1.v as a, e2.v as b insert into OutStream;"),
    "head_group": (
        "from every (e1=S[v > 3] -> e2=S[k == e1.k]) -> e3=R[k == e2.k] "
        "within 200 milliseconds "
        "select e1.v as a, e2.v as b, e3.v as c insert into OutStream;"),
    "mid_group": (
        "from e0=R[v == 7] -> every (e1=S[v > 4] -> e2=S[k == e1.k]) -> "
        "e3=R[k == e2.k] within 200 milliseconds "
        "select e1.v as a, e2.v as b, e3.v as c insert into OutStream;"),
    "every_mid_group": (
        "from every e0=R[v == 7] -> every (e1=S[v > 4] -> e2=S[k == e1.k]) "
        "-> e3=R[k == e2.k] within 250 milliseconds "
        "select e0.k as z, e1.v as a, e2.v as b, e3.v as c "
        "insert into OutStream;"),
}


def random_script(seed, rounds=4, batch=512, k_hi=16):
    rng = np.random.default_rng(seed)
    script, t = [], 1000
    for _ in range(rounds):
        for sid in ("S", "R"):
            cols = {"k": rng.integers(0, k_hi, batch).astype(np.int32),
                    "v": rng.integers(0, 8, batch).astype(np.int32)}
            script += [("cols", sid, cols, t + np.arange(batch) // 8), F]
            t += batch // 8
        script.append(("hb", t + 30))
    return script


@pytest.mark.parametrize("name", sorted(RANDOM_APPS))
def test_random_feeds_of_each_every_form(name):
    app = (PB + "define stream S (k int, v int);\n"
           "define stream R (k int, v int);\n" + RANDOM_APPS[name])
    assert _parity_dropped(app, random_script(len(name)), batch_size=512,
                           pending=2048)


# ----------------------------------- K11d and K11e against the JAX expressions

STICKY_APP = ("define stream S (v int, k string, x float);\n"
              "@info(name = 'q')\n"
              "from every a=S -> every b=S[b.v == a.v and b.k == a.k and "
              "b.x > 10.0 and b.x > a.x] within 5 sec "
              "select a.v as av, b.v as bv insert into OutStream;")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_count_matches_the_jax_sum(seed):
    B, P, seq0 = 48, 96, 500
    jqr, tqr = _runtimes(STICKY_APP, P, B)
    rng = np.random.default_rng(seed)
    valid = rng.random(B) < 0.8
    cols = {"v": rng.integers(1, 3, B).astype(np.int32),
            "k": rng.integers(1, 3, B).astype(np.int32),
            "x": rng.uniform(0, 20, B).astype(np.float32)}
    ts = (10_000 + np.sort(rng.integers(0, 3000, B))).astype(np.int64)
    arr_seq = np.where(valid, seq0 + np.cumsum(valid) - 1, BIGSEQ)
    pend = {"v": rng.integers(1, 3, P).astype(np.int32),
            "k": rng.integers(1, 3, P).astype(np.int32),
            "x": rng.uniform(0, 20, P).astype(np.float32)}
    last_seq = np.where(rng.random(P) < 0.4, seq0 + rng.integers(-1, B, P),
                        seq0 - 1 - rng.integers(0, 50, P)).astype(np.int64)
    start = (10_000 - rng.integers(-100, 5600, P)).astype(np.int64)
    pvalid = rng.random(P) < 0.6
    fvalid, fts = rng.random(P) < 0.9, rng.integers(0, 9_000, P)
    jbatch = JBatch(ts=jnp.asarray(ts), cols={k: jnp.asarray(v)
                                              for k, v in cols.items()},
                    valid=jnp.asarray(valid), types=jnp.zeros(B, jnp.int8))
    jpend = JPending(
        frames={"a": {k: jnp.asarray(v) for k, v in pend.items()}},
        frame_valid={"a": jnp.asarray(fvalid)},
        frame_ts={"a": jnp.asarray(fts)}, start_ts=jnp.asarray(start),
        last_seq=jnp.asarray(last_seq), armed_ts=jnp.asarray(start),
        valid=jnp.asarray(pvalid), leg_done=jnp.zeros((P, 2), bool),
        origin=jnp.full((P,), -1, jnp.int32))
    # the JAX step's sticky count, pattern_runtime.py:1318-1331
    leg = jqr.plan.positions[1].legs[0]
    q = jqr._leg_cond(leg, jbatch, jpend, jnp.int64(13_000))
    q = q & jpend.valid[None, :] & (
        jnp.asarray(arr_seq)[:, None] > jpend.last_seq[None, :])
    q = q & (jbatch.ts[:, None] - jpend.start_ts[None, :] <= 5000)
    want = int(jnp.sum(q, dtype=jnp.int64))
    tbatch = TBatch(ts=_t(ts), cols={k: _t(v) for k, v in cols.items()},
                    valid=_t(valid), types=torch.zeros(B, dtype=torch.int8))
    tpend = tp.PendingTable(
        frames={"a": {k: _t(v) for k, v in pend.items()}},
        frame_valid={"a": _t(fvalid)}, frame_ts={"a": _t(fts)},
        start_ts=_t(start), last_seq=_t(last_seq), armed_ts=_t(start),
        valid=_t(pvalid), leg_done=torch.zeros((P, 2), dtype=torch.bool),
        origin=torch.full((P,), -1, dtype=torch.int32))
    tleg = tqr.plan.positions[1].legs[0]
    assert len(tleg.eq) == 2 and len(tleg.resid) == 1
    got = tqr._count(tleg, tbatch, tpend, _t(arr_seq), 5000)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want > 0
    args = (_t(arr_seq), _t(ts), _t(valid), [(_t(cols["v"]),
                                               tpend.frames["a"]["v"])],
            tpend.valid, tpend.last_seq, tpend.start_ts, 5000)
    one = tp.match_count_plain(*args)
    for tile in (1, 7, 64):
        assert torch.equal(tp.match_count_plain(*args, tile=tile), one)


@pytest.mark.parametrize("seed", [0, 1])
def test_release_origin_matches_the_jax_scatters(seed):
    rng = np.random.default_rng(seed)
    P, W = 64, 200
    leg_done = rng.random((P, 2)) < 0.5
    last_seq = rng.integers(0, 1000, P)
    valid = rng.random(W) < 0.7
    origin = np.where(rng.random(W) < 0.15, -1,
                      rng.integers(0, 12, W)).astype(np.int32)
    seq = rng.integers(0, 2000, W)
    # _advance, pattern_runtime.py:1440-1446
    o = jnp.where(jnp.asarray(valid) & (jnp.asarray(origin) >= 0),
                  jnp.asarray(origin), P)
    want_ld = jnp.asarray(leg_done).at[o, 0].set(False, mode="drop")
    want_ls = jnp.asarray(last_seq).at[o].max(jnp.asarray(seq), mode="drop")
    table = tp.PendingTable(
        frames={}, frame_valid={}, frame_ts={},
        start_ts=torch.zeros(P, dtype=torch.int64), last_seq=_t(last_seq),
        armed_ts=torch.zeros(P, dtype=torch.int64),
        valid=torch.ones(P, dtype=torch.bool), leg_done=_t(leg_done),
        origin=torch.full((P,), -1, dtype=torch.int32))
    got = tp.release_origin(table, _t(valid), _t(origin), _t(seq))
    np.testing.assert_array_equal(got.leg_done.numpy(), np.asarray(want_ld))
    np.testing.assert_array_equal(got.last_seq.numpy(), np.asarray(want_ls))
    # several completions share an origin: the max wins
    assert (np.bincount(origin[valid & (origin >= 0)]) > 1).any()
    assert not np.array_equal(np.asarray(want_ls), last_seq)


# ------------------------------------------------------------------ interop


@pytest.mark.parametrize("name", ["mid_every", "every_mid_group"])
def test_interop_continues_a_jax_every_app(name):
    app = (PB + "define stream S (k int, v int);\n"
           "define stream R (k int, v int);\n@info(name = 'q')\n"
           + RANDOM_APPS[name])
    # few keys keep the sticky entries matching; many keep iterations in
    # flight across batches
    script = random_script(11, rounds=4, batch=64,
                           k_hi=6 if name == "mid_every" else 40)
    head, tail = script[:7], script[7:]
    with _pending_capacity(256):
        jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
            app, batch_size=64)
        trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app, batch_size=64)
    jout, tout = [], []
    jrt.add_callback("OutStream", lambda evs: jout.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    trt.add_callback("OutStream", lambda evs: tout.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    _feed(jrt, head)
    jstate = jax.device_get(jrt.query_runtimes["q"].state)
    assert int(np.asarray(jstate.pending[0].valid).sum()) > 0
    if name == "every_mid_group":  # iterations in flight: latches, origins
        assert bool(np.asarray(jstate.pending[0].leg_done)[:, 0].any())
        assert bool((np.asarray(jstate.pending[1].origin) >= 0).any())
    n_head = len(jout)
    interop.load_app_state(trt, {"q": jstate},
                           list(jrt.ctx.global_strings._to_str))
    trt.ctx.timestamp_generator.observe_event_time(
        jrt.ctx.timestamp_generator.current_time())
    _feed(jrt, tail)
    _feed(trt, tail)
    assert len(jout) > n_head
    _assert_same(jout[n_head:], tout)
    assert int(trt.query_runtimes["q"].state.dropped) == \
        int(jrt.query_runtimes["q"].state.dropped)
