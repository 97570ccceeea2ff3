"""Absent patterns of siddhi_tpu_torch against the JAX package on the CPU:
the K11c kernel's plain version (`absent_scan`) against the JAX step's
kill masks, every shape of tests/test_absent_patterns.py built on absent
positions (trailing, leading, middle, logical, timed `not X for t and Y`,
`every not`) through the public API, seeded random feeds of each form, and
a mid-run JAX state of an absent app that the port continues.

Inputs are made with numpy from a seed and handed to both packages. Every
event must be equal, in order: timestamps, ints, strings and captured
floats exactly (captures are copies, with no arithmetic), and the
`dropped` counters too.
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
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.ops import pattern as tp
from tests.test_torch_pattern import (BIGSEQ, F, THREE, _assert_same,
                                      _pending_capacity, _run, _runtimes, _t)

PB = "@app:playback\n"


def _send(sid, sym, price, ts):
    return [("send", sid, [(sym, price)], [ts]), F]


def _hb(t):
    return [("hb", t)]


def _parity_dropped(app, script, **kw):
    """Both packages' events (in order) and `dropped` counters agree."""
    out = {}
    for pkg, extra in ((siddhi_tpu, {}), (siddhi_tpu_torch,
                                           {"device": "cpu"})):
        rts = []
        got = _run(pkg, app, script, runtimes=rts, **kw, **extra)
        out[pkg.__name__] = (got, [int(qr.state.dropped)
                                   for qr in rts[0].query_runtimes.values()])
    (want, wd), (got, gd) = out["siddhi_tpu"], out["siddhi_tpu_torch"]
    _assert_same(want, got)
    assert gd == wd
    return want


TRAILING = (THREE + "from e1=S1[price>20] -> not S2[price>e1.price] for 1 sec "
            "select e1.symbol as s insert into OutStream;")
LEADING = (THREE + "from not S1[price>20] for 1 sec -> e2=S2[price>30] "
           "select e2.symbol as s insert into OutStream;")
MIDDLE = (THREE + "from e1=S1[price>10] -> not S2[price>20] for 1 sec -> "
          "e3=S3[price>30] "
          "select e1.symbol as a, e3.symbol as c insert into OutStream;")
LOGICAL = (THREE + "from e1=S1[price>10] -> not S2[price>20] and "
           "e3=S3[price>30] "
           "select e1.symbol as a, e3.symbol as c insert into OutStream;")
EVERY_TRAILING = (THREE + "from every e1=S1[price>20] -> not S2 for 1 sec "
                  "select e1.symbol as s insert into OutStream;")
TIMED = (THREE + "from e1=S1[price>10.0] -> "
         "not S2[price>20.0] for 1 sec and e3=S3[price>30.0] "
         "select e1.symbol as s1, e3.symbol as s3 insert into OutStream;")
EVERY_NOT = (THREE + "from e1=S1[price>20] -> every not S2[price>e1.price] "
             "for 1 sec select e1.symbol as s insert into OutStream;")
LEADING_EVERY_NOT = (THREE + "from every not S1[price>20] for 1 sec -> "
                     "e2=S2[price>30] select e2.symbol as s "
                     "insert into OutStream;")
CHAIN = (THREE + "from e1=S1[price>10] -> e2=S2[price>20] -> "
         "not S3[price>30] for 1 sec "
         "select e1.symbol as a, e2.symbol as b insert into OutStream;")
EPOCH = 1_700_000_000_000

# the shapes of tests/test_absent_patterns.py, class by class, as scripts
SHAPES = {
    # TestTrailingAbsent
    "trailing_fires_when_nothing_bigger_arrives": (TRAILING, [
        *_send("S1", "IBM", 25.0, 1_000), *_send("S2", "LO", 10.0, 1_400),
        *_hb(2_500)]),
    "trailing_killed_by_correlated_match": (TRAILING, [
        *_send("S1", "IBM", 25.0, 1_000), *_send("S2", "HI", 30.0, 1_400),
        *_hb(2_500)]),
    "trailing_filter_below_threshold_never_arms": (TRAILING, [
        *_send("S1", "IBM", 15.0, 1_000), *_hb(2_500)]),
    "trailing_after_chain": (CHAIN, [
        *_send("S1", "A", 15.0, 1_000), *_send("S2", "B", 25.0, 1_500),
        *_hb(3_000)]),
    "trailing_after_chain_killed": (CHAIN, [
        *_send("S1", "A", 15.0, 1_000), *_send("S2", "B", 25.0, 1_500),
        *_send("S3", "C", 35.0, 2_000), *_hb(3_000)]),
    # TestLeadingAbsent
    "leading_fires_after_quiet_period": (LEADING, [
        *_hb(100), *_hb(1_500), *_send("S2", "OK", 35.0, 1_600)]),
    "leading_epoch_replay_does_not_fire_spuriously": (LEADING, [
        *_send("S1", "X", 25.0, EPOCH + 100),
        *_send("S2", "OK", 35.0, EPOCH + 1_600), *_hb(EPOCH + 3_000)]),
    "leading_blocked_by_early_event": (LEADING, [
        *_send("S1", "X", 25.0, 500), *_send("S2", "OK", 35.0, 1_600),
        *_hb(3_000)]),
    "leading_e2_before_quiet_period_does_not_match": (LEADING, [
        *_send("S2", "EARLY", 35.0, 400), *_hb(3_000)]),
    # TestMiddleAbsent
    "middle_fires_when_gap_is_quiet": (MIDDLE, [
        *_send("S1", "A", 15.0, 1_000), *_hb(2_200),
        *_send("S3", "C", 35.0, 2_300)]),
    "middle_blocked_by_middle_event": (MIDDLE, [
        *_send("S1", "A", 15.0, 1_000), *_send("S2", "B", 25.0, 1_500),
        *_hb(2_200), *_send("S3", "C", 35.0, 2_300)]),
    "middle_e3_too_early_does_not_match": (MIDDLE, [
        *_send("S1", "A", 15.0, 1_000), *_send("S3", "C", 35.0, 1_500),
        *_hb(3_000)]),
    # TestLogicalAbsent
    "logical_fires_with_partner_when_quiet": (LOGICAL, [
        *_send("S1", "A", 15.0, 1_000), *_send("S3", "C", 35.0, 1_800)]),
    "logical_blocked_by_absent_stream_event": (LOGICAL, [
        *_send("S1", "A", 15.0, 1_000), *_send("S2", "B", 25.0, 1_400),
        *_send("S3", "C", 35.0, 1_800)]),
    # TestEveryAbsent
    "every_trailing_absent_repeats": (EVERY_TRAILING, [
        *_send("S1", "A", 25.0, 1_000), *_hb(2_500),
        *_send("S1", "B", 26.0, 3_000), *_hb(4_500)]),
    "every_arm_killed_independently": (EVERY_TRAILING, [
        *_send("S1", "A", 25.0, 1_000), *_send("S2", "K", 1.0, 1_500),
        *_send("S1", "B", 26.0, 3_000), *_hb(4_500)]),
    # TestTimedNotAnd
    "timed_partner_after_period_fires": (TIMED, [
        *_send("S1", "WSO2", 15.0, 1000), *_send("S3", "GOOGLE", 35.0, 2200)]),
    "timed_partner_inside_period_fires_at_deadline": (TIMED, [
        *_send("S1", "WSO2", 15.0, 1000), *_send("S3", "GOOGLE", 35.0, 1500),
        *_hb(2100)]),
    "timed_no_fire_before_deadline": (TIMED, [
        *_send("S1", "WSO2", 15.0, 1000),
        *_send("S3", "GOOGLE", 35.0, 1100)]),
    "timed_x_inside_period_kills": (TIMED, [
        *_send("S1", "WSO2", 15.0, 1000), *_send("S2", "IBM", 25.0, 1100),
        *_send("S3", "GOOGLE", 35.0, 1200), *_hb(3000)]),
    "timed_x_after_period_is_ignored": (TIMED, [
        *_send("S1", "WSO2", 15.0, 1000), *_send("S2", "IBM", 25.0, 2100),
        *_send("S3", "GOOGLE", 35.0, 2200)]),
    "timed_x_kills_even_after_partner_captured": (TIMED, [
        *_send("S1", "WSO2", 15.0, 1000), *_send("S3", "GOOGLE", 35.0, 1100),
        *_send("S2", "IBM", 25.0, 1200), *_hb(3000)]),
    # TestEveryNot
    "every_not_fires_each_quiet_period": (EVERY_NOT, [
        *_send("S1", "WSO2", 55.6, 1_000), *_hb(2_050), *_hb(3_050),
        *_hb(4_050)]),
    "every_not_within_caps_periods": (
        THREE + "from (e1=S1[price>20] -> every not S2[price>e1.price] "
        "for 900 millisecond) within 2 sec "
        "select e1.symbol as s insert into OutStream;",
        [*_send("S1", "WSO2", 55.6, 1_000), *_hb(2_000), *_hb(2_900),
         *_hb(3_800), *_hb(4_700)]),
    "every_not_killed_permanently": (EVERY_NOT, [
        *_send("S1", "WSO2", 55.6, 1_000), *_hb(2_050), *_hb(3_050),
        *_send("S2", "IBM", 58.7, 3_100), *_hb(5_000)]),
    "leading_every_not_entries_accumulate": (LEADING_EVERY_NOT, [
        *_hb(100), *_hb(1_150), *_hb(2_200),
        *_send("S2", "IBM", 58.7, 2_300)]),
    "leading_every_not_kill_restarts_measurement": (LEADING_EVERY_NOT, [
        *_hb(100), *_send("S1", "X", 25.0, 600), *_hb(1_200),
        *_send("S2", "EARLY", 35.0, 1_250), *_hb(1_800),
        *_send("S2", "OK", 35.0, 1_900)]),
    "every_not_late_match_consumes_after_fire": (EVERY_NOT, [
        *_send("S1", "WSO2", 55.6, 1_000), *_send("S2", "IBM", 58.7, 2_500),
        *_hb(3_600), *_hb(4_600)]),
    "leading_every_not_late_match_restarts": (LEADING_EVERY_NOT, [
        *_hb(100), *_send("S1", "X", 25.0, 1_500), *_hb(2_000),
        *_send("S2", "OK", 35.0, 2_100)]),
    # the absent and not_and forms the port once refused at plan time
    "every_absent_after_any_s1": (
        THREE + "from every e1=S1 -> not S2 for 1 sec select e1.price as p "
        "insert into OutStream;",
        [*_send("S1", "A", 1.0, 1_000), *_send("S1", "B", 2.0, 1_300),
         *_send("S2", "K", 3.0, 2_100), *_send("S1", "C", 4.0, 2_200),
         *_hb(4_000)]),
    "not_and_without_filters": (
        THREE + "from e1=S1 -> not S2 and e3=S3 select e1.price as p "
        "insert into OutStream;",
        [*_send("S1", "A", 1.0, 1_000), *_send("S3", "C", 3.0, 1_100),
         *_send("S1", "B", 2.0, 1_200), *_send("S3", "D", 4.0, 1_300)]),
}

#: shapes whose reference output is empty
QUIET = {"trailing_killed_by_correlated_match",
         "trailing_filter_below_threshold_never_arms",
         "trailing_after_chain_killed",
         "leading_epoch_replay_does_not_fire_spuriously",
         "leading_blocked_by_early_event",
         "leading_e2_before_quiet_period_does_not_match",
         "middle_blocked_by_middle_event",
         "middle_e3_too_early_does_not_match",
         "logical_blocked_by_absent_stream_event",
         "timed_no_fire_before_deadline", "timed_x_inside_period_kills",
         "timed_x_kills_even_after_partner_captured"}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_absent_shape_parity(name):
    app, script = SHAPES[name]
    want = _parity_dropped(PB + app, script)
    assert bool(want) == (name not in QUIET)


def test_within_inside_every_group_is_refused_as_in_jax():
    app = (PB + THREE + "from e1=S1[price>20] -> every ((not "
           "S2[price>e1.price] for 1 sec) within 2 sec) "
           "select e1.symbol as s insert into OutStream;")
    from siddhi_tpu.errors import SiddhiAppCreationError as JErr
    with pytest.raises(JErr, match="within"):
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    with pytest.raises(SiddhiAppCreationError, match="within"):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app)


def test_a_heartbeat_drives_the_absent_completion():
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(PB + TRAILING)
    assert next(iter(rt.query_runtimes.values())).has_time_semantics


# ----------------------------------------------------- random feeds, each form

RANDOM_APPS = {
    "trailing": (
        "from every e1=S[v > 2] -> not R[k == e1.k and v > e1.v] "
        "for 30 milliseconds select e1.k as a, e1.v as b "
        "insert into OutStream;"),
    "middle": (
        "from every e1=S[v > 3] -> not R[k == e1.k] for 20 milliseconds -> "
        "e3=S[k == e1.k] select e1.v as a, e3.v as c insert into OutStream;"),
    "leading_every": (
        "from every not R[v > 5] for 25 milliseconds -> e2=S[v > 4] "
        "select e2.k as a, e2.v as b insert into OutStream;"),
    "logical": (
        "from every e1=S[v > 4] -> not R[k == e1.k] and e3=S[v < e1.v] "
        "select e1.v as a, e3.v as c insert into OutStream;"),
    "timed_logical": (
        "from every e1=S[v > 4] -> not R[k == e1.k] for 15 milliseconds "
        "and e3=R[v < 3] select e1.v as a, e3.v as c insert into OutStream;"),
    "every_not": (
        "from every e1=S[v > 5] -> every not R[k == e1.k] for 20 "
        "milliseconds select e1.k as a, e1.v as b insert into OutStream;"),
}


def random_script(seed, rounds=4, batch=512, k_hi=40, v_hi=8):
    """4 rounds of 512 events a stream (S then R), 1 ms apart, a heartbeat
    after each round; values small so kills and matches both happen."""
    rng = np.random.default_rng(seed)
    script, t = [], 1000
    for _ in range(rounds):
        for sid in ("S", "R"):
            cols = {"k": rng.integers(0, k_hi, batch).astype(np.int32),
                    "v": rng.integers(0, v_hi, batch).astype(np.int32)}
            script += [("cols", sid, cols, t + np.arange(batch)), F]
            t += batch // 4
        script.append(("hb", t + 40))
    return script


@pytest.mark.parametrize("name", sorted(RANDOM_APPS))
def test_random_feeds_of_each_absent_form(name):
    app = (PB + "define stream S (k int, v int);\n"
           "define stream R (k int, v int);\n" + RANDOM_APPS[name])
    assert _parity_dropped(app, random_script(len(name)), batch_size=512,
                           pending=2048)


# ------------------------------------------------- K11c against the JAX masks


ABSENT_APP = ("define stream S (v int, k string, x float);\n"
              "@info(name = 'q')\n"
              "from every a=S -> not S[v == a.v and k == a.k and x > 10.0 "
              "and x > a.x] for 2 sec "
              "select a.v as av insert into OutStream;")


@pytest.mark.parametrize("timer", [True, False], ids=["deadline", "untimed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_absent_scan_matches_the_jax_masks(timer, seed):
    B, P, seq0 = 48, 96, 500
    jqr, tqr = _runtimes(ABSENT_APP, P, B)
    rng = np.random.default_rng(seed)
    valid = rng.random(B) < 0.8
    cols = {"v": rng.integers(1, 4, B).astype(np.int32),
            "k": rng.integers(1, 3, B).astype(np.int32),
            "x": rng.uniform(0, 20, B).astype(np.float32)}
    ts = (10_000 + np.sort(rng.integers(0, 3000, B))).astype(np.int64)
    arr_seq = np.where(valid, seq0 + np.cumsum(valid) - 1, BIGSEQ)
    pend = {"v": rng.integers(1, 4, P).astype(np.int32),
            "k": rng.integers(1, 3, P).astype(np.int32),
            "x": rng.uniform(0, 20, P).astype(np.float32)}
    last_seq = np.where(rng.random(P) < 0.4, seq0 + rng.integers(-1, B, P),
                        seq0 - 1 - rng.integers(0, 50, P)).astype(np.int64)
    armed = (8_000 + rng.integers(0, 3500, P)).astype(np.int64)
    pvalid = rng.random(P) < 0.6
    fvalid, fts = rng.random(P) < 0.9, rng.integers(0, 9_000, P)
    jbatch = JBatch(ts=jnp.asarray(ts), cols={k: jnp.asarray(v)
                                              for k, v in cols.items()},
                    valid=jnp.asarray(valid), types=jnp.zeros(B, jnp.int8))
    jpend = JPending(
        frames={"a": {k: jnp.asarray(v) for k, v in pend.items()}},
        frame_valid={"a": jnp.asarray(fvalid)},
        frame_ts={"a": jnp.asarray(fts)}, start_ts=jnp.asarray(armed),
        last_seq=jnp.asarray(last_seq), armed_ts=jnp.asarray(armed),
        valid=jnp.asarray(pvalid), leg_done=jnp.zeros((P, 2), bool),
        origin=jnp.full((P,), -1, jnp.int32))
    # the JAX step's expressions (pattern_runtime.py:871-882, 1088-1094),
    # masked by the live entries as every use of them is
    leg = jqr.plan.positions[1].legs[0]
    kill = jqr._leg_cond(leg, jbatch, jpend, jnp.int64(13_000))
    kill = kill & (jnp.asarray(arr_seq)[:, None] > jpend.last_seq[None, :])
    kill = kill & jpend.valid[None, :]
    deadline = jpend.armed_ts + 2000
    in_period = jbatch.ts[:, None] < deadline[None, :]
    want = (jnp.min(jnp.where(kill, jnp.asarray(arr_seq)[:, None], BIGSEQ),
                    axis=0),
            (kill & in_period).any(0) if timer else kill.any(0),
            (kill & ~in_period).any(0) if timer else jnp.zeros(P, bool))
    tbatch = TBatch(ts=_t(ts), cols={k: _t(v) for k, v in cols.items()},
                    valid=_t(valid), types=torch.zeros(B, dtype=torch.int8))
    tpend = tp.PendingTable(
        frames={"a": {k: _t(v) for k, v in pend.items()}},
        frame_valid={"a": _t(fvalid)}, frame_ts={"a": _t(fts)},
        start_ts=_t(armed), last_seq=_t(last_seq), armed_ts=_t(armed),
        valid=_t(pvalid), leg_done=torch.zeros((P, 2), dtype=torch.bool),
        origin=torch.full((P,), -1, dtype=torch.int32))
    tleg = tqr.plan.positions[1].legs[0]
    assert [e[0] for e in tleg.eq] == ["v", "k"]
    assert len(tleg.lane) == 1 and len(tleg.resid) == 1
    got = tqr._absent(tleg, tbatch, tpend, _t(arr_seq),
                      tpend.armed_ts + 2000 if timer else None)
    for what, g, w in zip(("first", "before", "after"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)
    assert int((got[0] < BIGSEQ).sum()) > 0
    if timer:
        assert int(got[1].sum()) > 0 and int(got[2].sum()) > 0
    # tiles of entries give the same answer as one
    args = (_t(arr_seq), _t(ts), _t(valid & (cols["x"] > 10)),
            [(_t(cols["v"]), tpend.frames["a"]["v"])], tpend.valid,
            tpend.last_seq, tpend.armed_ts + 2000 if timer else None)
    one = tp.absent_scan_plain(*args)
    for tile in (1, 7, 64):
        for a, b in zip(tp.absent_scan_plain(*args, tile=tile), one):
            assert torch.equal(a, b)


# ------------------------------------------------------------------ interop


def test_interop_continues_a_jax_absent_app():
    app = (PB + "define stream S (k int, v int);\n"
           "define stream R (k int, v int);\n@info(name = 'q')\n"
           "from every e1=S[v > 4] -> not R[k == e1.k] for 500 milliseconds "
           "and e3=R[v < 3] select e1.v as a, e3.v as c "
           "insert into OutStream;")
    script = random_script(9, rounds=4, batch=64)
    # stop inside the first timers: partners captured, none due yet
    head, tail = script[:4], script[4:] + [("hb", 10_000)]
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
    assert bool(np.asarray(jstate.pending[0].leg_done)[:, 1].any())
    n_head = len(jout)
    interop.load_app_state(trt, {"q": jstate},
                           list(jrt.ctx.global_strings._to_str))
    trt.ctx.timestamp_generator.observe_event_time(
        jrt.ctx.timestamp_generator.current_time())
    _feed(jrt, tail)
    _feed(trt, tail)
    assert len(jout) > n_head
    _assert_same(jout[n_head:], tout)


def _feed(rt, ops):
    for op in ops:
        if op[0] == "cols":
            rt.get_input_handler(op[1]).send_columns(op[2], timestamps=op[3])
        elif op[0] == "flush":
            rt.flush()
        else:
            rt.heartbeat(op[1])
