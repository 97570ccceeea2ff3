"""Patterns and single-stream sequences of siddhi_tpu_torch against the JAX
package on the CPU: the two pattern primitives (the plain versions of
kernels K11a `first_match` and K11b `pending_insert`) against the JAX
step's own arrays, the shapes of tests/test_patterns.py this slice
supports through the public API, `within` expiry by heartbeat, a
pending-table overflow, BASELINE config 4 (apps H and I of chip_smoke.py
at a reduced size, also against that script's numpy oracle) and interop
of a mid-run state. Absent positions are in tests/test_torch_absent.py,
every-groups, the mid-pattern `every` and multi-stream sequences in
tests/test_torch_every.py.

Inputs are made with numpy from a seed and handed to both packages. App
events must be equal: ints, strings and timestamps exactly, floats within
rtol 1e-5 (tests/test_numeric_parity.py; the patterns here copy stored
float32 values, so they agree exactly in practice).
"""

import contextlib
import importlib.util
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import dtypes as jdtypes
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.core.pattern_runtime import PendingTable as JPending
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import dtypes as tdtypes
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops import pattern as tp

FLOAT_RTOL = 1e-5
BIGSEQ = 2**62
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _pending_capacity(P):
    """Both packages read the pending capacity when a runtime is built."""
    prev = (jdtypes.config.pattern_pending_capacity,
            tdtypes.config.pattern_pending_capacity)
    jdtypes.config.pattern_pending_capacity = P
    tdtypes.config.pattern_pending_capacity = P
    try:
        yield
    finally:
        (jdtypes.config.pattern_pending_capacity,
         tdtypes.config.pattern_pending_capacity) = prev


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------- the primitives

PRIM_APP = ("define stream S (v int, k string, x float);\n"
            "@info(name = 'q')\n"
            "from every a=S{sep} b=S[b.v == a.v and b.k == a.k and "
            "b.x > 10.0 and b.x > a.x] within 5 sec "
            "select a.v as av, b.v as bv insert into OutStream;")


def _runtimes(app, P, B):
    with _pending_capacity(P):
        jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
            app, batch_size=B)
        trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app, batch_size=B)
    return jrt.query_runtimes["q"], trt.query_runtimes["q"]


def _prim_inputs(seed, B, P, seq0):
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
    inside = rng.random(P) < 0.4
    last_seq = np.where(inside, seq0 + rng.integers(-1, B, P),
                        seq0 - 1 - rng.integers(0, 50, P)).astype(np.int64)
    fields = dict(
        fvalid=rng.random(P) < 0.9,
        fts=rng.integers(0, 10_000, P).astype(np.int64),
        start_ts=(10_000 - rng.integers(-100, 5600, P)).astype(np.int64),
        last_seq=last_seq, armed_ts=rng.integers(0, 10_000, P),
        valid=rng.random(P) < 0.5)
    return valid, cols, ts, arr_seq, pend, fields


def _jax_mask(jqr, jbatch, jpend, arr_seq, last_seq, now, sequence, within):
    """The JAX step's per-position pass, :1196-1226, on its own _leg_cond."""
    leg = jqr.plan.positions[1].legs[0]
    q = jqr._leg_cond(leg, jbatch, jpend, jnp.int64(now))
    q = q & jpend.valid[None, :]
    if sequence:
        q = q & (arr_seq[:, None] == last_seq[None, :] + 1)
    else:
        q = q & (arr_seq[:, None] > last_seq[None, :])
    q = q & (jbatch.ts[:, None] - jpend.start_ts[None, :] <= within)
    killed = jnp.zeros(q.shape[1], bool)
    if sequence:
        nxt = ((arr_seq[:, None] == last_seq[None, :] + 1)
               & jbatch.valid[:, None])
        killed = (nxt & ~q).any(axis=0) & jpend.valid
        q = q & ~killed[None, :]
    qseq = jnp.where(q, arr_seq[:, None], BIGSEQ)
    return jnp.argmin(qseq, axis=0), q.any(axis=0), killed


@pytest.mark.parametrize("sequence", [False, True],
                         ids=["pattern", "sequence"])
@pytest.mark.parametrize("seed", [0, 1])
def test_first_match_matches_the_jax_step(sequence, seed):
    B, P, seq0 = 48, 96, 500
    jqr, tqr = _runtimes(PRIM_APP.format(sep="," if sequence else " ->"),
                         P, B)
    valid, cols, ts, arr_seq, pend, f = _prim_inputs(seed, B, P, seq0)
    if sequence:  # put most entries next to a lane
        f["last_seq"] = (seq0 - 1 + np.random.default_rng(seed).integers(
            -2, B, P)).astype(np.int64)
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
                     jnp.asarray(f["last_seq"]), 13_000, sequence, 5000)
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
    # the split: two equalities in the kernel, one conjunct on the arrival
    # alone, one left as a residual mask
    assert [e[0] for e in leg.eq] == ["v", "k"]
    assert len(leg.lane) == 1 and len(leg.resid) == 1
    got = tqr._match(leg, tbatch, tpend, _t(arr_seq), tpend.last_seq,
                     torch.tensor(seq0), sequence, 5000)
    for name, g, w in zip(("b_star", "matched", "killed"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert int(got[1].sum()) > 0
    if sequence:
        assert int(got[2].sum()) > 0
    # tiles of entries give the same answer as one
    args = (_t(arr_seq), _t(ts), _t(valid), _t(valid & (cols["x"] > 10)),
            [(_t(cols["v"]), tpend.frames["a"]["v"])], tpend.valid,
            tpend.last_seq, tpend.start_ts, 5000, sequence)
    one = tp.first_match_plain(*args)
    for tile in (1, 7, 64):
        for a, b in zip(tp.first_match_plain(*args, tile=tile), one):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fill,W,p_cand,full_frames", [
    (0.5, 12, 0.7, True), (0.9, 16, 0.9, True), (0.3, 10, 0.8, False)],
    ids=["free_slots", "overflow", "partial_frames"])
def test_pending_insert_matches_the_jax_insert(fill, W, p_cand,
                                               full_frames):
    P = 32
    app = ("define stream S (v int, x float);\n@info(name = 'q')\n"
           "from every a=S -> b=S -> c=S select a.v as av "
           "insert into OutStream;")
    jqr, tqr = _runtimes(app, P, 8)
    rng = np.random.default_rng(int(fill * 10) + W)

    def table_np():
        return dict(
            frames={r: {"v": rng.integers(0, 9, P).astype(np.int32),
                        "x": rng.uniform(0, 1, P).astype(np.float32)}
                    for r in ("a", "b")},
            frame_valid={r: rng.random(P) < 0.7 for r in ("a", "b")},
            frame_ts={r: rng.integers(0, 99, P) for r in ("a", "b")},
            start_ts=rng.integers(0, 99, P), last_seq=rng.integers(0, 99, P),
            armed_ts=rng.integers(0, 99, P), valid=rng.random(P) < fill,
            leg_done=rng.random((P, 2)) < 0.3,
            origin=np.full(P, -1, np.int32))

    dst = table_np()
    refs = ("a", "b") if full_frames else ("b",)
    frames = {r: {"v": rng.integers(0, 9, W).astype(np.int32),
                  "x": rng.uniform(0, 1, W).astype(np.float32)}
              for r in refs}
    valid = rng.random(W) < p_cand
    fvalid = {"b": rng.random(W) < 0.5}  # "a" takes the candidates' valid
    fts = {r: rng.integers(0, 99, W) for r in refs}
    rest = [rng.integers(0, 99, W) for _ in range(3)]

    def conv(x, fn):
        if isinstance(x, dict):
            return {k: conv(v, fn) for k, v in x.items()}
        return fn(x)

    jtab, jdrop = jqr._insert_entries(
        JPending(**conv(dst, jnp.asarray)), conv(frames, jnp.asarray),
        conv(fvalid, jnp.asarray), conv(fts, jnp.asarray),
        *[jnp.asarray(r) for r in rest], jnp.asarray(valid))
    ttab, tdrop = tp.pending_insert(
        tp.PendingTable(**conv(dst, _t)), conv(frames, _t),
        conv(fvalid, _t), conv(fts, _t), *[_t(r) for r in rest], _t(valid))
    assert int(tdrop) == int(jdrop)
    assert (int(tdrop) > 0) == (fill == 0.9)
    for f in tp.PendingTable._fields:
        a, b = getattr(ttab, f), getattr(jtab, f)
        if isinstance(a, dict):
            for r in a:
                if isinstance(a[r], dict):
                    for n in a[r]:
                        np.testing.assert_array_equal(
                            a[r][n].numpy(), np.asarray(b[r][n]),
                            err_msg=f"{f} {r} {n}")
                else:
                    np.testing.assert_array_equal(
                        a[r].numpy(), np.asarray(b[r]), err_msg=f"{f} {r}")
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)


# ------------------------------------------------------------------ apps


def _run(pkg, app, script, batch_size=8, out="OutStream", pending=None,
         runtimes=None, **kw):
    """Drive an app with a script of ("send", stream, rows, ts) (one
    send_batch), ("one", stream, row, ts) (one send), ("cols", stream,
    columns, ts), ("flush",) and ("hb", t) steps; returns
    (timestamp, data) events (and appends the runtime to `runtimes`)."""
    with _pending_capacity(pending or jdtypes.config
                           .pattern_pending_capacity):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            app, batch_size=batch_size)
    if runtimes is not None:
        runtimes.append(rt)
    got = []
    rt.add_callback(out, lambda evs: got.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    for op in script:
        if op[0] == "send":
            _, sid, rows, ts = op
            rt.get_input_handler(sid).send_batch(rows, timestamps=ts)
        elif op[0] == "one":
            _, sid, row, ts = op
            rt.get_input_handler(sid).send(row, timestamp=ts)
        elif op[0] == "cols":
            _, sid, cols, ts = op
            rt.get_input_handler(sid).send_columns(cols, timestamps=ts)
        elif op[0] == "flush":
            rt.flush()
        else:
            rt.heartbeat(op[1])
    return got


def _assert_same(want, got):
    assert len(got) == len(want)
    for (wt, wd), (gt, gd) in zip(want, got):
        assert gt == wt
        assert len(gd) == len(wd)
        for w, g in zip(wd, gd):
            if isinstance(w, float):
                np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0)
            else:
                assert type(g) is type(w) and g == w


def _parity(app, script, **kw):
    want = _run(siddhi_tpu, app, script, **kw)
    got = _run(siddhi_tpu_torch, app, script, device="cpu", **kw)
    _assert_same(want, got)
    return want


TWO = ("define stream S1 (symbol string, price float);\n"
       "define stream S2 (symbol string, price float);\n")
THREE = TWO + "define stream S3 (symbol string, price float);\n"
KV = "define stream S (k string, v int);\n"
F = ("flush",)
_clock = [1000]


def _s(sid, *rows, ts=None, flush=True):
    """Send rows 1 ms apart (from `ts`, else after the last send)."""
    t0 = _clock[0] if ts is None else ts
    _clock[0] = t0 + len(rows)
    op = ("send", sid, list(rows), [t0 + i for i in range(len(rows))])
    return [op, F] if flush else [op]


def _seq(*ops):
    _clock[0] = 1000
    out = []
    for o in ops:
        out += o() if callable(o) else o
    return out


# the shapes of tests/test_patterns.py this slice supports, as scripts
SHAPES = {
    # TestBasicPattern
    "two_stream": (
        TWO + "from e1=S1[price > 20.0] -> e2=S2[price > 30.0] "
        "select e1.symbol as s1, e2.symbol as s2 insert into OutStream;",
        lambda: _seq(_s("S1", ("IBM", 25.0)), _s("S2", ("WSO2", 35.0)))),
    "non_every_matches_once": (
        TWO + "from e1=S1[price > 20.0] -> e2=S2[price > 30.0] "
        "select e1.price as p1, e2.price as p2 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 25.0)), _s("S1", ("B", 26.0)),
                     _s("S2", ("C", 35.0)), _s("S2", ("D", 36.0)))),
    "every_rearms": (
        TWO + "from every e1=S1[price > 20.0] -> e2=S2[price > 30.0] "
        "select e1.price as p1, e2.price as p2 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 25.0)), _s("S1", ("B", 26.0)),
                     _s("S2", ("C", 35.0)), _s("S1", ("E", 27.0)),
                     _s("S2", ("F", 37.0)))),
    "condition_referencing_earlier_event": (
        TWO + "from every e1=S1 -> e2=S2[price > e1.price] "
        "select e1.price as p1, e2.price as p2 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 50.0)), _s("S2", ("B", 40.0)),
                     _s("S2", ("C", 60.0)))),
    "intra_batch_chain": (
        KV + "from every e1=S[v == 1] -> e2=S[v == 2] "
        "select e1.k as k1, e2.k as k2 insert into OutStream;",
        lambda: _seq(_s("S", ("a", 1), flush=False),
                     _s("S", ("b", 2)))),
    "three_stage": (
        KV + "from every e1=S[v == 1] -> e2=S[v == 2] -> e3=S[v == 3] "
        "select e1.k as k1, e2.k as k2, e3.k as k3 insert into OutStream;",
        lambda: _seq(*[_s("S", r) for r in
                       [("a", 1), ("x", 9), ("b", 2), ("c", 3)]])),
    # TestWithin (playback)
    "within_expires_partial": (
        "@app:playback\n" + TWO + "from every e1=S1 -> e2=S2 within 1 sec "
        "select e1.price as p1, e2.price as p2 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 1.0), ts=1000),
                     _s("S2", ("B", 2.0), ts=5000))),
    "within_allows_fast_match": (
        "@app:playback\n" + TWO + "from every e1=S1 -> e2=S2 within 10 sec "
        "select e1.price as p1, e2.price as p2 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 1.0), ts=1000),
                     _s("S2", ("B", 2.0), ts=5000))),
    # TestLogical
    "and_pattern": (
        THREE + "from e1=S1 -> e2=S2 and e3=S3 "
        "select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 1.0)), _s("S3", ("C", 3.0)),
                     _s("S2", ("B", 2.0)))),
    "or_pattern": (
        THREE + "from e1=S1 -> e2=S2 or e3=S3 "
        "select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 1.0)), _s("S3", ("C", 3.0)))),
    "or_is_null": (
        THREE + "from e1=S1 -> e2=S2 or e3=S3 "
        "select e1.symbol as s, e2.symbol as s2 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 1.0)), _s("S3", ("C", 3.0)))),
    # TestCount
    "exact_count": (
        KV + "from every e1=S[v > 0]<2> -> e2=S[v == 9] "
        "select e1[0].k as k0, e1[1].k as k1, e2.k as k2 "
        "insert into OutStream;",
        lambda: _seq(*[_s("S", r) for r in [("a", 1), ("b", 2), ("x", 9)]])),
    # TestSequence
    "strict_sequence_match": (
        KV + "from every e1=S[v == 1], e2=S[v == 2] "
        "select e1.k as k1, e2.k as k2 insert into OutStream;",
        lambda: _seq(_s("S", ("a", 1)), _s("S", ("b", 2)))),
    "strict_sequence_broken": (
        KV + "from every e1=S[v == 1], e2=S[v == 2] "
        "select e1.k as k1, e2.k as k2 insert into OutStream;",
        lambda: _seq(_s("S", ("a", 1)), _s("S", ("x", 7)),
                     _s("S", ("b", 2)))),
    # TestLogicalPatternWithFilters
    "and_leg_filters_on_arrivals": (
        THREE + "from e1=S1[price > 20.0] -> e2=S2[price > 30.0] "
        "and e3=S3[price > 40.0] "
        "select e1.symbol as s1, e2.symbol as s2, e3.symbol as s3 "
        "insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 25.0)), _s("S2", ("B", 35.0)),
                     _s("S3", ("C", 45.0)))),
    "and_filter_rejects": (
        THREE + "from e1=S1[price > 20.0] -> e2=S2[price > 30.0] "
        "and e3=S3[price > 40.0] "
        "select e1.symbol as s1 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 25.0)), _s("S2", ("B", 5.0)),
                     _s("S3", ("C", 45.0)))),
    # TestLogicalInBatchOrdering
    "and_opposite_order_single_batch": (
        THREE + "from e1=S1[price > 20.0] -> e2=S2[price > 30.0] "
        "and e3=S3[price > 40.0] "
        "select e2.symbol as s2, e3.symbol as s3 insert into OutStream;",
        lambda: _seq(_s("S1", ("A", 25.0), flush=False),
                     _s("S3", ("C", 45.0), flush=False),
                     _s("S2", ("B", 35.0)))),
    # single-stream logical sequences (the joint kill)
    "logical_sequence_either_order": (
        KV + "from every e1=S[v == 1], e2=S[v == 2] and e3=S[v == 3] "
        "select e1.k as k1, e2.k as k2, e3.k as k3 insert into OutStream;",
        lambda: _seq(*[_s("S", r, flush=False) for r in
                       [("a", 1), ("b", 2), ("c", 3), ("d", 1), ("e", 3),
                        ("f", 2), ("g", 1), ("x", 9), ("h", 2), ("i", 3)]],
                     [F])),
    "logical_sequence_or": (
        KV + "from every e1=S[v == 1], e2=S[v == 2] or e3=S[v == 3] "
        "select e1.k as k1, e2.k as k2, e3.k as k3 insert into OutStream;",
        lambda: _seq(*[_s("S", r) for r in
                       [("a", 1), ("c", 3), ("d", 1), ("x", 9), ("e", 2)]])),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pattern_shape_parity(name):
    app, script = SHAPES[name]
    want = _parity(app, script())
    if name not in ("within_expires_partial", "strict_sequence_broken",
                    "and_filter_rejects"):
        assert want


UNBOUNDED = {
    "cap_matches_up_to_bound": (
        KV + "from every e1=S[v > 0]<2:> -> e2=S[v == 0] "
        "select e1[0].k as k0, e1[last].k as kl, e2.k as k2 "
        "insert into OutStream;",
        [("S", (f"a{i}", 1)) for i in range(20)] + [("S", ("z", 0))]),
    "sequence_plus_matches": (
        KV + "from every e1=S[v > 0]+, e2=S[v == 0] "
        "select e1[0].k as k0, e1[last].k as kl, e2.k as k2 "
        "insert into OutStream;",
        [("S", r) for r in [("a", 1), ("b", 2), ("z", 0)]]),
    "sequence_star_allows_zero": (
        KV + "from every e1=S[v > 5]*, e2=S[v == 0] "
        "select e2.k as k2 insert into OutStream;",
        [("S", ("z", 0))]),
    "sequence_question_optional": (
        KV + "from every e1=S[v > 5]?, e2=S[v == 0] "
        "select e2.k as k2 insert into OutStream;",
        [("S", r) for r in [("z", 0), ("a", 9), ("y", 0)]]),
}


@pytest.mark.parametrize("name", sorted(UNBOUNDED))
def test_unbounded_count_parity_and_warning(name):
    app, sends = UNBOUNDED[name]
    script = _seq(*[_s(sid, row) for sid, row in sends])

    def run(pkg, **kw):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = _run(pkg, app, script, **kw)
        return out, [str(r.message) for r in rec
                     if "unbounded pattern count" in str(r.message)]

    want, jw = run(siddhi_tpu)
    got, tw = run(siddhi_tpu_torch, device="cpu")
    _assert_same(want, got)
    assert want
    assert bool(jw) == bool(tw) == ("?" not in app)
    if name == "cap_matches_up_to_bound":
        cap = 2 + tdtypes.config.pattern_unbounded_count_extra
        assert any(int(kl[1:]) - int(k0[1:]) >= cap - 2
                   for _, (k0, kl, _) in got)


RANDOM_APPS = {
    "count_range_epsilon": (
        "from every e1=S[v > 2] -> e2=S[v < e1.v]<1:3> -> e3=S[k == e1.k] "
        "within 50 milliseconds select e1.v as a, e2[0].v as b, "
        "e2[last].v as c, e3.v as d insert into OutStream;"),
    "sequence_optional": (
        "from every e1=S[v > 2], e2=S[v < e1.v]?, e3=S[k == e1.k] "
        "within 40 milliseconds select e1.v as a, e3.v as d "
        "insert into OutStream;"),
    "two_streams_and": (
        "from every e1=S -> e2=R[k == e1.k] and e3=S[v > e1.v] -> "
        "e4=R[v == e2.v] within 60 milliseconds "
        "select e1.v as a, e2.v as b, e3.v as c, e4.v as d "
        "insert into OutStream;"),
    "non_every_or": (
        "from e1=S[v > 5] -> e2=S[k == e1.k] or e3=S[v == 0] "
        "select e1.v as a, e2.v as b, e3.v as c insert into OutStream;"),
    "sequence_or": (
        "from every e1=S[v > 4], e2=S[v < 3] or e3=S[k == e1.k] "
        "select e1.v as a, e2.v as b, e3.v as c insert into OutStream;"),
    # a residual conjunct with a stream null check on a captured frame
    "null_check_after_or": (
        "from every e1=S -> e2=R[v > 2] or e3=S[v < 1] -> "
        "e4=R[e2 is null or v == e2.v] "
        "select e1.v as a, e2.v as b, e3.v as c, e4.v as d "
        "insert into OutStream;"),
}


@pytest.mark.parametrize("name", sorted(RANDOM_APPS))
def test_random_feeds_with_a_small_pending_table(name):
    # ragged batches, heartbeats and a 6-slot table that overflows
    app = ("@app:playback\ndefine stream S (k int, v int);\n"
           "define stream R (k int, v int);\n" + RANDOM_APPS[name])
    rng = np.random.default_rng(len(name))
    script, t = [], 1000
    for _ in range(10):
        for sid in ("S", "R"):
            n = int(rng.integers(1, 9))
            cols = {"k": rng.integers(0, 3, n).astype(np.int32),
                    "v": rng.integers(0, 8, n).astype(np.int32)}
            script += [("cols", sid, cols, t + 3 * np.arange(n)), F]
            t += 3 * n + int(rng.integers(0, 20))
        if rng.random() < 0.2:
            script.append(("hb", t + 30))
    assert _parity(app, script, pending=6)


def test_heartbeat_expires_within_entries():
    # the heartbeat at 5000 expires A (start 1000, within 1 sec); the late
    # B at 1200 would match it otherwise
    app = ("@app:playback\n" + TWO +
           "from every e1=S1 -> e2=S2 within 1 sec "
           "select e1.symbol as a, e2.symbol as b insert into OutStream;")
    first = [("send", "S1", [("A", 1.0)], [1000]), F]
    late = [("send", "S2", [("B", 2.0)], [1200]), F]
    assert _parity(app, first + late) != []
    assert _parity(app, first + [("hb", 5000)] + late) == []


def test_pending_overflow_drop_count_and_warning():
    app = ("define stream A (v int);\ndefine stream B (v int);\n"
           "@info(name='p')\nfrom every a=A -> b=B[b.v == a.v] "
           "select a.v as av, b.v as bv insert into Out;")
    script = ([("send", "A", [(i,) for i in range(64)], list(range(64))), F]
              + [op for i in range(63) for op in
                 (("send", "B", [(i,)], [100 + i]), F)])
    states = {}

    def run(pkg, **kw):
        with _pending_capacity(8):
            rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
                app, batch_size=64)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for op in script:
                if op[0] == "send":
                    rt.get_input_handler(op[1]).send_batch(
                        op[2], timestamps=op[3])
                else:
                    rt.flush()
            if pkg is siddhi_tpu:
                rt.heartbeat(1000)  # the JAX package warns from here
        states[pkg.__name__] = int(rt.query_runtimes["p"].state.dropped)
        return got, [str(r.message) for r in rec
                     if "pattern_pending_dropped" in str(r.message)]

    want, jw = run(siddhi_tpu)
    got, tw = run(siddhi_tpu_torch, device="cpu")
    _assert_same(want, got)
    assert states["siddhi_tpu"] == states["siddhi_tpu_torch"] == 56
    # the port reads its counter every 64 steps: after the 64th
    assert len(tw) == 1 and tw == jw


@pytest.mark.parametrize("app", ["H", "I"])
def test_config4_apps_match_jax_and_the_oracle(app):
    cs = _chip_smoke()
    rounds, batch, P = 4, 512, 2048
    data = cs.pattern_events(np.random.default_rng(3), app, rounds, batch)
    cs.check_no_tie(data, rounds, batch)
    script = []
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        for side in ("A", "B"):
            val, ts = data[side]
            script += [("cols", f"Stream{side}", {"val": val[s]}, ts[s]), F]
    want = _parity(cs.APP_H, script, batch_size=batch, pending=P)
    o_ts, o_a, o_b, dropped = cs.oracle_pattern(data, rounds, batch, P)
    assert dropped == 0
    assert [w[0] for w in want] == o_ts.tolist()
    assert [w[1] for w in want] == list(zip(o_a.tolist(), o_b.tolist()))
    if app == "H":
        assert len(want) == rounds * batch
    else:  # about 48% of the A entries find their value
        assert 0.35 * rounds * batch < len(want) < 0.6 * rounds * batch


def test_interop_continues_a_jax_pattern():
    app = ("@app:playback\ndefine stream A (k int, x float);\n"
           "define stream B (k int, x float);\n@info(name = 'q')\n"
           "from every a=A -> b=B[b.k == a.k and b.x > a.x] -> "
           "c=B[c.k == b.k] within 2 sec "
           "select a.x as ax, b.x as bx, c.x as cx insert into OutStream;")
    rng = np.random.default_rng(5)
    script, t = [], 1000
    for _ in range(8):
        for sid in ("A", "B"):
            cols = {"k": rng.integers(1, 6, 8).astype(np.int32),
                    "x": rng.uniform(0, 10, 8).astype(np.float32)}
            script += [("cols", sid, cols, t + 40 * np.arange(8)), F]
            t += 320
    head, tail = script[:8], script[8:]

    def feed(rt, ops):
        for op in ops:
            if op[0] == "cols":
                rt.get_input_handler(op[1]).send_columns(
                    op[2], timestamps=op[3])
            else:
                rt.flush()

    with _pending_capacity(16):
        jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
            app, batch_size=8)
        trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(app, batch_size=8)
    jout, tout = [], []
    jrt.add_callback("OutStream", lambda evs: jout.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    trt.add_callback("OutStream", lambda evs: tout.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    feed(jrt, head)
    jstate = jax.device_get(jrt.query_runtimes["q"].state)
    assert int(np.asarray(jstate.pending[0].valid).sum()) > 0
    n_head = len(jout)
    interop.load_app_state(trt, {"q": jstate},
                           list(jrt.ctx.global_strings._to_str))
    # the playback clock is app state outside the query
    trt.ctx.timestamp_generator.observe_event_time(
        jrt.ctx.timestamp_generator.current_time())
    feed(jrt, tail)
    feed(trt, tail)
    assert len(jout) > n_head
    _assert_same(jout[n_head:], tout)
