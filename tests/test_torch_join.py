"""Stream-stream joins of siddhi_tpu_torch against the JAX package on the
CPU: the join primitives (the plain versions of kernels K3b and K10, and
the sort-merge and cross probes) bit for bit, and whole join apps through
the public API.

Inputs are made with numpy from a seed and handed to both packages. u32
values compare as bits (the JAX package's uint32 against the port's int32
patterns). App events must be equal: ints, strings and timestamps exactly,
floats within rtol 1e-5 (tests/test_numeric_parity.py; only the join with
`sum` does arithmetic, the rest copy the stored float32 values).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.ops import groupby as jg
from siddhi_tpu.ops import join as jj
from siddhi_tpu.ops.expr_compile import Scope as JScope
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.ops import groupby as tg
from siddhi_tpu_torch.ops import join as tj
from siddhi_tpu_torch.ops.expr_compile import Scope as TScope

FLOAT_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bits(a):
    """A JAX array as numpy, uint32 viewed as the port's int32 patterns."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# ------------------------------------------------------------------ K3b


def _key_columns(rng, n):
    return {
        "int": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "long": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        "float": rng.normal(size=n).astype(np.float32) * 1e3,
        "double": rng.normal(size=n) * 1e6,
        "bool": rng.random(n) < 0.5,
        "code": rng.integers(0, 5000, n).astype(np.int32),
    }


@pytest.mark.parametrize("names", [
    ("int",), ("long",), ("float",), ("double",), ("bool",), ("code",),
    ("code", "long", "bool"), ("double", "float", "int", "long")])
def test_hash_columns32_bit_exact(names):
    rng = np.random.default_rng(len(names) * 7 + len(names[0]))
    cols = _key_columns(rng, 300)
    want = jg.hash_columns32([jnp.asarray(cols[k]) for k in names])
    got = tg.hash_columns32([_t(cols[k]) for k in names])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _bits(want))
    # the join's key hash: the BIGKEY remap, and the sentinel on invalid
    # build rows
    valid = rng.random(300) < 0.7
    jscope = JScope()
    jscope.add_frame("s", {k: jnp.asarray(v) for k, v in cols.items()},
                     jnp.zeros(300, jnp.int64), jnp.asarray(valid))
    tscope = TScope()
    tscope.add_frame("s", {k: _t(v) for k, v in cols.items()},
                     torch.zeros(300, dtype=torch.int64), _t(valid))
    jkeys = [lambda s, k=k: s.col("s", k) for k in names]
    want = jnp.where(jnp.asarray(valid), jj._hash_exprs(jkeys, jscope),
                     jj.BIGKEY)
    got = tj._hash_exprs(jkeys, tscope, valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), _bits(want))


def test_hash_exprs_moves_a_key_off_the_sentinel():
    # 0x96825014 is the int32 key whose one-column mix is 0xFFFFFFFF
    key = np.array([0x96825014 - 2**32, 7], dtype=np.int32)
    raw = jg.hash_columns32([jnp.asarray(key)])
    assert int(raw[0]) == 0xFFFFFFFF
    np.testing.assert_array_equal(tg.hash_columns32([_t(key)]).numpy(),
                                  _bits(raw))
    jscope, tscope = JScope(), TScope()
    jscope.add_frame("s", {"k": jnp.asarray(key)}, jnp.zeros(2, jnp.int64),
                     jnp.ones(2, bool))
    tscope.add_frame("s", {"k": _t(key)}, torch.zeros(2, dtype=torch.int64),
                     torch.ones(2, dtype=torch.bool))
    keys = [lambda s: s.col("s", "k")]
    want = _bits(jj._hash_exprs(keys, jscope))
    assert want[0] == -2  # 0xFFFFFFFE
    np.testing.assert_array_equal(tj._hash_exprs(keys, tscope).numpy(), want)


# ------------------------------------------------------------------ K10


def _mm_jax(mm):
    return [_bits(getattr(mm, f)) for f in jj.MultimapState._fields]


def _mm_port(mm):
    return [getattr(mm, f).numpy() for f in tj.MultimapState._fields]


def _assert_mm_equal(tmm, jmm):
    for f, a, b in zip(tj.MultimapState._fields, _mm_port(tmm), _mm_jax(jmm)):
        np.testing.assert_array_equal(a, b, err_msg=f)


def _append_sequence(C, H, B, n_batches, n_keys, p_live, start, seed):
    """The same batches appended to a JAX and a port multimap; returns
    both states and the overall index after the last batch."""
    rng = np.random.default_rng(seed)
    jmm = jj.multimap_init(C, H)
    tmm = tj.multimap_init(C, H, torch.device("cpu"))
    appended = start
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, B).astype(np.int32)
        hashes = np.asarray(jg.hash_columns32([jnp.asarray(keys)]))
        live = rng.random(B) < p_live
        jmm = jj.multimap_append(jmm, jnp.asarray(hashes), jnp.asarray(live),
                                 jnp.int64(appended))
        tmm = tj.multimap_append(tmm, _t(hashes.view(np.int32)), _t(live),
                                 torch.tensor(appended))
        _assert_mm_equal(tmm, jmm)
        appended += int(live.sum())
    return jmm, tmm, appended


@pytest.mark.parametrize("C,H,B,n_batches,n_keys,p_live,start", [
    (64, 128, 16, 12, 40, 0.7, 0),  # dead lanes, the ring wraps thrice
    (40, 4, 16, 6, 1000, 0.9, 5),  # 4 buckets: every chain shared
    (32, 64, 32, 5, 8, 1.0, 2**32 - 70),  # full batches, tags wrap 2^32
    (48, 128, 48, 4, 1, 0.9, 7),  # every live lane one key, B = C
])
def test_multimap_append_state_bit_exact(C, H, B, n_batches, n_keys, p_live,
                                         start):
    _append_sequence(C, H, B, n_batches, n_keys, p_live, start, seed=C + H)


@pytest.mark.parametrize("C,H,B,n_batches,n_keys,start,k_max", [
    (64, 128, 16, 12, 20, 0, 4),  # stale chains through overwritten slots
    (48, 8, 16, 3, 3, 0, 4),  # chains longer than k_max: truncation
    (64, 128, 16, 9, 12, 2**32 - 100, 8),  # appended crosses 2^32
])
def test_multimap_probe_bit_exact(C, H, B, n_batches, n_keys, start, k_max):
    jmm, tmm, appended = _append_sequence(C, H, B, n_batches, n_keys, 0.8,
                                          start, seed=C * 3 + n_keys)
    rng = np.random.default_rng(k_max)
    keys = rng.integers(0, n_keys + 2, 24).astype(np.int32)
    hashes = np.asarray(jg.hash_columns32([jnp.asarray(keys)]))
    valid = rng.random(24) < 0.85
    truncs = []
    for window_len in (C, C // 2, 3):
        jpos, jok, jtr = jj.multimap_probe(
            jmm, jnp.asarray(hashes), jnp.asarray(valid),
            jnp.int64(appended), jnp.int64(window_len), k_max)
        tpos, tok, ttr = tj.multimap_probe(
            tmm, _t(hashes.view(np.int32)), _t(valid),
            torch.tensor(appended), torch.tensor(window_len), k_max)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert int(ttr) == int(jtr)
        truncs.append(int(ttr))
    if n_keys == 3:
        assert truncs[0] > 0


def _jax_probe_compact(mm, hashes, valid, appended, window_len, k_max,
                       pair_cap):
    """The JAX join's multimap path where it compacts: multimap_probe, the
    pairs past pair_cap counted, compact_pairs of the [B * k_max] block."""
    pos, ok, truncated = jj.multimap_probe(mm, hashes, valid, appended,
                                           window_len, k_max)
    B = hashes.shape[0]
    lane = jnp.broadcast_to(jnp.arange(B)[:, None], (B, k_max)).reshape(-1)
    pv = ok.reshape(-1)
    over = jnp.maximum(jnp.sum(pv, dtype=jnp.int32) - pair_cap, 0)
    return (*jj.compact_pairs(lane, pos.reshape(-1), pv, pair_cap), over,
            truncated)


_jax_probe_compact_jit = jax.jit(_jax_probe_compact, static_argnums=(5, 6))


@pytest.mark.parametrize("C,H,n_keys,start,k_max,pair_cap,p_valid", [
    (128, 256, 40, 2**32 - 200, 4, 48, 0.9),  # tags wrap 2^32; overflow
    (96, 64, 2, 0, 4, 200, 0.9),  # a hot key walks past k_max
    (64, 128, 12, 5, 4, 100, 0.0),  # every lane invalid
    (256, 512, 8, 2**32 - 300, 1, 16, 1.0),  # k_max = 1, overflow
])
def test_multimap_probe_compact_plain_matches_jax(C, H, n_keys, start, k_max,
                                                  pair_cap, p_valid):
    """The fused probe's plain version (multimap_probe_plain, then
    compact_pairs_plain) against the JAX functions, exact: lanes, rows,
    pv, the pairs past pair_cap and the truncated lanes."""
    B = 64
    jmm, tmm, appended = _append_sequence(C, H, B, 6, n_keys, 0.85, start,
                                          seed=C + k_max)
    rng = np.random.default_rng(pair_cap)
    keys = rng.integers(0, n_keys + 2, B).astype(np.int32)
    hashes = np.asarray(jg.hash_columns32([jnp.asarray(keys)]))
    valid = rng.random(B) < p_valid
    got_over = []
    for window_len in (C, C // 3):
        want = _jax_probe_compact_jit(
            jmm, jnp.asarray(hashes), jnp.asarray(valid),
            jnp.int64(appended), jnp.int64(window_len), k_max, pair_cap)
        got = tj.multimap_probe_compact(
            tmm, _t(hashes.view(np.int32)), _t(valid),
            torch.tensor(appended), torch.tensor(window_len), k_max,
            pair_cap)
        for name, a, b in zip(("lane", "row", "pv", "over", "truncated"),
                              got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        got_over.append((int(got[3]), int(got[4])))
    if p_valid == 0.0:
        assert got_over == [(0, 0), (0, 0)]
    elif n_keys == 2:
        assert got_over[0][1] > 0  # truncated walks
    else:
        assert got_over[0][0] > 0  # pairs past pair_cap


@pytest.mark.parametrize("P,cap,p_valid", [(64, 32, 0.3), (64, 32, 0.9),
                                           (48, 48, 0.5), (100, 8, 0.0)])
def test_compact_pairs_bit_exact(P, cap, p_valid):
    rng = np.random.default_rng(P + cap)
    lane = np.repeat(np.arange(P // 4, dtype=np.int32), 4)[:P]
    row = rng.integers(0, 1000, P).astype(np.int32)
    pv = rng.random(P) < p_valid
    jl, jr, jv = jj.compact_pairs(jnp.asarray(lane), jnp.asarray(row),
                                  jnp.asarray(pv), cap)
    tl, tr, tv = tj.compact_pairs(_t(lane), _t(row), _t(pv), cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _plans():
    key = [lambda s: s.col("p", "k")]
    bkey = [lambda s: s.col("b", "k")]
    return (jj.JoinPlan(key, bkey, None), tj.JoinPlan(key, bkey, None))


@pytest.mark.parametrize("C,p_build", [(40, 0.8), (1, 0.0), (64, 1.0)])
def test_probe_equi_bit_exact(C, p_build):
    rng = np.random.default_rng(C)
    B, k_max = 24, 4
    pool = rng.integers(-(2**31), 2**31, 14).astype(np.int32)
    bk = pool[rng.integers(0, 12, C)]
    pk = pool[rng.integers(0, 14, B)]
    # hashes above 2^31 must sort after those below, as u32
    h = np.asarray(jg.hash_columns32([jnp.asarray(bk)]))
    assert C < 10 or ((h >= 2**31).any() and (h < 2**31).any())
    bvalid = rng.random(C) < p_build
    pvalid = rng.random(B) < 0.9
    bts = np.arange(C, dtype=np.int64)
    jplan, tplan = _plans()
    js, ts_ = JScope(), TScope()
    js.add_frame("p", {"k": jnp.asarray(pk)}, jnp.zeros(B, jnp.int64),
                 jnp.asarray(pvalid), default=True)
    ts_.add_frame("p", {"k": _t(pk)}, torch.zeros(B, dtype=torch.int64),
                  _t(pvalid), default=True)
    want = jj.probe_equi(jplan, js, jnp.asarray(pvalid),
                         {"k": jnp.asarray(bk)}, jnp.asarray(bts),
                         jnp.asarray(bvalid), "b", k_max)
    got = tj.probe_equi(tplan, ts_, _t(pvalid), {"k": _t(bk)}, _t(bts),
                        _t(bvalid), "b", k_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("C,p_build", [(10, 0.5), (3, 1.0), (20, 0.0)])
def test_probe_cross_matches_jax(C, p_build):
    rng = np.random.default_rng(C)
    bvalid = rng.random(C) < p_build
    pvalid = rng.random(6) < 0.7
    want = jj.probe_cross(jnp.asarray(pvalid), jnp.asarray(bvalid), 5)
    got = tj.probe_cross(_t(pvalid), _t(bvalid), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ apps


def _run(pkg, app, script, batch_size=8, out="OutStream", **kw):
    """Drive an app with a script of ("send", stream, rows, ts),
    ("flush",) and ("hb", t) steps; returns (timestamp, data) events."""
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        app, batch_size=batch_size)
    got = []
    rt.add_callback(out, lambda evs: got.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    for op in script:
        if op[0] == "send":
            _, sid, rows, ts = op
            rt.get_input_handler(sid).send_batch(rows, timestamps=ts)
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


TICK = ("define stream TickStream (symbol string, price float);\n"
        "define stream NewsStream (symbol string, headline string);\n"
        "from TickStream#window.length(10) join NewsStream#window.length(10) "
        "on TickStream.symbol == NewsStream.symbol "
        "select TickStream.symbol as symbol, price, headline "
        "insert into OutStream;")
AB = ("define stream A (symbol string, x int);\n"
      "define stream B (symbol string, y int);\n")


def _s(sid, *rows, ts=1000):
    return ("send", sid, list(rows), [ts + i for i in range(len(rows))])


F = ("flush",)

# the shapes of tests/test_joins.py this slice supports, as scripts
SHAPES = {
    "inner": (TICK, [_s("TickStream", ("IBM", 75.0)), F,
                     _s("NewsStream", ("IBM", "up"), ts=2000), F]),
    "no_match": (TICK, [_s("TickStream", ("IBM", 75.0)), F,
                        _s("NewsStream", ("WSO2", "down"), ts=2000), F]),
    "both_directions": (TICK, [
        _s("NewsStream", ("IBM", "up")), F,
        _s("TickStream", ("IBM", 10.0), ts=2000), F,
        _s("NewsStream", ("IBM", "down"), ts=3000), F]),
    "multiple_matches": (TICK, [
        _s("NewsStream", ("IBM", "a"), ("IBM", "b"), ("ORCL", "c")), F,
        _s("TickStream", ("IBM", 5.0), ("ORCL", 6.0), ts=2000), F]),
    "window_expiry": (
        AB + "from A#window.length(1) join B#window.length(10) "
        "on A.symbol == B.symbol "
        "select A.symbol as symbol, x, y insert into OutStream;",
        [_s("A", ("IBM", 1)), F, _s("A", ("IBM", 2), ts=1100), F,
         _s("B", ("IBM", 9), ts=1200), F]),
    "left_outer": (
        AB + "from A#window.length(5) left outer join B#window.length(5) "
        "on A.symbol == B.symbol "
        "select A.symbol as symbol, x, y insert into OutStream;",
        [_s("A", ("IBM", 1)), F, _s("B", ("IBM", 4), ts=1100), F,
         _s("A", ("IBM", 2), ("WSO2", 3), ts=1200), F]),
    "unidirectional": (
        AB + "from A#window.length(5) unidirectional join B#window.length(5) "
        "on A.symbol == B.symbol "
        "select A.symbol as symbol, x, y insert into OutStream;",
        [_s("B", ("IBM", 7)), F, _s("A", ("IBM", 1), ts=1100), F,
         _s("B", ("IBM", 8), ts=1200), F, _s("A", ("IBM", 2), ts=1300), F]),
    "non_equi_cross": (
        "define stream A (x int);\ndefine stream B (y int);\n"
        "from A#window.length(5) join B#window.length(5) on A.x < B.y "
        "select x, y insert into OutStream;",
        [_s("B", (5,), (1,), (9,)), F, _s("A", (3,), (7,), ts=1100), F,
         _s("B", (4,), ts=1200), F]),
    "sum_group_by": (
        AB + "from A#window.length(10) join B#window.length(10) "
        "on A.symbol == B.symbol "
        "select A.symbol as symbol, sum(y) as total group by symbol "
        "insert into OutStream;",
        [_s("B", ("IBM", 10), ("IBM", 20), ("X", 5)), F,
         _s("A", ("IBM", 1), ("X", 2), ts=1100), F,
         _s("B", ("IBM", 30), ts=1200), F]),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_join_shape_parity(name):
    app, script = SHAPES[name]
    want = _parity(app, script)
    if name not in ("no_match",):
        assert want


def test_all_pairs_survive_small_batches():
    app = ("define stream L (k int, v int);\n"
           "define stream R (k int, v int);\n"
           "from L#window.length(16) join R#window.length(16) "
           "on L.k == R.k "
           "select L.v as lv, R.v as rv insert into OutStream;")
    script = ([_s("R", *[(7, i) for i in range(10)]), F]
              + [_s("L", *[(7, 100 + j) for j in range(4)], ts=2000), F])
    want = _parity(app, script, batch_size=4)
    assert len(want) == 40


def _kv_feed(seed, rounds, n, n_keys, streams=("L", "R"), t0=1000, dt=1):
    rng = np.random.default_rng(seed)
    script, t = [], t0
    for _ in range(rounds):
        for sid in streams:
            cols = {"k": rng.integers(1, n_keys + 1, n).astype(np.int32),
                    "v": rng.uniform(1.0, 100.0, n)}
            script += [("cols", sid, cols, t + dt * np.arange(n)), F]
            t += dt * n
    return script


KV = ("define stream L (k int, v double);\n"
      "define stream R (k int, v double);\n")
CONFIG5 = (KV + "@info(name = 'bench')\n"
           "from L#window.length({n}) as a join R#window.length({n}) as b\n"
           "on a.k == b.k\nselect a.k as k, a.v as lv, b.v as rv\n"
           "insert into OutStream;")


@pytest.mark.parametrize("kind", ["right outer", "full outer"])
def test_outer_join_parity(kind):
    app = (KV + f"from L#window.length(12) as a {kind} join "
           "R#window.length(12) as b on a.k == b.k "
           "select a.k as ak, b.k as bk, a.v as lv, b.v as rv "
           "insert into OutStream;")
    want = _parity(app, _kv_feed(5, 4, 8, 10))
    # unmatched right arrivals with a null left; full outer also the reverse
    assert any(e[1][0] == 0 for e in want)
    assert any(e[1][1] == 0 for e in want) == (kind == "full outer")


def test_config5_shape_parity_with_wrapping_rings():
    # BASELINE config 5 at length(40): every ring wraps several times
    want = _parity(CONFIG5.format(n=40), _kv_feed(1, 10, 16, 30),
                   batch_size=16)
    assert len(want) > 100


def test_time_build_window_expires_at_probe_time():
    # A's time window holds rows its own side never flushes out: they leave
    # at probe time; the heartbeat steps both windows in the port only
    app = ("@app:playback\n" + KV +
           "from L#window.time(100) as a join R#window.length(20) as b "
           "on a.k == b.k select a.k as k, a.v as lv, b.v as rv "
           "insert into OutStream;")
    script = _kv_feed(2, 1, 8, 4, streams=("L",), t0=1000, dt=10)
    script += _kv_feed(3, 3, 8, 4, streams=("R",), t0=1050, dt=5)
    script += [("hb", 1400)]
    script += _kv_feed(4, 1, 8, 4, streams=("R",), t0=1500, dt=5)
    want = _parity(app, script)
    assert want


@pytest.mark.parametrize("left", ["L#window.lengthBatch(5)", "L",
                                  "L[v > 30.0]#window.length(10)"],
                         ids=["lengthBatch", "no_window", "filter"])
def test_side_kinds_parity(left):
    app = (KV + f"from {left} as a join R#window.length(10) as b "
           "on a.k == b.k select a.k as k, a.v as lv, b.v as rv "
           "insert into OutStream;")
    want = _parity(app, _kv_feed(6, 4, 6, 5))
    assert want


def test_within_parity():
    app = ("@app:playback\n" + KV +
           "from L#window.length(10) as a join R#window.length(10) as b "
           "on a.k == b.k within 1 sec "
           "select a.k as k, a.v as lv, b.v as rv insert into OutStream;")
    script = _kv_feed(7, 4, 6, 4, dt=150)
    want = _parity(app, script)
    assert want
    # some pairs in the windows are more than 1 sec apart
    without = _run(siddhi_tpu_torch, app.replace("within 1 sec ", ""),
                   script, device="cpu")
    assert len(without) > len(want)


def test_self_join_with_aliases():
    app = ("define stream S (k int, v double);\n"
           "from S#window.length(8) as a join S#window.length(8) as b "
           "on a.k == b.k and a.v < b.v "
           "select a.v as av, b.v as bv insert into OutStream;")
    want = _parity(app, _kv_feed(8, 4, 6, 3, streams=("S",)))
    assert want


def test_string_keys():
    rng = np.random.default_rng(9)
    pool = np.array(["IBM", "WSO2", "ORCL", "MSFT", "GOOG"], dtype=object)
    script, t = [], 1000
    for _ in range(4):
        for sid in ("TickStream", "NewsStream"):
            sym = pool[rng.integers(0, 5, 6)]
            other = (rng.uniform(1, 100, 6).astype(np.float32)
                     if sid == "TickStream"
                     else np.array([f"h{i}" for i in rng.integers(0, 9, 6)],
                                   dtype=object))
            name = "price" if sid == "TickStream" else "headline"
            script += [("cols", sid, {"symbol": sym, name: other},
                        t + np.arange(6)), F]
            t += 6
    want = _parity(TICK, script)
    assert want


def test_pair_compaction_inside_the_step():
    # B = 4096: the candidate block (65536) exceeds the pair block (32768)
    want = _parity(CONFIG5.format(n=4096), _kv_feed(10, 2, 4096, 1500),
                   batch_size=4096)
    assert len(want) > 4096


def test_k_max_overflow_warns_in_both_packages():
    app = CONFIG5.format(n=32)
    script = _kv_feed(11, 32, 2, 1)  # one key: 32 rows match each probe

    def run(pkg, **kw):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = _run(pkg, app, script, batch_size=4, **kw)
        msgs = [str(x.message) for x in w if "were dropped" in str(x.message)]
        return out, msgs

    want, jmsg = run(siddhi_tpu)
    got, tmsg = run(siddhi_tpu_torch, device="cpu")
    _assert_same(want, got)
    assert len(jmsg) == 1 and tmsg == jmsg


def test_interop_continues_a_jax_join():
    app = CONFIG5.format(n=24)
    script = _kv_feed(12, 6, 8, 12)
    head, tail = script[:6], script[6:]
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        app, batch_size=8)
    jout = []
    jrt.add_callback("OutStream", lambda evs: jout.extend(
        (e.timestamp, tuple(e.data)) for e in evs))

    def feed(rt, ops):
        for op in ops:
            if op[0] == "cols":
                rt.get_input_handler(op[1]).send_columns(op[2],
                                                         timestamps=op[3])
            else:
                rt.flush()

    feed(jrt, head)
    jstate = jax.device_get(jrt.query_runtimes["bench"].state)
    n_head = len(jout)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app, batch_size=8)
    interop.load_app_state(trt, {"bench": jstate},
                           list(jrt.ctx.global_strings._to_str))
    tout = []
    trt.add_callback("OutStream", lambda evs: tout.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    feed(jrt, tail)
    feed(trt, tail)
    assert len(jout) > n_head
    _assert_same(jout[n_head:], tout)


@pytest.mark.parametrize("defs,tail", [
    ("define table T (k int, w double);\nfrom R select k, v as w "
     "insert into T;", ""),
    ("define window T (k int, w double) length(5);\nfrom R select k, "
     "v as w insert into T;", ""),
    ("define aggregation T from R select k, sum(v) as w group by k "
     "aggregate every sec, min;", " per 'sec'"),
], ids=["table", "named_window", "aggregation"])
def test_unported_sides_are_refused(defs, tail):
    """Table, named-window and aggregation sides run, with the JAX
    package's output (the sides once refused here)."""
    app = KV + defs + ("\n@info(name='j') from L#window.length(5) as a "
                       f"join T as b on a.k == b.k{tail} select a.k as k, "
                       "b.w as w insert into OutStream;")
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
              else pkg.SiddhiManager()).create_siddhi_app_runtime(
                  "@app:playback\n" + app, batch_size=8)
        got = []
        rt.add_query_callback("j", lambda ts, i, r, got=got: got.extend(
            (e.timestamp, tuple(e.data)) for e in i or []))
        for k in range(4):
            rt.get_input_handler("R").send((k % 3, float(k)), timestamp=k)
        rt.flush()
        for k in range(5):
            rt.get_input_handler("L").send((k, 0.5), timestamp=10 + k)
        rt.flush()
        outs.append(got)
    assert outs[0]
    _assert_same(outs[0], outs[1])
