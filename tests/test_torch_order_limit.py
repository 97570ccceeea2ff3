"""ORDER BY / LIMIT / OFFSET of siddhi_tpu_torch against the JAX package on
the CPU, through both public APIs: one and two keys, ASC and DESC, over
INT, LONG (beyond 2^53, where both cast to float64 first), DOUBLE with NaN
and +-0.0, BOOL and STRING, ties kept in arrival order, OFFSET alone,
LIMIT alone and both, with GROUP BY and HAVING, over a window and on a
join; plus the K7 keys of `_order_chunk` against the JAX float64 argsort.

Inputs are made with numpy from a seed and handed to both packages.
Events, their order, strings, longs, bools and timestamps must be equal;
floats within rtol 1e-5 (float32 accumulation order,
tests/test_numeric_parity.py) plus atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-3

S = ("@app:playback\ndefine stream S (symbol string, price double, "
     "volume long, k int, flag bool);\n@info(name='q') ")


def _run(pkg, app, rows, batch_size=8, flush_every=None):
    """(symbol, price, volume, k, flag) rows 1 ms apart; a flush after
    every `flush_every` rows and at the end. Returns the query callback's
    (ts, in events, remove events) emissions."""
    rt = pkg.SiddhiManager(
        **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
        .create_siddhi_app_runtime(app, batch_size=batch_size)
    got = []
    rt.add_query_callback("q", lambda ts, i, r: got.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
         [(e.timestamp, tuple(e.data)) for e in r or []])))
    h = rt.get_input_handler("S")
    for n, row in enumerate(rows):
        h.send(row, timestamp=1_000 + n)
        if flush_every and (n + 1) % flush_every == 0:
            rt.flush()
    rt.flush()
    return got


def _same(want, got):
    assert len(got) == len(want)
    for (wt, wi, wr), (gt, gi, gr) in zip(want, got):
        assert gt == wt
        for w_rows, g_rows in ((wi, gi), (wr, gr)):
            assert len(g_rows) == len(w_rows)
            for (wts, wd), (gts, gd) in zip(w_rows, g_rows):
                assert gts == wts
                for w, g in zip(wd, gd):
                    if isinstance(w, float):
                        np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                                   atol=FLOAT_ATOL)
                    else:
                        assert type(g) is type(w) and g == w


def _rows(seed, n=24, n_syms=5):
    """Rows with ties in every column, NaN and +-0.0 prices, and volumes
    beyond 2^53 that collapse to one float64."""
    rng = np.random.default_rng(seed)
    prices = rng.choice([1.5, -2.0, 0.0, -0.0, float("nan"), 7.25, 1.5], n)
    vols = rng.choice([2**60, 2**60 + 1, 2**60 + 3, -5, 12, 2**53 + 1], n)
    return [(f"s{int(rng.integers(0, n_syms))}", float(prices[i]),
             int(vols[i]), int(rng.integers(-3, 4)), bool(rng.random() < .5))
            for i in range(n)]


def _parity(app, rows, emits=True, **kw):
    want = _run(siddhi_tpu, S + app, rows, **kw)
    assert any(i for _, i, _ in want) == emits
    _same(want, _run(siddhi_tpu_torch, S + app, rows, **kw))
    return want


SEL = "select symbol, price, volume, k, flag "
KEYS = {
    "int_asc": "k", "int_desc": "k desc", "long_asc": "volume",
    "long_desc": "volume desc", "double_asc": "price",
    "double_desc": "price desc", "bool_asc": "flag", "bool_desc": "flag desc",
    "string_asc": "symbol", "string_desc": "symbol desc",
    "two_keys": "k desc, price", "two_keys_mixed": "flag, volume desc",
}


@pytest.mark.parametrize("name", list(KEYS))
def test_order_by_over_a_window_matches_jax(name):
    """A lengthBatch(6) chunk at a time, in batches of 8."""
    _parity(f"from S#window.lengthBatch(6) {SEL}order by {KEYS[name]} "
            "insert into Out;", _rows(len(name)))


@pytest.mark.parametrize("clause", ["limit 3", "offset 2", "limit 2 offset 3",
                                    "order by price desc limit 2 offset 1",
                                    "offset 9"],
                         ids=["limit", "offset", "both", "order_both",
                              "offset_past_chunk"])
def test_limit_and_offset_match_jax(clause):
    """Per batch of 8 without a window (the chunk is the batch); an offset
    past the chunk emits nothing in either package."""
    _parity(f"from S {SEL}{clause} insert into Out;", _rows(3),
            emits=clause != "offset 9", flush_every=8)


def test_ties_keep_their_arrival_order():
    """Equal keys (one k value, one symbol) come out in arrival order in
    both packages."""
    rows = [("a", float(i), i, 1, True) for i in range(12)]
    want = _parity("from S#window.lengthBatch(6) select symbol, volume, k "
                   "order by k, symbol insert into Out;", rows)
    assert [d[1] for _, i, _ in want for _, d in i] == list(range(12))


def test_order_by_with_group_by_and_having_matches_jax():
    _parity("from S#window.lengthBatch(12) select symbol, sum(volume) as v, "
            "count() as n group by symbol having n > 1 order by n desc, "
            "symbol limit 3 insert all events into Out;",
            [(r[0], r[1], int(r[3]) + 10, r[3], r[4]) for r in _rows(7, 36)],
            batch_size=16)


def test_order_by_a_sliding_window_with_expired_events_matches_jax():
    _parity("from S#window.length(5) select symbol, k, price order by k "
            "desc, price limit 4 insert all events into Out;", _rows(11),
            flush_every=6)


def test_string_order_by_is_by_intern_code_as_in_jax():
    """Reference fault (siddhi_tpu/ops/selector.py:535-546, the key is the
    int32 code column): a STRING key orders by first-seen intern code, not
    by the string. zz, aa, mm, bb, aa, cc give zz, aa, aa, mm; Java would
    give aa, aa, bb, cc. No row is lost, so the port keeps the order."""
    rows = [("zz", 1.0, 1, 0, True), ("aa", 2.0, 2, 0, True),
            ("mm", float("nan"), 3, 0, True), ("bb", 4.0, 4, 0, True),
            ("aa", -0.0, 5, 0, True), ("cc", 6.0, 6, 0, True)]
    want = _parity("from S#window.lengthBatch(6) select symbol, price, volume "
                   "order by symbol limit 4 insert into Out;", rows)
    assert [d[0] for _, i, _ in want for _, d in i] == ["zz", "aa", "aa",
                                                        "mm"]


def test_order_by_on_a_join_matches_jax():
    app = ("@app:playback\ndefine stream L (symbol string, k int);\n"
           "define stream R (price double, k int);\n@info(name='q') "
           "from L#window.length(4) join R#window.length(4) on L.k == R.k "
           "select L.symbol as s, R.price as p, R.k as k order by p desc, s "
           "limit 3 insert into Out;")

    def run(pkg):
        rt = pkg.SiddhiManager(
            **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
            .create_siddhi_app_runtime(app, batch_size=4)
        got = []
        rt.add_query_callback("q", lambda ts, i, r: got.append(
            (ts, [(e.timestamp, tuple(e.data)) for e in i or []], [])))
        rng = np.random.default_rng(5)
        for n in range(16):
            side = "L" if rng.random() < 0.5 else "R"
            row = ((f"s{int(rng.integers(0, 4))}", int(rng.integers(0, 3)))
                   if side == "L" else
                   (float(rng.integers(0, 9)) * 0.5, int(rng.integers(0, 3))))
            rt.get_input_handler(side).send(row, timestamp=1_000 + n)
            rt.flush()
        return got

    want = run(siddhi_tpu)
    assert sum(len(i) for _, i, _ in want) > 4
    _same(want, run(siddhi_tpu_torch))


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "bool"])
def test_order_keys_sort_as_the_jax_float64_argsort(dtype):
    """The keys of `_order_chunk` (K7 on float64_sort_key; float32
    subnormals flushed to zero as XLA's cast does) against
    `jnp.argsort(stable=True)` of where(valid, col.astype(float64), +inf),
    negated before the cast for DESC, through the selector itself."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops.selector import CompiledSelector
    from siddhi_tpu_torch.query_api.execution import OrderByOrder
    rng = np.random.default_rng(3)
    n = 257
    if dtype == "bool":
        col = rng.random(n) < 0.5
    elif dtype == "float32":
        col = rng.choice([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-40,
                          -1e-40, 2.5, -2.5], n).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        col = rng.integers(info.min // 2, info.max // 2, n).astype(dtype)
        col[:8] = info.min
    valid = rng.random(n) < 0.85
    for order in (OrderByOrder.ASC, OrderByOrder.DESC):
        jc = jnp.asarray(col)
        if order == OrderByOrder.DESC:
            jc = ~jc if dtype == "bool" else -jc
        jk = jnp.where(jnp.asarray(valid), jc.astype(jnp.float64), jnp.inf)
        perm = np.asarray(jnp.argsort(jk, stable=True))
        want = perm[np.argsort(~valid[perm], kind="stable")]
        sel = CompiledSelector.__new__(CompiledSelector)
        sel.order_by = [((None, "x", None), order)]
        out = EventBatch(ts=torch.arange(n), cols={"x": torch.from_numpy(col)},
                         valid=torch.from_numpy(valid),
                         types=torch.zeros(n, dtype=torch.int8))
        got = sel._order_chunk(out).ts.numpy()
        np.testing.assert_array_equal(got, want)


def test_order_by_on_a_pattern_matches_jax():
    """A pattern's selector orders and limits each step's matches too."""
    app = ("@app:playback\ndefine stream A (symbol string, k int);\n"
           "define stream B (price double, k int);\n@info(name='q') "
           "from every a=A -> b=B[b.k == a.k] select a.symbol as s, "
           "b.price as p order by p desc limit 2 insert into Out;")

    def run(pkg):
        rt = pkg.SiddhiManager(
            **({"device": "cpu"} if pkg is siddhi_tpu_torch else {})) \
            .create_siddhi_app_runtime(app, batch_size=8)
        got = []
        rt.add_query_callback("q", lambda ts, i, r: got.append(
            (ts, [(e.timestamp, tuple(e.data)) for e in i or []], [])))
        rng = np.random.default_rng(17)
        for n in range(6):
            for j in range(4):
                rt.get_input_handler("A").send(
                    (f"s{int(rng.integers(0, 5))}", int(rng.integers(0, 2))),
                    timestamp=1_000 + 10 * n + j)
            rt.flush()
            for j in range(4):
                rt.get_input_handler("B").send(
                    (float(rng.integers(0, 9)) * 0.5,
                     int(rng.integers(0, 2))), timestamp=1_005 + 10 * n + j)
            rt.flush()
        return got

    want = run(siddhi_tpu)
    assert sum(len(i) for _, i, _ in want) > 4
    assert max(len(i) for _, i, _ in want) == 2
    _same(want, run(siddhi_tpu_torch))
