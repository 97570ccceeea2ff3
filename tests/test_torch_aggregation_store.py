"""The aggregation's store paths of siddhi_tpu_torch against the JAX
package on the CPU: K13f's plain version against the JAX `.at[]`
scatters (add, min, max, set; NaN, ±inf, -0.0, dropped lanes, int64
wrap), the port's evict and restore steps against the JAX `_evict` and
`_restore_fn` on one carried state (key table included), every shape of
tests/test_aggregation_durable.py but the sharded class (a mesh is not
yet ported), a capacity-truncated rebuild and its merge at flush, the
record-store half of io/record_table.py (its condition visitors, the
in-memory store, `set_extension`), the annotation time literals of
`@purge`, the overflow sweep over the aggregation stores, and the
refusals (mesh, two aggregations, a join without `per`, insert-into from
an aggregation, `@store` without a registered type, `@store` on a table).

Integer sums, min/max, set columns, key tables, store rows and error texts
must be equal; float32 sums within 1e-5 of the slot's sum of magnitudes.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.partition import _parse_annotation_time
from siddhi_tpu.io import record_table as jrec
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core.context import parse_annotation_time
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.extension.registry import ExtensionKind
from siddhi_tpu_torch.io import record_table as trec
from siddhi_tpu_torch.ops import bucket_scatter as bs

# --------------------------------------------------------------------------- #
# K13f plain against the JAX scatters
# --------------------------------------------------------------------------- #

SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 3e38],
                    np.float32)


def _lanes(rng, n, K, drop=0.1):
    w = rng.integers(0, K, n).astype(np.int32)
    w[rng.random(n) < drop] = K  # the drop slot
    return w


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        nan = np.isnan(a) & np.isnan(b)
        ok = nan | ((a == b) & (np.signbit(a) == np.signbit(b)))
        assert ok.all(), (a[~ok], b[~ok])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64])
def test_k13f_extrema_match_jax(op, dtype):
    rng = np.random.default_rng(3)
    K, n = 37, 700
    w = _lanes(rng, n, K)
    if np.dtype(dtype).kind == "f":
        v = np.where(rng.random(n) < 0.5, rng.choice(SPECIALS, n),
                     rng.normal(0, 5, n)).astype(dtype)
        ident = np.inf if op == "min" else -np.inf
    else:
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, n, dtype=dtype)
        ident = info.max if op == "min" else info.min
    base = np.full(K, ident, dtype)
    base[:5] = np.array([0.0, -0.0, 1.0, -1.0, 7.0]).astype(dtype)
    want = getattr(jnp.asarray(base).at[jnp.asarray(w)], op)(
        jnp.asarray(v), mode="drop")
    dst = torch.from_numpy(base.copy())
    bs.bucket_scatter(torch.from_numpy(w), [(dst, torch.from_numpy(v), op)])
    _same_bits(dst.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.int32])
def test_k13f_add_matches_jax(dtype):
    rng = np.random.default_rng(4)
    K, n = 29, 900
    w = _lanes(rng, n, K)
    if np.dtype(dtype).kind == "f":
        v = rng.normal(0, 100, n).astype(dtype)
    else:  # values near the ends of the range: the sums wrap
        info = np.iinfo(dtype)
        v = rng.integers(info.max // 2, info.max, n, dtype=dtype)
    base = np.zeros(K, dtype)
    want = np.asarray(jnp.asarray(base).at[jnp.asarray(w)].add(
        jnp.asarray(v), mode="drop"))
    dst = torch.from_numpy(base.copy())
    bs.bucket_scatter(torch.from_numpy(w), [(dst, torch.from_numpy(v),
                                             "add")])
    if np.dtype(dtype).kind == "f":
        mag = np.zeros(K)
        keep = w < K
        np.add.at(mag, w[keep], np.abs(v[keep].astype(np.float64)))
        assert (np.abs(dst.numpy() - want) <= 1e-5 * np.maximum(mag, 1)
                ).all()
    else:
        np.testing.assert_array_equal(dst.numpy(), want)


def test_k13f_set_and_true_match_jax():
    """Every column of one store in one call: the bucket (int64), an
    int32 and a float32 group column, the alive flags, a sum; lanes of one
    slot carry the same set values, as the hash keying makes them."""
    rng = np.random.default_rng(5)
    K, n = 64, 500
    w = _lanes(rng, n, K)
    slot_val = rng.integers(-(2**40), 2**40, K + 1)
    bucket = slot_val[w].astype(np.int64)
    g32 = (slot_val[w] % 1000).astype(np.int32)
    gf = (slot_val[w] % 77).astype(np.float32) - 0.5
    d = rng.normal(0, 1, n).astype(np.float32)
    jb = jnp.zeros(K, jnp.int64).at[w].set(bucket, mode="drop")
    jg = jnp.zeros(K, jnp.int32).at[w].set(g32, mode="drop")
    jf = jnp.zeros(K, jnp.float32).at[w].set(gf, mode="drop")
    ja = jnp.zeros(K, bool).at[w].set(True, mode="drop")
    js = jnp.zeros(K, jnp.float32).at[w].add(d, mode="drop")
    t = [torch.zeros(K, dtype=torch.int64), torch.zeros(K, dtype=torch.int32),
         torch.zeros(K, dtype=torch.float32), torch.zeros(K, dtype=torch.bool),
         torch.zeros(K, dtype=torch.float32)]
    bs.bucket_scatter(torch.from_numpy(w), [
        (t[0], torch.from_numpy(bucket), "set"),
        (t[1], torch.from_numpy(g32), "set"),
        (t[2], torch.from_numpy(gf), "set"),
        (t[3], None, "true"),
        (t[4], torch.from_numpy(d), "add")])
    for a, b in zip(t[:4], (jb, jg, jf, ja)):
        _same_bits(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t[4].numpy(), np.asarray(js), atol=1e-5)


def test_k13f_checks_its_columns():
    w = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        bs.bucket_scatter(w.long(), [(torch.zeros(2), torch.zeros(3),
                                      "add")])
    with pytest.raises(ValueError, match="set only"):
        bs.bucket_scatter(w, [(torch.zeros(2, dtype=torch.bool),
                               torch.zeros(3, dtype=torch.bool), "add")])
    with pytest.raises(ValueError, match="dtype"):
        bs.bucket_scatter(w, [(torch.zeros(2), torch.zeros(3,
                               dtype=torch.float64), "add")])
    with pytest.raises(ValueError, match="unknown op"):
        bs.bucket_scatter(w, [(torch.zeros(2), torch.zeros(3), "mean")])


# --------------------------------------------------------------------------- #
# the evict and restore steps on one carried state
# --------------------------------------------------------------------------- #

STEP_APP = """
define stream S (k string, g int, v double, c long, ts long);
define aggregation A
from S select k, g, sum(v) as s, min(v) as lo, max(c) as hi, count() as n
group by k, g aggregate by ts every sec, min, years;
"""


def _pair(text, **kw):
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(text, **kw)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(text, **kw)
    return jrt, trt


def _same_store(j, t):
    j = jax.device_get(j)
    for a, b in zip(j.key_table, t.key_table):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _same_bits(t.bucket_ts.numpy(), j.bucket_ts)
    _same_bits(t.alive.numpy(), j.alive)
    for g in j.group_cols:
        _same_bits(t.group_cols[g].numpy(), j.group_cols[g])
    for a, b in zip(j.comps, t.comps):
        _same_bits(b.numpy(), a)


def _step_feed(rng, n):
    return [(f"k{int(rng.integers(0, 9))}", int(rng.integers(0, 3)),
             float(np.float32(rng.normal(10, 5))), int(rng.integers(-99, 99)),
             int(rng.integers(0, 240_000))) for _ in range(n)]


def test_evict_and_grow_match_jax_on_a_carried_state():
    jrt, trt = _pair(STEP_APP, batch_size=64, group_capacity=4096)
    h = jrt.get_input_handler("S")
    for r in _step_feed(np.random.default_rng(8), 256):
        h.send(r)
    jrt.flush()
    interop.load_strings(trt, jrt.ctx.global_strings.snapshot())
    ja, ta = jrt.aggregations["A"], trt.aggregations["A"]
    interop.load_aggregation(trt, "A", jax.device_get(ja.state))
    for d in range(3):
        _same_store(ja.state[d], ta.state[d])
    for cutoff in (0, 61_000, 150_000):
        _same_store(ja._evict(ja.state[0], jnp.int64(cutoff)),
                    ta._evict(ta.state[0], cutoff))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ja._grow()
        ta._grow()
    assert ta.capacity == ja.capacity == 8192
    for d in range(3):
        _same_store(ja.state[d], ta.state[d])


def test_restore_matches_jax():
    jrt, trt = _pair(STEP_APP, batch_size=64, group_capacity=4096)
    ja, ta = jrt.aggregations["A"], trt.aggregations["A"]
    rng = np.random.default_rng(9)
    n = 300
    bts = (rng.integers(0, 50, n) * 1000).astype(np.int64)
    gk = rng.integers(1, 12, n).astype(np.int32)
    gg = rng.integers(0, 3, n).astype(np.int32)
    keep = np.unique(np.stack([bts, gk, gg]), axis=1, return_index=True)[1]
    bts, gk, gg = bts[keep], gk[keep], gg[keep]
    n = bts.shape[0]
    comps = [rng.normal(0, 9, n), rng.normal(0, 9, n),
             rng.integers(-50, 50, n).astype(np.float64),
             rng.integers(1, 9, n).astype(np.float64)]
    jstore, jn = ja._restore_fn(1)(
        ja.state[1], jnp.asarray(bts), {"k": jnp.asarray(gk),
                                        "g": jnp.asarray(gg)},
        [jnp.asarray(c) for c in comps], jnp.int32(n))
    tstore, tn = ta._restore(
        ta.state[1], torch.from_numpy(bts), {"k": torch.from_numpy(gk),
                                             "g": torch.from_numpy(gg)},
        [torch.from_numpy(c) for c in comps])
    assert int(jn) == int(tn) == n
    _same_store(jstore, tstore)


# --------------------------------------------------------------------------- #
# durable @store: the shapes of tests/test_aggregation_durable.py
# --------------------------------------------------------------------------- #

DURABLE_APP = """
define stream TradeStream (symbol string, price double, ts long);
@store(type='durable')
define aggregation TradeAgg
from TradeStream
select symbol, sum(price) as total, count() as n
group by symbol
aggregate by ts every sec, min;
"""


def _durable_class(base):
    class DurableStore(base):
        """Class-level rows, so a new runtime sees what the last wrote."""

        tables: dict = {}

        def init(self, definition, properties, config_reader=None):
            super().init(definition, properties, config_reader)
            self.rows = list(type(self).tables.get(definition.id, []))

        def _sync(self):
            type(self).tables[self.definition.id] = list(self.rows)

        def add(self, rows):
            super().add(rows)
            self._sync()

        def delete(self, compiled):
            n = super().delete(compiled)
            self._sync()
            return n

    return DurableStore


STORES = {siddhi_tpu: _durable_class(jrec.InMemoryRecordStore),
          siddhi_tpu_torch: _durable_class(trec.InMemoryRecordStore)}


def _durable_rt(pkg, app=DURABLE_APP, **kw):
    mgr = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
           else pkg.SiddhiManager())
    mgr.set_extension("durable", STORES[pkg])
    rt = mgr.create_siddhi_app_runtime(app, batch_size=16, **kw)
    rt.start()
    return rt


def _rows(rt, q="from TradeAgg within 0, 10000 per 'sec' "
                "select symbol, total, n, AGG_TIMESTAMP"):
    return sorted(tuple(e.data) for e in rt.query(q))


@pytest.fixture
def durable():
    for cls in STORES.values():
        cls.tables.clear()
    yield STORES
    for cls in STORES.values():
        cls.tables.clear()


def _durable_script(pkg, sends):
    """Feed each round of `sends` to a fresh runtime, shutting down in
    between; returns the rows each round saw and the durable tables."""
    seen = []
    for rows in sends:
        rt = _durable_rt(pkg)
        seen.append(_rows(rt))
        h = rt.get_input_handler("TradeStream")
        for r in rows:
            h.send(r)
        rt.flush()
        seen.append(_rows(rt))
        seen.append(_rows(rt, "from TradeAgg within 0, 600000 per 'min' "
                              "select symbol, total, n"))
        rt.shutdown()
    return seen, {k: sorted(sorted(r.items()) for r in v)
                  for k, v in STORES[pkg].tables.items()}


def test_flush_and_rebuild_across_restart(durable):
    sends = [[("A", 10.0, 100), ("B", 5.0, 200), ("A", 7.0, 1500)], []]
    want = _durable_script(siddhi_tpu, sends)
    got = _durable_script(siddhi_tpu_torch, sends)
    assert got == want
    assert len(durable[siddhi_tpu_torch].tables["TradeAgg_sec"]) == 3
    assert got[0][3] == got[0][1] and len(got[0][3]) == 3


def test_rebuilt_buckets_keep_accumulating(durable):
    sends = [[("A", 10.0, 100)], [("A", 2.0, 300), ("C", 1.0, 70_000)],
             [("A", 0.5, 61_000)]]
    want = _durable_script(siddhi_tpu, sends)
    got = _durable_script(siddhi_tpu_torch, sends)
    assert got == want
    assert ("A", 12.0, 2, 0) in got[0][4]


def test_no_store_annotation_keeps_the_store_path_off(durable):
    app = DURABLE_APP.replace("@store(type='durable')\n", "")
    for pkg in STORES:
        rt = _durable_rt(pkg, app)
        rt.get_input_handler("TradeStream").send(("A", 1.0, 100))
        rt.flush()
        rt.shutdown()
        assert STORES[pkg].tables == {}


def test_capacity_truncated_rebuild_holds_and_merges(durable):
    """More durable rows than 0.7 x capacity: the newest that fit are
    restored, the rest held host-side and merged back at flush."""
    rows = [(f"s{i % 40}", float(i % 11), 1_000 * (i // 40))
            for i in range(3200)]
    out = {}
    for pkg in STORES:
        rt = _durable_rt(pkg, group_capacity=4096)
        h = rt.get_input_handler("TradeStream")
        for r in rows:
            h.send(r)
        rt.flush()
        rt.shutdown()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rt2 = _durable_rt(pkg, group_capacity=4096)
        agg = rt2.aggregations["TradeAgg"]
        held = {d.value: len(v) for d, v in agg._unrestored.items()}
        live = [int(s.key_table.count) for s in agg.state]
        rt2.get_input_handler("TradeStream").send(("s1", 100.0, 79_500))
        rt2.flush()
        rt2.shutdown()
        out[pkg] = (held, live, [str(w.message) for w in caught],
                    {k: sorted(sorted(r.items()) for r in v)
                     for k, v in STORES[pkg].tables.items()})
        STORES[pkg].tables.clear()
    assert out[siddhi_tpu_torch] == out[siddhi_tpu]
    assert out[siddhi_tpu_torch][0] == {"sec": 3200 - int(0.7 * 4096)}


# --------------------------------------------------------------------------- #
# the record-store half
# --------------------------------------------------------------------------- #

CONDITIONS = [
    "a > 3", "a >= 3 and b == 'x'", "not (a < 2) or b != 'y'",
    "a == 4.5", "b is null", "(a <= 1 or a > 7) and not b is null",
]
ROWS = [{"a": a, "b": b} for a in (0, 1, 2, 3, 4.5, 7, 8, None)
        for b in ("x", "y", None)]


@pytest.mark.parametrize("cond", CONDITIONS)
def test_predicate_visitors_match_jax(cond):
    q = f"from T on {cond} select *"
    je = siddhi_tpu.compiler.parse_on_demand_query(q).on_condition
    te = siddhi_tpu_torch.compiler.parse_on_demand_query(q).on_condition
    jp = jrec.walk_condition(je, jrec.PredicateVisitor(), "T")
    tp = trec.walk_condition(te, trec.PredicateVisitor(), "T")
    jpp = jrec.walk_condition(je, jrec.ParamPredicateVisitor(), "T")
    tpp = trec.walk_condition(te, trec.ParamPredicateVisitor(), "T")

    def safe(fn, *a):
        try:
            return fn(*a)
        except TypeError as e:  # None against a number, in both packages
            return type(e).__name__
    for r in ROWS:
        assert safe(tp, r) == safe(jp, r)
        assert safe(tpp, r, {}) == safe(jpp, r, {})


def test_stream_values_in_store_conditions():
    q = "from S join T on T.a > S.a select * insert into O;"
    te = siddhi_tpu_torch.compiler.parse_query(q).input_stream.on
    with pytest.raises(SiddhiAppCreationError, match="cannot reference"):
        trec.walk_condition(te, trec.PredicateVisitor(), "T")
    fn = trec.walk_condition(te, trec.ParamPredicateVisitor(), "T")
    assert fn({"a": 5}, {"S.a": 3}) and not fn({"a": 2}, {"S.a": 3})
    assert not fn({"a": None}, {"S.a": 3})


def test_in_memory_store_and_its_registration():
    from siddhi_tpu_torch.core.manager import SiddhiManager
    from siddhi_tpu_torch.query_api.definition import (Attribute,
                                                       AttributeType,
                                                       TableDefinition)
    mgr = SiddhiManager(device="cpu")
    cls = mgr.registry.require(ExtensionKind.STORE, "", "inMemory")
    assert cls is trec.InMemoryRecordStore
    st = cls()
    st.init(TableDefinition("T", (Attribute("a", AttributeType.INT),)), {})
    st.add([{"a": i} for i in range(5)])
    gt2 = trec.walk_condition(
        siddhi_tpu_torch.compiler.parse_on_demand_query(
            "from T on a > 2 select *").on_condition,
        trec.PredicateVisitor(), "T")
    assert st.find(gt2) == [{"a": 3}, {"a": 4}]
    assert st.update(gt2, lambda r: {"a": r["a"] * 10}) == 2
    assert st.update_or_add(lambda r: r["a"] == 99, lambda r: r,
                            [{"a": 99}]) == 0
    assert st.delete(lambda r: r["a"] >= 30) == 3
    assert [r["a"] for r in st.find(lambda r: True)] == [0, 1, 2]
    with pytest.raises(NotImplementedError):
        trec.RecordStore().add([])


def test_set_extension_infers_the_kind():
    from siddhi_tpu_torch.ops.aggregators import AggregatorFactory
    from siddhi_tpu_torch.ops.expr_compile import ScalarFunction
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    mgr.set_extension("my:store", trec.InMemoryRecordStore)
    assert mgr.registry.lookup(ExtensionKind.STORE, "my", "store") is \
        trec.InMemoryRecordStore
    agg = AggregatorFactory(lambda types: None)
    mgr.set_extension("my:agg", agg)
    assert mgr.registry.lookup(ExtensionKind.AGGREGATOR, "my", "agg") is agg
    fn = ScalarFunction(lambda types: None)
    mgr.set_extension("f", fn)
    assert mgr.registry.lookup(ExtensionKind.FUNCTION, "", "f") is fn
    mgr.set_extension("w", object(), kind=ExtensionKind.WINDOW)
    with pytest.raises(SiddhiAppCreationError, match="pass kind="):
        mgr.set_extension("x", object())


@pytest.mark.parametrize("text", ["5000", "10 sec", "2 min 30 sec",
                                  "1 hour", "3 days", "1 month",
                                  "2 years", "1 year 1 month"])
def test_annotation_time_literals_match_jax(text):
    assert parse_annotation_time(text) == _parse_annotation_time(text)


# --------------------------------------------------------------------------- #
# the overflow sweep and the refusals
# --------------------------------------------------------------------------- #


def test_overflow_sweep_counts_unplaced_buckets():
    """4,500 new keys in one batch into 4,096 id slots: the lanes K4
    cannot place are counted in the sweep (the JAX table's 16-slot probe
    windows leave at least as many unplaced; ROADMAP Queue 3, K4)."""
    app = """
    define stream S (k long, v double, ts long);
    define aggregation A from S select k, sum(v) as t
    group by k aggregate by ts every sec;
    """
    out = []
    for pkg in STORES:
        mk = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
        rt = pkg.SiddhiManager(**mk).create_siddhi_app_runtime(
            app, batch_size=8192, group_capacity=4096)
        h = rt.get_input_handler("S")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for k in range(4500):
                h.send((k, 1.0, 5))
            rt.flush()
            rt.collect_overflow()
        out.append(rt.ctx.statistics.overflow)
    key = "aggregation:A.key_table_unresolved"
    assert out[1] == {key: 4500 - 4096}
    assert out[0][key] >= out[1][key]


BASE = """
define stream S (k string, v double, ts long);
define aggregation A from S select k, sum(v) as t
group by k aggregate by ts every sec;
"""
REFUSED = {
    "two_aggregations": BASE + """
    define aggregation B from S select k, count() as n
    group by k aggregate by ts every sec;
    from A join B on A.k == B.k per 'sec' select A.k as k insert into O;
    """,
    "join_without_per": BASE + """
    define stream Q (k string);
    from Q join A on Q.k == A.k select Q.k as k insert into O;
    """,
    "window_on_aggregation": BASE + """
    define stream Q (k string);
    from Q join A#window.length(3) on Q.k == A.k per 'sec'
    select Q.k as k insert into O;
    """,
    "store_without_type": BASE.replace(
        "define aggregation", "@store(x='1')\ndefine aggregation"),
    "store_of_no_kind": BASE.replace(
        "define aggregation", "@store(type='nowhere')\ndefine aggregation"),
}


@pytest.mark.parametrize("shape", list(REFUSED))
def test_refusals_match_jax(shape):
    errs = []
    for pkg in STORES:
        with pytest.raises(Exception) as e:
            _durable_rt(pkg, REFUSED[shape])
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


def test_insert_into_from_an_aggregation_is_refused():
    app = BASE + "define table T (k string, t double);"
    errs = []
    for pkg in STORES:
        rt = _durable_rt(pkg, app)
        with pytest.raises(Exception) as e:
            rt.query("from A within 0, 10 per 'sec' select k, t "
                     "insert into T")
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "insert-into from aggregations" in errs[1]


def test_mesh_paths_are_refused_naming_the_roadmap_item():
    from siddhi_tpu_torch.core.aggregation import AggregationRuntime
    rt = _durable_rt(siddhi_tpu_torch, BASE)
    agg = rt.aggregations["A"]
    with pytest.raises(SiddhiAppCreationError, match="Queue 1 item 10"):
        agg.ingest_global(None, 0)
    rt.ctx.mesh = object()
    with pytest.raises(SiddhiAppCreationError, match="Queue 1 item 10"):
        AggregationRuntime(agg.definition, rt.ctx, agg.junction,
                           rt.ctx.registry)


def test_store_on_a_table_stays_refused_naming_the_roadmap_item():
    with pytest.raises(SiddhiAppCreationError, match="Queue 1 item 1\\)"):
        _durable_rt(siddhi_tpu_torch, "@store(type='inMemory')\n"
                    "define table T (k string);")
