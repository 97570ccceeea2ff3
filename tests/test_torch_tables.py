"""In-memory tables of siddhi_tpu_torch against the JAX package on the CPU:
every shape of tests/test_tables.py and of tests/test_table_matrix.py but
TestCachePolicyJoinMatrix (it needs @store, which is not yet ported; the
on-demand ones, TestOnDemandQuery, the HAVING case and the operator
matrix, are in tests/test_torch_ondemand.py), the
K13d and K13e plain versions against the JAX `_make_insert` and
`TableOutputExecutor` functions on seeded inputs, update-or-insert of two
new events on one key, `in` with and without an index, a pattern that
writes to a table, joins against a table and a named window, a join side
with a stream function and a post-window filter, the @store refusal, and a
table stepped on from a carried JAX state.

Table rows, ints, strings, timestamps, types and error texts must be
equal; floats within rtol 1e-5 (float32 accumulation order,
tests/test_numeric_parity.py). Single operations on float32 values (a
SET of one value, a sum of two) come out bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import table as ttable
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.errors import SiddhiAppCreationError

FLOAT_RTOL = 1e-5


def _build(pkg, text, batch_size=8):
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    return pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        text, batch_size=batch_size)


def _events(evs):
    return [(e.timestamp, tuple(e.data), bool(e.is_expired))
            for e in evs or []]


def run_script(pkg, text, script, batch_size=8, callbacks=()):
    """Run `script` through one package; returns what it observed. Ops:
    ("send", stream, rows, ts0) sends rows at ts0, ts0 + 1, ...;
    ("flush",); ("rows", table) its all_rows(); ("query", text) the events
    of rt.query(text); ("insert_rows", table, rows); ("dropped", table);
    ("heartbeat", t). A raising op records its error's type and text."""
    try:
        rt = _build(pkg, text, batch_size)
    except Exception as e:  # noqa: BLE001 - the error is the observation
        return [("create", type(e).__name__, str(e))]
    rt.start()
    seen = []
    got = {q: [] for q in callbacks}
    for q in callbacks:
        rt.add_query_callback(q, lambda ts, i, r, q=q: got[q].append(
            (_events(i), _events(r))))
    for op in script:
        try:
            kind = op[0]
            if kind == "send":
                h = rt.get_input_handler(op[1])
                for k, row in enumerate(op[2]):
                    h.send(row, timestamp=op[3] + k)
            elif kind == "flush":
                rt.flush()
            elif kind == "rows":
                seen.append(("rows", list(rt.tables[op[1]].all_rows())))
            elif kind == "query":
                seen.append(("query", _events(rt.query(op[1]))))
            elif kind == "insert_rows":
                rt.tables[op[1]].insert_rows(op[2])
            elif kind == "dropped":
                seen.append(("dropped", rt.tables[op[1]].dropped_duplicates))
            elif kind == "heartbeat":
                rt.heartbeat(op[1])
        except Exception as e:  # noqa: BLE001 - the error is the observation
            seen.append((op[0], type(e).__name__, str(e)))
    rt.flush()
    return seen + [("callbacks", got)]


def assert_same(want, got):
    """Equal structure; floats within FLOAT_RTOL, the rest exact (type
    too)."""
    if isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-6)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (want, got)
        for w, g in zip(want, got):
            assert_same(w, g)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(want[k], got[k])
    else:
        assert type(got) is type(want) and got == want, (want, got)


def parity(text, script, batch_size=8, callbacks=()):
    want = run_script(siddhi_tpu, text, script, batch_size, callbacks)
    got = run_script(siddhi_tpu_torch, text, script, batch_size, callbacks)
    assert_same(want, got)
    return got


STOCK = "define stream StockStream (symbol string, price float, volume long);\n"
S = "define stream S (symbol string, price double, volume long);\n"
C = "define stream C (symbol string, price double);\n"
PK_BASE = (
    "define stream StockStream (symbol string, price double, volume long);\n"
    "define stream CheckStockStream (symbol string, volume long);\n"
    "define stream UpdateStockStream "
    "(symbol string, price double, volume long);\n"
    "@PrimaryKey('symbol')\n"
    "define table StockTable (symbol string, price double, volume long);\n"
    "from StockStream insert into StockTable;\n")
SEED_T = ("define table T (symbol string, price double);\n"
          "define stream Seed (symbol string, price double);\n"
          "from Seed select symbol, price insert into T;\n")
INDEX_APP = ("define stream S (symbol string, price double);\n"
             "@Index('symbol')\n"
             "define table T (symbol string, price double);\n"
             "define stream C (symbol string);\n"
             "@info(name='chk') from C[C.symbol == T.symbol in T]\n"
             "select symbol insert into Hits;\n")

COMPOSITE = ("define stream Seed (sym string, ex int, price double);\n"
             "define stream U (sym string, ex int, price double);\n"
             "define table T (sym string, ex int, price double);\n"
             "from Seed insert into T;\n")
COMPOSITE_SEED = [("send", "Seed", [("a", 1, 1.0), ("a", 2, 2.0),
                                    ("b", 1, 3.0)], 1), ("flush",)]

#: name -> (app, script, batch_size, query callbacks)
SHAPES = {
    # tests/test_tables.py
    "insert_and_query": (
        STOCK + "define table StockTable (symbol string, price float, "
        "volume long);\nfrom StockStream insert into StockTable;",
        [("send", "StockStream", [("IBM", 75.6, 100), ("WSO2", 57.6, 10)], 1),
         ("flush",), ("rows", "StockTable")], 8, ()),
    "insert_with_filter": (
        STOCK + "define table T (symbol string, price float);\n"
        "from StockStream[price > 60.0] select symbol, price insert into T;",
        [("send", "StockStream", [("IBM", 75.6, 100), ("WSO2", 57.6, 10)], 1),
         ("flush",), ("rows", "T")], 8, ()),
    "primary_key_dedupe": (
        STOCK + "@PrimaryKey('symbol')\n"
        "define table T (symbol string, price float);\n"
        "from StockStream select symbol, price insert into T;",
        [("send", "StockStream", [("IBM", 10.0, 1), ("IBM", 20.0, 1),
                                  ("WSO2", 30.0, 1)], 1),
         ("flush",), ("rows", "T"), ("dropped", "T")], 8, ()),
    "filter_in_table": (
        STOCK + "define stream CheckStream (symbol string);\n"
        "define table T (symbol string, price float);\n"
        "from StockStream select symbol, price insert into T;\n"
        "@info(name='q') from CheckStream[CheckStream.symbol == T.symbol in T]"
        " select symbol insert into OutStream;",
        [("send", "StockStream", [("IBM", 10.0, 1), ("WSO2", 20.0, 1)], 1),
         ("flush",), ("send", "CheckStream", [("IBM",), ("ORCL",)], 5),
         ("flush",)], 4, ("q",)),
    "delete_on_condition": (
        STOCK + "define stream DeleteStream (symbol string);\n"
        "define table T (symbol string, price float);\n"
        "from StockStream select symbol, price insert into T;\n"
        "from DeleteStream delete T on T.symbol == DeleteStream.symbol;",
        [("send", "StockStream", [("IBM", 10.0, 1), ("WSO2", 20.0, 1)], 1),
         ("flush",), ("send", "DeleteStream", [("IBM",)], 5), ("flush",),
         ("rows", "T")], 4, ()),
    "update_on_condition": (
        STOCK + "define stream UpdateStream (symbol string, price float);\n"
        "define table T (symbol string, price float);\n"
        "from StockStream select symbol, price insert into T;\n"
        "from UpdateStream update T set T.price = UpdateStream.price "
        "on T.symbol == UpdateStream.symbol;",
        [("send", "StockStream", [("IBM", 10.0, 1), ("WSO2", 20.0, 1)], 1),
         ("flush",), ("send", "UpdateStream", [("IBM", 99.0)], 5),
         ("flush",), ("rows", "T")], 4, ()),
    "update_last_event_wins": (
        STOCK + "define stream UpdateStream (symbol string, price float);\n"
        "define table T (symbol string, price float);\n"
        "from StockStream select symbol, price insert into T;\n"
        "from UpdateStream update T set T.price = UpdateStream.price "
        "on T.symbol == UpdateStream.symbol;",
        [("send", "StockStream", [("IBM", 10.0, 1)], 1), ("flush",),
         ("send", "UpdateStream", [("IBM", 50.0), ("IBM", 75.0)], 5),
         ("flush",), ("rows", "T")], 4, ()),
    "update_or_insert": (
        "define stream In (symbol string, price float);\n"
        "define table T (symbol string, price float);\n"
        "from In update or insert into T set T.price = In.price "
        "on T.symbol == In.symbol;",
        [("send", "In", [("IBM", 10.0)], 1), ("flush",),
         ("send", "In", [("IBM", 55.0), ("WSO2", 20.0)], 5), ("flush",),
         ("rows", "T")], 4, ()),
    "in_combined_with_and": (
        "define stream S (symbol string, price float);\n"
        "define table T (symbol string);\n"
        "@info(name='q') from S[symbol == T.symbol in T and price > 10.0] "
        "select symbol insert into OutStream;",
        [("insert_rows", "T", [("IBM",)]),
         ("send", "S", [("IBM", 20.0), ("IBM", 5.0), ("WSO2", 50.0)], 1),
         ("flush",)], 4, ("q",)),
    "indexed_membership_parity": (
        INDEX_APP + "from S select symbol, price insert into T;\n",
        [("send", "S", [("IBM", 75.0), ("WSO2", 57.0)], 1), ("flush",),
         ("send", "C", [("IBM",), ("GOOG",), ("WSO2",)], 5), ("flush",),
         ("query", "delete T on T.symbol == 'IBM'"),
         ("send", "C", [("IBM",), ("WSO2",)], 10), ("flush",)], 8, ("chk",)),
    "unknown_index_attr_rejected": (
        "@Index('nope')\ndefine table T (k int);", [], 8, ()),
    # tests/test_table_matrix.py
    "set_single_attribute": (
        S + C + "define table T (symbol string, price double);\n"
        "from S select symbol, price insert into T;\n"
        "from C update T set T.price = C.price on T.symbol == C.symbol;",
        [("send", "S", [("IBM", 10.0, 1), ("WSO2", 20.0, 1)], 1), ("flush",),
         ("send", "C", [("IBM", 99.0)], 5), ("flush",), ("rows", "T")],
        8, ()),
    "set_arithmetic_over_both_frames": (
        S + C + "define table T (symbol string, price double);\n"
        "from S select symbol, price insert into T;\n"
        "from C update T set T.price = T.price + C.price "
        "on T.symbol == C.symbol;",
        [("send", "S", [("IBM", 10.0, 1)], 1), ("flush",),
         ("send", "C", [("IBM", 5.0)], 5), ("flush",),
         ("send", "C", [("IBM", 7.0)], 6), ("flush",), ("rows", "T")],
        8, ()),
    "update_or_insert_with_set": (
        C + "define table T (symbol string, price double);\n"
        "from C update or insert into T set T.price = C.price "
        "on T.symbol == C.symbol;",
        [("send", "C", [("A", 1.0)], 1), ("flush",),
         ("send", "C", [("A", 9.0), ("B", 2.0)], 5), ("flush",),
         ("rows", "T")], 8, ()),
    "range_join_greater_than": (
        C + "@Index('price')\ndefine table T (symbol string, price double);\n"
        "define stream Seed (symbol string, price double);\n"
        "from Seed select symbol, price insert into T;\n"
        "@info(name='j') from C join T on C.price > T.price "
        "select C.symbol as probe, T.symbol as hit insert into Out;",
        [("send", "Seed", [("p10", 10.0), ("p20", 20.0), ("p30", 30.0)], 1),
         ("flush",), ("send", "C", [("q", 25.0)], 5), ("flush",)],
        8, ("j",)),
    "delete_with_or": (
        C + SEED_T + "from C delete T on T.symbol == 'a' or T.price > 2.5;",
        [("send", "Seed", [("a", 1.0), ("b", 2.0), ("c", 3.0)], 1),
         ("flush",), ("send", "C", [("x", 0.0)], 5), ("flush",),
         ("rows", "T")], 8, ()),
    "delete_with_and_stream_value": (
        C + SEED_T + "from C delete T on "
        "T.symbol == C.symbol and T.price < C.price;",
        [("send", "Seed", [("a", 1.0), ("b", 2.0), ("c", 3.0)], 1),
         ("flush",), ("send", "C", [("b", 5.0)], 5), ("flush",),
         ("rows", "T")], 8, ()),
    "update_with_not": (
        C + SEED_T + "from C update T set T.price = 0.0 on "
        "not (T.symbol == C.symbol);",
        [("send", "Seed", [("a", 1.0), ("b", 2.0), ("c", 3.0)], 1),
         ("flush",), ("send", "C", [("b", 5.0)], 5), ("flush",),
         ("rows", "T")], 8, ()),
    "table_on_left_side": (
        C + SEED_T + "@info(name='j') from T join C on T.symbol == C.symbol "
        "select T.symbol as sym, T.price as tp, C.price as cp "
        "insert into Out;",
        [("send", "Seed", [("IBM", 7.0)], 1), ("flush",),
         ("send", "C", [("IBM", 8.0)], 5), ("flush",)], 8, ("j",)),
    "windowed_stream_join_table": (
        C + SEED_T + "@info(name='j') from C#window.length(2) join T "
        "on C.symbol == T.symbol select C.symbol as sym insert into Out;",
        [("send", "Seed", [("IBM", 7.0)], 1), ("flush",),
         ("send", "C", [("IBM", 1.0)], 5), ("flush",),
         ("send", "C", [("x", 1.0)], 6), ("flush",),
         ("send", "C", [("y", 1.0)], 7), ("flush",)], 8, ("j",)),
    "pk_join_returns_latest_row": (
        PK_BASE + "@info(name='q2') from CheckStockStream join StockTable "
        "on CheckStockStream.symbol == StockTable.symbol "
        "select CheckStockStream.symbol as symbol, "
        "StockTable.volume as volume insert into OutStream;",
        [("send", "StockStream", [("WSO2", 55.6, 100), ("IBM", 75.6, 10)],
          1), ("flush",), ("send", "CheckStockStream", [("IBM", 0)], 5),
         ("flush",)], 8, ("q2",)),
    "pk_duplicate_insert_dropped_and_counted": (
        PK_BASE,
        [("send", "StockStream", [("IBM", 10.0, 1)], 1), ("flush",),
         ("send", "StockStream", [("IBM", 20.0, 2)], 5), ("flush",),
         ("rows", "StockTable"), ("dropped", "StockTable")], 8, ()),
    "pk_update_via_stream": (
        PK_BASE + "from UpdateStockStream update StockTable "
        "set StockTable.price = UpdateStockStream.price, "
        "StockTable.volume = UpdateStockStream.volume "
        "on StockTable.symbol == UpdateStockStream.symbol;",
        [("send", "StockStream", [("IBM", 10.0, 1)], 1), ("flush",),
         ("send", "UpdateStockStream", [("IBM", 99.0, 9)], 5), ("flush",),
         ("rows", "StockTable")], 8, ()),
    "pk_membership_probe": (
        PK_BASE + "@info(name='chk') from CheckStockStream"
        "[CheckStockStream.symbol == StockTable.symbol in StockTable] "
        "select symbol insert into OutStream;",
        [("send", "StockStream", [("IBM", 10.0, 1)], 1), ("flush",),
         ("send", "CheckStockStream", [("IBM", 0), ("MSFT", 0)], 5),
         ("flush",)], 8, ("chk",)),
    "pk_delete_via_stream": (
        PK_BASE + "from CheckStockStream delete StockTable "
        "on StockTable.symbol == CheckStockStream.symbol;",
        [("send", "StockStream", [("IBM", 10.0, 1), ("WSO2", 20.0, 2)], 1),
         ("flush",), ("send", "CheckStockStream", [("IBM", 0)], 5),
         ("flush",), ("rows", "StockTable")], 8, ()),
    # beyond the two files
    "update_or_insert_two_new_events_on_one_key": (
        "define stream In (k long, v double);\n@PrimaryKey('k')\n"
        "define table T (k long, v double);\n"
        "from In update or insert into T set T.v = In.v on T.k == In.k;",
        [("send", "In", [(1, 1.0)], 1), ("flush",),
         ("send", "In", [(2, 5.0), (1, 9.0), (2, 7.0), (3, 1.5)], 5),
         ("flush",), ("rows", "T"), ("dropped", "T")], 8, ()),
    # an equality ON condition through the stream's name, on a composite
    # key (K13e's equality route on the card)
    "update_composite_key_through_the_stream_name": (
        COMPOSITE + "from U update T set T.price = U.price "
        "on T.sym == U.sym and U.ex == T.ex;",
        COMPOSITE_SEED + [("send", "U", [("a", 2, 9.0), ("b", 2, 7.0),
                                         ("a", 2, 11.0), ("b", 1, 4.0)], 5),
                          ("flush",), ("rows", "T")], 8, ()),
    "update_or_insert_composite_key_through_the_stream_name": (
        COMPOSITE + "from U update or insert into T set T.price = U.price "
        "on T.sym == U.sym and T.ex == U.ex;",
        COMPOSITE_SEED + [("send", "U", [("a", 2, 9.0), ("c", 1, 7.0),
                                         ("c", 1, 8.0), ("a", 3, 1.0)], 5),
                          ("flush",), ("rows", "T")], 8, ()),
    "delete_composite_key_through_the_stream_name": (
        COMPOSITE + "from U delete T on U.sym == T.sym and T.ex == U.ex;",
        COMPOSITE_SEED + [("send", "U", [("a", 1, 0.0), ("b", 2, 0.0)], 5),
                          ("flush",), ("rows", "T")], 8, ()),
    "update_or_insert_on_a_double_key_with_nan_and_signed_zero": (
        "define stream U (x double, v int);\n"
        "define table T (x double, v int);\n"
        "from U update or insert into T set T.v = U.v on T.x == U.x;",
        [("send", "U", [(0.0, 1), (float("nan"), 2), (1.5, 3)], 1),
         ("flush",),
         ("send", "U", [(-0.0, 4), (float("nan"), 5), (1.5, 6), (2.0, 7)],
          5), ("flush",), ("rows", "T")], 8, ()),
    "in_without_index": (
        "define stream S (symbol string, price double);\n"
        "define table T (symbol string, price double);\n"
        "define stream C (symbol string, price double);\n"
        "from S insert into T;\n"
        "@info(name='chk') from C[(C.symbol == T.symbol and C.price > T.price) "
        "in T] select symbol, price insert into Hits;\n",
        [("send", "S", [("IBM", 75.0), ("WSO2", 57.0)], 1), ("flush",),
         ("send", "C", [("IBM", 80.0), ("IBM", 70.0), ("GOOG", 99.0),
                        ("WSO2", 60.0)], 5), ("flush",)], 8, ("chk",)),
    "in_with_a_long_index": (
        "define stream S (k long, price double);\n@Index('k')\n"
        "define table T (k long, price double);\ndefine stream C (k long);\n"
        "from S insert into T;\n"
        "@info(name='chk') from C[T.k == C.k in T] select k insert into H;\n",
        [("send", "S", [(5, 1.0), (-3, 2.0), (9, 3.0)], 1), ("flush",),
         ("send", "C", [(5,), (4,), (-3,), (9,), (10,)], 5), ("flush",),
         ("query", "delete T on T.k == 9"),
         ("send", "C", [(9,), (5,)], 20), ("flush",)], 8, ("chk",)),
    "pattern_writes_to_a_table": (
        "@app:playback\n"
        "define stream A (k int, v double);\ndefine stream B (k int, v double);\n"
        "define table T (k int, total double);\n"
        "from every a=A -> b=B[b.k == a.k] select a.k as k, "
        "a.v + b.v as total insert into T;\n"
        "from every a=A -> b=B[b.k == a.k and b.v > 100.0] select a.k as k "
        "delete T on T.k == k;",
        [("send", "A", [(1, 1.0), (2, 2.0)], 1),
         ("send", "B", [(2, 20.0), (1, 10.0)], 5), ("flush",),
         ("rows", "T"), ("send", "A", [(2, 3.0)], 10),
         ("send", "B", [(2, 500.0)], 12), ("flush",), ("rows", "T")],
        8, ()),
    "join_against_a_named_window": (
        "@app:playback\n"
        "define stream S (symbol string, price double);\n"
        "define stream Q (symbol string);\n"
        "define window W (symbol string, price double) length(3);\n"
        "from S insert into W;\n"
        "@info(name='j') from Q join W on Q.symbol == W.symbol "
        "select Q.symbol as sym, W.price as price insert into Out;\n"
        "@info(name='w') from W as w join Q#window.length(2) as q "
        "on w.symbol == q.symbol select w.symbol as sym, w.price as price "
        "insert into Out2;",
        [("send", "S", [("a", 1.0), ("b", 2.0)], 1), ("flush",),
         ("send", "Q", [("a",), ("c",)], 5), ("flush",),
         ("send", "S", [("a", 3.0), ("c", 4.0), ("d", 5.0)], 10),
         ("flush",), ("send", "Q", [("a",), ("b",)], 20), ("flush",)],
        8, ("j", "w")),
    "join_side_with_a_stream_function_and_post_window_filter": (
        "define stream S (symbol string, x double, y double);\n"
        "define stream Q (symbol string);\n"
        "@info(name='j') from S#pol2Cart(x, y)#window.length(4)[x > 1.0] "
        "join Q on S.symbol == Q.symbol "
        "select S.symbol as sym, S.x as x insert into Out;",
        [("send", "S", [("a", 0.5, 0.1), ("b", 2.0, 0.2), ("a", 3.0, 0.3)],
          1), ("flush",), ("send", "Q", [("a",), ("b",)], 5), ("flush",)],
        8, ("j",)),
    "table_join_filters_the_table_side": (
        C + SEED_T + "@info(name='j') from C join T[price > 1.5] "
        "on C.symbol == T.symbol select C.symbol as sym, T.price as tp "
        "insert into Out;",
        [("send", "Seed", [("a", 1.0), ("b", 2.0), ("a", 3.0)], 1),
         ("flush",), ("send", "C", [("a", 0.0), ("b", 0.0)], 5),
         ("flush",)], 8, ("j",)),
    "two_tables_refused": (
        "define table T (k int);\ndefine table U (k int);\n"
        "from T join U on T.k == U.k select T.k as k insert into O;",
        [], 8, ()),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_match_jax(name):
    text, script, batch_size, callbacks = SHAPES[name]
    got = parity(text, script, batch_size, callbacks)
    errors = [o for o in got if len(o) == 3]
    assert bool(errors) == name.endswith(("rejected", "refused")), errors
    assert errors or len(got) > 1 or any(got[-1][1].values()), \
        "nothing observed"


def test_index_plan_is_chosen():
    rt = _build(siddhi_tpu_torch, INDEX_APP)
    t = rt.tables["T"]
    assert t.index_attrs == ("symbol",)
    assert "symbol" in t.probe_indexes()
    assert rt.query_runtimes["chk"]._index_tables == {"T"}


def test_insert_overflow_is_all_or_nothing():
    """tests/test_tables.py's capacity-2 table, in both packages."""
    from siddhi_tpu.errors import CapacityExceededError as JOverflow

    from siddhi_tpu_torch.errors import CapacityExceededError
    for pkg, err in ((siddhi_tpu, JOverflow),
                     (siddhi_tpu_torch, CapacityExceededError)):
        rt = _build(pkg, "@capacity('2')\ndefine table T (x int);")
        t = rt.tables["T"]
        assert t.capacity == 2
        t.insert_rows([(1,)])
        with pytest.raises(err, match="capacity 2 exceeded"):
            t.insert_rows([(2,), (3,), (4,)])
        assert t.all_rows() == [(1,)]


def test_store_is_refused():
    with pytest.raises(SiddhiAppCreationError,
                       match=r"record tables \(@store\) are not yet ported"):
        _build(siddhi_tpu_torch,
               "@store(type='inMemory')\ndefine table T (k int);")


# --------------------------------------------------------------------------- #
# K13d and K13e plain versions against the JAX functions
# --------------------------------------------------------------------------- #

KEY_TYPES = {"int": np.int32, "long": np.int64, "float": np.float32,
             "double": np.float32, "string": np.int32, "bool": np.bool_}


def _key_values(rng, kind, n):
    if kind == "string":  # intern codes, 0 the null code
        return rng.integers(0, 5, n).astype(np.int32)
    if kind in ("float", "double"):
        # NaN never equal, -0.0 == 0.0
        return rng.choice(np.array([0.0, -0.0, 1.5, np.nan, 2.0], np.float32),
                          n)
    if kind == "bool":
        return rng.random(n) < 0.5
    return rng.integers(-2, 3, n).astype(KEY_TYPES[kind])


def _insert_pair(kinds, capacity):
    """The JAX table and the port's, one primary key over `kinds`."""
    names = [f"k{i}" for i in range(len(kinds))]
    text = (f"@PrimaryKey({', '.join(repr(n) for n in names)})\n"
            f"@capacity('{capacity}')\n"
            f"define table T ({', '.join(f'{n} {k}' for n, k in zip(names, kinds))}, "
            "v double);")
    return (_build(siddhi_tpu, text).tables["T"],
            _build(siddhi_tpu_torch, text).tables["T"], names)


def _pinned_keys(pinned, rng, capacity, B):
    """The key columns of a pinned case (rows, then the batch) and the
    batch's valid flags, the contract a hash of the keys must meet:
    "nan_zero_swapped", a (double, long) key whose first lanes are (0.0,
    1), (-0.0, 1) (equal), two (NaN, 1) (equal to nothing), (1.0, 2),
    (2.0, 1) (a swapped pair: not equal), repeats of both, then draws from
    those values; "high_bits", long keys that differ only above bit 32, in
    runs of one key whose first lanes are invalid (only an earlier valid
    lane drops a repeat)."""
    if pinned == "nan_zero_swapped":
        dbl = np.array([0.0, -0.0, np.nan, 1.0, 2.0], np.float32)
        lng = np.array([1, 2, 0], np.int64)
        rows = [dbl[rng.integers(0, 5, capacity)],
                lng[rng.integers(0, 3, capacity)]]
        head = [(0.0, 1), (-0.0, 1), (np.nan, 1), (np.nan, 1), (1.0, 2),
                (2.0, 1), (2.0, 1), (1.0, 2)]
        tail = B - len(head)
        keys = [np.concatenate([np.array([d for d, _ in head], np.float32),
                                dbl[rng.integers(0, 5, tail)]]),
                np.concatenate([np.array([n for _, n in head], np.int64),
                                lng[rng.integers(0, 3, tail)]])]
        valid = np.concatenate([np.ones(len(head), bool),
                                rng.random(tail) < 0.85])
        return rows, keys, valid
    base = np.int64(0x12345678)
    rows = [base + (rng.integers(-4, 5, capacity) << 32)]
    runs = base + (np.repeat(rng.permutation(np.arange(-4, 5))[:6], 3)
                   .astype(np.int64)[:B] << 32)
    keys = [np.concatenate([runs, base + (rng.integers(-4, 5, B - runs.size)
                                          << 32)])]
    valid = rng.random(B) < 0.7
    valid[0:3] = (False, True, True)  # lane 1 stays, lane 2 repeats it
    valid[3:6] = (False, False, True)  # lane 5 stays
    return rows, keys, valid


@pytest.mark.parametrize("kinds,capacity,n_live,pinned", [
    pytest.param(("int", "string"), 64, 30, None, id="kinds0-64-30"),
    pytest.param(("double",), 64, 10, None, id="kinds1-64-10"),
    pytest.param(("float", "bool"), 32, 0, None, id="kinds2-32-0"),
    # overflows: all or nothing
    pytest.param(("long",), 40, 38, None, id="kinds3-40-38"),
    pytest.param(("double", "long"), 64, 24, "nan_zero_swapped",
                 id="double_long-nan-zero-swapped"),
    pytest.param(("long",), 48, 20, "high_bits", id="long-high-bits"),
])
def test_k13d_plain_matches_the_jax_insert(kinds, capacity, n_live, pinned):
    rng = np.random.default_rng(len(kinds) * 100 + capacity + n_live)
    jt, tt, names = _insert_pair(kinds, capacity)
    live = np.zeros(capacity, bool)
    live[rng.choice(capacity, n_live, replace=False)] = True
    B = 16
    if pinned is None:
        cols = {n: _key_values(rng, k, capacity)
                for n, k in zip(names, kinds)}
    else:
        rows, keys, bvalid = _pinned_keys(pinned, rng, capacity, B)
        cols = dict(zip(names, rows))
    cols["v"] = rng.random(capacity).astype(np.float32)
    ts = np.arange(capacity, dtype=np.int64)
    bcols = ({n: _key_values(rng, k, B) for n, k in zip(names, kinds)}
             if pinned is None else dict(zip(names, keys)))
    bcols["v"] = rng.random(B).astype(np.float32)
    bts = 1000 + np.arange(B, dtype=np.int64)
    if pinned is None:
        bvalid = rng.random(B) < 0.85

    from siddhi_tpu.core.table import TableState as JState
    jstate = JState({k: jnp.asarray(v) for k, v in cols.items()},
                    jnp.asarray(ts), jnp.asarray(live))
    jb = JBatch(ts=jnp.asarray(bts), cols={k: jnp.asarray(v)
                                           for k, v in bcols.items()},
                valid=jnp.asarray(bvalid), types=jnp.zeros(B, jnp.int8))
    jnew, jov, jdrop = jax.device_get(jt._insert_fn(jstate, jb))

    tstate = interop.table_state(jax.device_get(jstate), tt.state)
    tb = TBatch(ts=torch.from_numpy(bts), cols={
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in bcols.items()}, valid=torch.from_numpy(bvalid),
        types=torch.zeros(B, dtype=torch.int8))
    drop = ttable.pk_duplicates_plain(
        [tb.cols[k] for k in names], [tstate.cols[k] for k in names],
        tb.valid, tstate.valid)
    new, counts = ttable.table_insert(tstate, tb, tuple(names))
    assert counts.tolist() == [int(jov), int(jdrop)]
    assert int(drop.sum()) == int(jdrop)
    if int(jov):
        return  # the caller keeps the old state (test above)
    for k in cols:
        np.testing.assert_array_equal(new.cols[k].numpy(),
                                      np.asarray(jnew.cols[k]))
    np.testing.assert_array_equal(new.ts.numpy(), np.asarray(jnew.ts))
    np.testing.assert_array_equal(new.valid.numpy(), np.asarray(jnew.valid))


@pytest.mark.parametrize("B,C,density", [(1, 16, 0.5), (8, 32, 0.0),
                                         (16, 64, 0.1), (32, 8, 0.7)])
def test_k13e_plain_matches_the_jax_reductions(B, C, density):
    rng = np.random.default_rng(B * C)
    mask = rng.random((B, C)) < density
    jm = jnp.asarray(mask)
    want = jax.device_get((jm.any(axis=0),
                           (B - 1) - jnp.argmax(jm[::-1, :], axis=0),
                           jm.any(axis=1)))
    got = ttable.last_match_plain(torch.from_numpy(mask))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("action", [
    "update T set T.v = T.v + v, T.n = n on T.k == k",
    "update or insert into T set T.v = v on T.k == k",
    "delete T on T.k == k and T.v < v",
])
def test_table_output_executor_matches_jax(action):
    """Several events on one row, rows with none, lanes with none: the
    JAX executor's jitted function and the port's `run` from one state."""
    text = ("define stream S (k long, v double, n int);\n"
            "@capacity('32')\ndefine table T (k long, v double, n int);\n"
            f"@info(name='q') from S {action};")
    rng = np.random.default_rng(len(action))
    C, B = 32, 12
    cols = {"k": rng.integers(0, 8, C).astype(np.int64),
            "v": rng.random(C).astype(np.float32),
            "n": rng.integers(0, 9, C).astype(np.int32)}
    live = rng.random(C) < 0.6
    ts = np.arange(C, dtype=np.int64)
    bcols = {"k": rng.integers(0, 12, B).astype(np.int64),
             "v": rng.random(B).astype(np.float32),
             "n": rng.integers(0, 9, B).astype(np.int32)}
    bvalid = rng.random(B) < 0.9
    bts = 100 + np.arange(B, dtype=np.int64)

    jrt = _build(siddhi_tpu, text)
    jex = jrt.query_runtimes["q"].table_executor
    from siddhi_tpu.core.table import TableState as JState
    jstate = JState({k: jnp.asarray(v) for k, v in cols.items()},
                    jnp.asarray(ts), jnp.asarray(live))
    jb = JBatch(ts=jnp.asarray(bts), cols={k: jnp.asarray(v)
                                           for k, v in bcols.items()},
                valid=jnp.asarray(bvalid), types=jnp.zeros(B, jnp.int8))
    jnew, jins = jax.device_get(jex._fn(jstate, jb))

    trt = _build(siddhi_tpu_torch, text)
    tex = trt.query_runtimes["q"].table_executor
    tstate = interop.table_state(jax.device_get(jstate),
                                 trt.tables["T"].state)
    tb = TBatch(ts=torch.from_numpy(bts),
                cols={k: torch.from_numpy(v) for k, v in bcols.items()},
                valid=torch.from_numpy(bvalid),
                types=torch.zeros(B, dtype=torch.int8))
    new, ins = tex.run(tstate, tb)
    for k in cols:
        np.testing.assert_array_equal(new.cols[k].numpy(),
                                      np.asarray(jnew.cols[k]))
    np.testing.assert_array_equal(new.valid.numpy(), np.asarray(jnew.valid))
    if "insert" in action:
        np.testing.assert_array_equal(ins.valid.numpy(),
                                      np.asarray(jins.valid))
    assert (np.asarray(jnew.valid) != live).any() or "update" in action


def test_table_steps_on_from_a_carried_jax_state():
    """A JAX runtime's table after some batches, loaded into the port with
    interop.load_table and the string table; the next batches (an update,
    an insert and a membership probe) then match the JAX runtime's."""
    text = ("define stream S (symbol string, v double);\n"
            "define stream U (symbol string, v double);\n"
            "define stream Q (symbol string);\n"
            "@PrimaryKey('symbol')\ndefine table T (symbol string, v double);\n"
            "from S insert into T;\n"
            "from U update T set T.v = T.v + U.v on T.symbol == U.symbol;\n"
            "@info(name='q') from Q[Q.symbol == T.symbol in T] select symbol "
            "insert into O;")
    jrt = _build(siddhi_tpu, text)
    h = jrt.get_input_handler("S")
    for i, s in enumerate(["a", "b", "c", "d"]):
        h.send((s, float(i)), timestamp=i)
    jrt.flush()
    jrt.get_input_handler("U").send(("b", 10.0), timestamp=9)
    jrt.flush()
    trt = _build(siddhi_tpu_torch, text)
    interop.load_app_state(trt, {}, jrt.ctx.global_strings.snapshot(),
                           table_states={"T": jax.device_get(
                               jrt.tables["T"].state)})
    assert trt.tables["T"].all_rows() == jrt.tables["T"].all_rows()
    outs = []
    for rt in (jrt, trt):
        got = []
        rt.add_query_callback("q", lambda ts, i, r, got=got: got.extend(
            tuple(e.data) for e in i or []))
        rt.get_input_handler("U").send(("c", 0.5), timestamp=20)
        rt.get_input_handler("S").send(("e", 7.0), timestamp=21)
        rt.get_input_handler("S").send(("a", 9.0), timestamp=22)
        rt.flush()
        rt.get_input_handler("Q").send(("e",), timestamp=30)
        rt.get_input_handler("Q").send(("z",), timestamp=31)
        rt.flush()
        outs.append((rt.tables["T"].all_rows(), got,
                     rt.tables["T"].dropped_duplicates))
    assert_same(outs[0], outs[1])
    assert outs[1][1] == [("e",)]
