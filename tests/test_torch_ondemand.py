"""On-demand queries of siddhi_tpu_torch against the JAX package on the
CPU: the 9 shapes of tests/test_ondemand_crud.py (delete, update, update
or insert, insert from a store), the find shapes of tests/test_tables.py
(all rows, `on`, GROUP BY, no group, HAVING judged on the final
aggregate, an unknown store), the on-demand operator matrix of
tests/test_table_matrix.py, finds over named windows, and the
`within` / `per` refusal.

Rows, ints, strings, timestamps and error texts must be equal; floats
within rtol 1e-5 (float32 accumulation order,
tests/test_numeric_parity.py).
"""

import pytest

import siddhi_tpu_torch
from siddhi_tpu_torch.errors import SiddhiAppCreationError

from tests.test_torch_tables import _build, parity

APP = ("define stream S (symbol string, price float, volume long);\n"
       "define table T (symbol string, price float, volume long);\n"
       "from S insert into T;\n")
ROWS = ("send", "S", [("IBM", 75.0, 100), ("WSO2", 57.0, 10),
                      ("GOOG", 120.0, 5)], 1)
FIND_ROWS = ("send", "S", [("IBM", 10.0, 100), ("IBM", 30.0, 200),
                           ("WSO2", 20.0, 300)], 1)

#: name -> (app, script)
SHAPES = {
    # tests/test_ondemand_crud.py
    "delete_on_condition": (APP, [
        ROWS, ("flush",), ("query", "delete T on T.symbol == 'IBM'"),
        ("rows", "T")]),
    "delete_numeric_condition": (APP, [
        ROWS, ("flush",), ("query", "delete T on T.price < 100.0"),
        ("rows", "T")]),
    "update_with_condition": (APP, [
        ROWS, ("flush",),
        ("query", "update T set T.price = 99.5 on T.symbol == 'WSO2'"),
        ("rows", "T")]),
    "update_all_rows": (APP, [
        ROWS, ("flush",), ("query", "update T set T.volume = 0l"),
        ("rows", "T")]),
    "update_expression_of_table_attr": (APP, [
        ROWS, ("flush",),
        ("query", "update T set T.price = T.price * 2.0 "
                  "on T.symbol == 'IBM'"), ("rows", "T")]),
    "updates_existing": (APP, [
        ROWS, ("flush",),
        ("query", "select 'IBM' as symbol, 11.0 as price, 1l as volume "
                  "update or insert into T set T.price = 11.0 "
                  "on T.symbol == 'IBM'"), ("rows", "T")]),
    "inserts_when_missing": (APP, [
        ROWS, ("flush",),
        ("query", "select 'MSFT' as symbol, 300.0 as price, 7l as volume "
                  "update or insert into T set T.price = 300.0 "
                  "on T.symbol == 'MSFT'"), ("rows", "T")]),
    "insert_from_empty_table": (
        "define table Src (a long);\ndefine table T (a long);\n", [
            ("query", "from Src select a insert into T"), ("rows", "T")]),
    "select_insert_into": (
        APP + "define table Archive (symbol string, price float, "
        "volume long);\n", [
            ("send", "S", [("IBM", 75.0, 100), ("WSO2", 57.0, 10)], 1),
            ("flush",),
            ("query", "from T select symbol, price, volume insert into "
                      "Archive"), ("rows", "Archive")]),
    # the finds of tests/test_tables.py
    "select_all": (APP, [
        FIND_ROWS, ("flush",),
        ("query", "from T select symbol, price, volume")]),
    "find_on_condition": (APP, [
        FIND_ROWS, ("flush",),
        ("query", "from T on price > 15.0 select symbol, price")]),
    "aggregation_group_by": (APP, [
        FIND_ROWS, ("flush",),
        ("query", "from T select symbol, sum(price) as total, count() as n "
                  "group by symbol")]),
    "aggregation_no_group": (APP, [
        FIND_ROWS, ("flush",), ("query", "from T select sum(volume) as v")]),
    "having_judges_final_aggregate": (APP, [
        FIND_ROWS, ("flush",),
        ("query", "from T select symbol, sum(price) as s group by symbol "
                  "having s < 25.0")]),
    "unknown_store": (APP, [
        FIND_ROWS, ("flush",), ("query", "from Nope select *"),
        ("query", "delete Nope on Nope.a == 1")]),
    "group_by_long_on_condition_and_const_insert": ("@app:playback\n" + APP, [
        FIND_ROWS, ("flush",),
        ("query", "select 'X' as symbol, 1.5 as price, 300l as volume "
                  "insert into T"),
        ("query", "from T on volume >= 200l select volume, count() as n, "
                  "avg(price) as ap group by volume")]),
    # tests/test_table_matrix.py: on-demand finds by each comparison
    "on_demand_operator_matrix": (
        "define stream C (symbol string, price double);\n"
        "@Index('price')\ndefine table T (symbol string, price double);\n"
        "define stream Seed (symbol string, price double);\n"
        "from Seed select symbol, price insert into T;\n",
        [("send", "Seed", [("p10", 10.0), ("p20", 20.0), ("p30", 30.0)], 1),
         ("flush",)] + [("query", f"from T on {c} select symbol")
                        for c in ("price == 20.0", "price < 20.0",
                                  "price <= 20.0", "price > 20.0",
                                  "price >= 20.0", "price != 20.0")]),
    # named windows
    "find_over_a_length_window": (
        "@app:playback\n"
        "define stream S (symbol string, price double);\n"
        "define window W (symbol string, price double) length(3);\n"
        "from S insert into W;\n", [
            ("send", "S", [("a", 1.0), ("b", 2.0), ("c", 3.0), ("d", 4.0)],
             1), ("flush",),
            ("query", "from W select symbol, price"),
            ("query", "from W on price > 2.5 select count() as n, "
                      "sum(price) as s")]),
    "find_over_a_time_window": (
        "@app:playback\n"
        "define stream S (symbol string, price double);\n"
        "define window W (symbol string, price double) time(10);\n"
        "from S insert into W;\n", [
            ("send", "S", [("a", 1.0), ("b", 2.0)], 100), ("flush",),
            ("send", "S", [("c", 3.0)], 105), ("flush",),
            ("query", "from W select symbol, price"),
            ("heartbeat", 111),
            ("query", "from W select symbol, price")]),
    "insert_from_a_named_window": (
        "@app:playback\n"
        "define stream S (symbol string, price double);\n"
        "define window W (symbol string, price double) lengthBatch(2);\n"
        "define table T (symbol string, price double);\n"
        "from S insert into W;\n", [
            ("send", "S", [("a", 1.0), ("b", 2.0), ("c", 3.0)], 1),
            ("flush",),
            ("query", "from W select symbol, price insert into T"),
            ("rows", "T")]),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_match_jax(name):
    text, script = SHAPES[name]
    got = parity(text, script)
    errors = [o for o in got if len(o) == 3]
    assert len(errors) == (2 if name == "unknown_store" else 0), errors
    assert len(got) > 1


@pytest.mark.parametrize("clause", [
    "within 0l, 100l per 'seconds'", "per 'seconds'"])
def test_within_and_per_are_refused_on_a_table(clause):
    rt = _build(siddhi_tpu_torch, APP)
    with pytest.raises(SiddhiAppCreationError,
                       match="within/per are not applicable to table 'T'"):
        rt.query(f"from T {clause} select symbol")


def test_queries_compile_once_per_text():
    rt = _build(siddhi_tpu_torch, APP)
    rt.query("from T select symbol")
    rt.query("from T select symbol")
    rt.query("delete T on T.price > 1.0")
    assert len(rt._ondemand_cache) == 2
