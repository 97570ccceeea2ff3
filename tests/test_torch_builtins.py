"""Built-in functions of siddhi_tpu_torch against the JAX package on the
CPU: the shapes of tests/test_builtin_extras.py through the public API
(UUID, the set idioms, raw unionSet, eventTimestamp, currentTimeMillis, the
transient-code ring, the extension parameter checks), then each function
of `register_all` on each argument type the JAX function accepts, compiled
by both packages over the same seeded columns, with the refusal texts.

Two shapes of tests/test_builtin_extras.py are not here:
`test_generation_survives_snapshot_restore` (persistence, ROADMAP.md Queue
1 item 7) and `test_docgen_renders_parameter_tables` (tooling, item 9).

Ints, strings, bools, timestamps, types and error texts must be equal.
Floats: bit for bit where one float32 operation gives the value (convert,
maximum, abs, floor, ...); within rtol 2e-6 where the two libraries
compute a transcendental (sqrt, log, exp, sin, cos, power: a few float32
ulps, tests/test_numeric_parity.py's float32 policy). UUIDs are compared
by form and uniqueness, not by value.
"""

import re

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu import compiler as jcompiler
from siddhi_tpu.errors import SiddhiAppCreationError as JCreationError
from siddhi_tpu.extension.registry import GLOBAL as JGLOBAL
from siddhi_tpu.ops import expr_compile as jexpr
from siddhi_tpu_torch import compiler as tcompiler
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.extension.registry import GLOBAL as TGLOBAL
from siddhi_tpu_torch.ops import expr_compile as texpr

from tests.test_torch_tables import assert_same

UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")
S = "define stream S (symbol string, price double);\n"


def _build(pkg, app, batch_size=4):
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        "@app:playback\n" + app, batch_size=batch_size)
    rt.start()
    return rt


def _collect(rt, name="q"):
    got = []
    rt.add_query_callback(name, lambda ts, i, r: got.extend(
        (e.timestamp, tuple(e.data)) for e in i or []))
    return got


def _both(app, sends, flush_each=False, name="q"):
    """The query callback's events in each package: (JAX, port)."""
    outs = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        rt = _build(pkg, app)
        got = _collect(rt, name)
        for sid, row, ts in sends:
            rt.get_input_handler(sid).send(row, timestamp=ts)
            if flush_each:
                rt.flush()
        rt.flush()
        outs.append(got)
    return outs


# --------------------------------------------------------------------------- #
# tests/test_builtin_extras.py through the public API
# --------------------------------------------------------------------------- #

PARITY_APPS = {
    "size_of_union_set_is_exact_distinct": (
        S + "@info(name='q') from S#window.lengthBatch(4) "
        "select sizeOfSet(unionSet(createSet(symbol))) as n insert into Out;",
        [("S", (s, 1.0), 1) for s in "abac"], False),
    "size_of_union_set_without_create_set": (
        S + "@info(name='q') from S#window.lengthBatch(2) "
        "select sizeOfSet(unionSet(symbol)) as n insert into Out;",
        [("S", ("x", 1.0), 1), ("S", ("x", 2.0), 2)], False),
    "event_timestamp": (
        S + "@info(name='q') from S "
        "select eventTimestamp() as ts, symbol insert into Out;",
        [("S", ("a", 1.0), 123), ("S", ("b", 2.0), 456)], False),
    "current_time_millis_is_watermark": (
        S + "@info(name='q') from S "
        "select currentTimeMillis() as now, symbol insert into Out;",
        [("S", ("a", 1.0), 777), ("S", ("b", 1.0), 900)], True),
    "union_set_over_sliding_window": (
        S + "@info(name='q') from S#window.length(2) "
        "select unionSet(symbol) as syms insert into Out;",
        [("S", ("a", 1.0), 1), ("S", ("b", 2.0), 2), ("S", ("c", 3.0), 3)],
        True),
    "union_set_with_create_set": (
        S + "@info(name='q') from S#window.lengthBatch(2) "
        "select unionSet(createSet(symbol)) as syms insert into Out;",
        [("S", ("x", 1.0), 1), ("S", ("y", 2.0), 2)], False),
    "size_of_set_composition_still_works": (
        S + "@info(name='q') from S#window.length(3) "
        "select sizeOfSet(unionSet(createSet(symbol))) as n insert into Out;",
        [("S", (s, 1.0), i + 1) for i, s in enumerate("aba")], False),
    "forwarded_union_set_reads_by_size_of_set": (
        S + "from S#window.length(3) select unionSet(symbol) as s "
        "insert into Mid;\n"
        "@info(name='q') from Mid select sizeOfSet(s) as n insert into Out;",
        [("S", (s, 1.0), i + 1) for i, s in enumerate("abac")], True),
    "conversions_through_the_api": (
        "define stream S (symbol string, price double, v long);\n"
        "@info(name='q') from S select convert(price, 'int') as p, "
        "convert(v, 'double') as d, cast(price, 'long') as l, "
        "maximum(price, v) as m, math:round(price) as r, "
        "instanceOfString(symbol) as c insert into Mid;\n"
        "@info(name='r') from Mid select p, d, l insert into Out;",
        [("S", ("a", 2.7, 3), 1), ("S", ("b", -1.5, 9), 2),
         ("S", (None, 2.5, -4), 3)], False),
    "event_timestamp_of_a_join_side": (
        S + "define stream Q (symbol string);\n"
        "@info(name='q') from Q#window.length(2) as q join "
        "S#window.length(2) as s on q.symbol == s.symbol "
        "select eventTimestamp(s) as sts, eventTimestamp(q) as qts "
        "insert into Out;",
        [("S", ("a", 1.0), 10), ("Q", ("a",), 20)], True),
}


@pytest.mark.parametrize("name", sorted(PARITY_APPS))
def test_builtin_shapes_match_jax(name):
    app, sends, flush_each = PARITY_APPS[name]
    want, got = _both(app, sends, flush_each)
    assert want
    assert_same(want, got)


def test_uuid_per_event():
    rt = _build(siddhi_tpu_torch, S + "@info(name='q') from S "
                "select UUID() as id, symbol insert into Out;")
    got = _collect(rt)
    h = rt.get_input_handler("S")
    h.send(("a", 1.0), timestamp=1)
    h.send(("b", 2.0), timestamp=2)
    rt.flush()
    assert len(got) == 2
    assert all(UUID_RE.match(d[0]) for _, d in got)
    assert got[0][1][0] != got[1][1][0]
    assert [d[1] for _, d in got] == ["a", "b"]


def test_uuid_reaches_stream_callbacks_and_tables():
    rt = _build(siddhi_tpu_torch,
                "define stream S (symbol string);\n"
                "define table T (id string, symbol string);\n"
                "@info(name='q') from S select UUID() as id, symbol "
                "insert into Mid;\n"
                "from Mid select id, symbol insert into T;\n")
    seen = []
    rt.add_callback("Mid", lambda evs: seen.extend(e.data for e in evs))
    rt.get_input_handler("S").send(("a",), timestamp=1)
    rt.get_input_handler("S").send(("b",), timestamp=2)
    rt.flush()
    assert len(seen) == 2 and all(UUID_RE.match(s[0]) for s in seen)
    rows = rt.query("from T select id, symbol")
    assert sorted(r.data for r in rows) == sorted(seen)


def test_forwarded_uuid_matches_on_demand_lookup():
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(
            "define stream S (k string);\n"
            "define table T (k string, id string);\n"
            "from S select k, UUID() as id insert into T;\n", batch_size=4)
    rt.start()
    rt.get_input_handler("S").send(("a",))
    rt.flush()
    (k, the_id), = rt.tables["T"].all_rows()
    rows = rt.query(f"from T on id == '{the_id}' select k")
    rt.shutdown()
    assert UUID_RE.match(the_id)
    assert [r.data for r in rows] == [("a",)]


def test_stale_transient_code_raises_and_live_codes_decode():
    from siddhi_tpu_torch.core.event import StringTable
    from siddhi_tpu_torch.errors import StaleTransientCodeError
    tbl = StringTable()
    old = tbl.encode_transient("u-0", capacity=4)
    live = [tbl.encode_transient(f"u-{i}", capacity=4) for i in range(1, 5)]
    with pytest.raises(StaleTransientCodeError, match="recycled"):
        tbl.decode(old)
    assert [tbl.decode(c) for c in live] == [f"u-{i}" for i in range(1, 5)]


REFUSALS = {
    "uuid_nested": "select convert(UUID(), 'string') as x",
    "nested_union_set": "select convert(unionSet(createSet(symbol)), "
                        "'string') as s",
    "raw_create_set": "select createSet(symbol) as s",
    "grouped_raw_union_set": "select unionSet(symbol) as syms "
                             "group by symbol",
    "non_string_raw_union_set": "select unionSet(price) as ps",
    "raw_union_set_without_as": "select unionSet(symbol)",
    "size_of_set_over_a_long": "select sizeOfSet(eventTimestamp()) as n",
    "size_of_set_over_an_ordinary_column": "select sizeOfSet(v) as n",
    "unknown_function": "select nope(price) as n",
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name):
    """The same refusal text, or (a raw unionSet without `as`, which the
    parser names) acceptance in both."""
    app = ("define stream S (symbol string, price double, v long);\n"
           f"@info(name='q') from S {REFUSALS[name]} insert into Out;")
    outcomes = []
    for pkg, err in ((siddhi_tpu, JCreationError),
                     (siddhi_tpu_torch, SiddhiAppCreationError)):
        try:
            _build(pkg, app)
            outcomes.append(None)
        except err as e:
            outcomes.append(str(e))
    assert outcomes[1] == outcomes[0]
    assert (outcomes[0] is None) == (name == "raw_union_set_without_as")


@pytest.mark.parametrize("app,match", [
    ("from S#window.lengthBatch('ten') select v insert into O;",
     r"window.length.*must be int"),
    ("from S#window.time() select v insert into O;",
     r"needs parameter 1 \(window.time"),
    ("from S#window.length(5, 6) select v insert into O;", "at most"),
])
def test_extension_parameter_metadata(app, match):
    with pytest.raises(SiddhiAppCreationError, match=match):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime("define stream S (v double);\n" + app)


# --------------------------------------------------------------------------- #
# each function of register_all, on each argument type
# --------------------------------------------------------------------------- #

TYPES = ("int", "long", "float", "double", "bool", "string")
N = 12


def _columns(seed=7):
    rng = np.random.default_rng(seed)
    f = np.array([0.0, -0.0, 2.5, -2.5, 3.7, -1.2, 0.5, 1e-3, np.nan, 9.0,
                  -7.5, 1.5], np.float32)
    return {
        "i": rng.integers(-5, 6, N).astype(np.int32),
        "l": rng.integers(-5, 6, N).astype(np.int64),
        "f": f,
        "d": rng.permutation(f),
        "b": rng.random(N) < 0.5,
        "s": rng.integers(0, 4, N).astype(np.int32),  # 0: null
        "t": rng.integers(0, 4, N).astype(np.int32),
        "pi": rng.integers(0, 4, N).astype(np.int32),  # non-negative
    }


ATTR_TYPES = {"i": "INT", "l": "LONG", "f": "FLOAT", "d": "DOUBLE",
              "b": "BOOL", "s": "STRING", "t": "STRING", "pi": "INT"}
ARG_OF = {"int": "i", "long": "l", "float": "f", "double": "d", "bool": "b",
          "string": "s"}


def _eval(pkg, text):
    """(value as numpy, type name) of `text` compiled by one package over
    the seeded columns, or the refusal's (error type name, text)."""
    if pkg is siddhi_tpu:
        compiler, expr, registry = jcompiler, jexpr, JGLOBAL
        from siddhi_tpu.query_api.definition import AttributeType
        import jax.numpy as xp

        def arr(a):
            return xp.asarray(a)
    else:
        compiler, expr, registry = tcompiler, texpr, TGLOBAL
        from siddhi_tpu_torch.query_api.definition import AttributeType

        def arr(a):
            return torch.from_numpy(np.ascontiguousarray(a))
    cols = _columns()
    frames = {"S": {k: getattr(AttributeType, v)
                    for k, v in ATTR_TYPES.items()}}
    resolver = expr.TypeResolver(frames, "S")
    scope = expr.Scope()
    scope.add_frame("S", {k: arr(v) for k, v in cols.items()},
                    arr(np.arange(N, dtype=np.int64)),
                    arr(np.ones(N, bool)), default=True)
    try:
        ce = expr.compile_expression(compiler.parse_expression(text),
                                     resolver, registry)
        v = ce(scope)
    except Exception as e:  # noqa: BLE001 - the refusal is the observation
        return ("error", type(e).__name__, str(e))
    return np.asarray(v), ce.type.name


def _cases():
    out = []
    for t in ("int", "long", "float", "double", "bool"):
        for target in ("int", "long", "float", "double", "bool", "string"):
            out.append(f"convert({ARG_OF[t]}, '{target}')")
        out.append(f"cast({ARG_OF[t]}, 'long')")
    out.append("convert(s, 'int')")
    for a, b in (("i", "l"), ("l", "f"), ("f", "d"), ("i", "d"),
                 ("s", "t"), ("b", "b"), ("i", "s"), ("b", "i")):
        out.append(f"ifThenElse(b, {a}, {b})")
    out.append("ifThenElse(i, i, i)")
    for args in ("s, t", "t, s, s", "i, l", "f, i", "d, f, l"):
        out.append(f"coalesce({args})")
    for args in ("s, t", "i, i", "d, d", "b, b"):
        out.append(f"default({args})")
    for fn in ("maximum", "minimum"):
        for args in ("i, l", "f, d", "i, f", "l, d, i", "f, f"):
            out.append(f"{fn}({args})")
    for t in TYPES:
        for fn in ("Integer", "Long", "Float", "Double", "Boolean",
                   "String"):
            out.append(f"instanceOf{fn}({ARG_OF[t]})")
    for fn in ("abs", "sqrt", "log", "exp", "floor", "ceil", "round", "sin",
               "cos"):
        for t in ("int", "long", "float", "double"):
            out.append(f"math:{fn}({ARG_OF[t]})")
    for args in ("pi, pi", "f, pi", "d, f"):
        out.append(f"math:power({args})")
    out += ["UUID()", "createSet(s)", "sizeOfSet(l)", "sizeOfSet(i + i)"]
    return out


#: computed by another library's transcendental routines
_APPROX = ("math:sqrt", "math:log", "math:exp", "math:sin", "math:cos",
           "math:power")


@pytest.mark.parametrize("text", _cases())
def test_function_matches_jax(text):
    want = _eval(siddhi_tpu, text)
    got = _eval(siddhi_tpu_torch, text)
    if len(want) == 3:  # ("error", type name, text)
        assert got == want
        return
    assert got[1] == want[1]  # the reported type
    w, g = want[0], got[0]
    assert g.dtype == w.dtype and g.shape == w.shape
    if text.startswith(_APPROX):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-7)
    elif w.dtype.kind == "f":
        np.testing.assert_array_equal(g.view(np.uint32 if w.itemsize == 4
                                             else np.uint64),
                                      w.view(np.uint32 if w.itemsize == 4
                                             else np.uint64))
    else:
        np.testing.assert_array_equal(g, w)
