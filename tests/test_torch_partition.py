"""Partitions of siddhi_tpu_torch against the JAX package on the CPU.

K4b's plain version (`dense_key_lookup_or_insert_plain`) against
`jax.jit(dense_key_lookup_or_insert)` on seeded inputs at the edges of
chip_smoke.py's phase 34, the ids and the whole table exact; the key-slot
path (`mesh=[cpu]`) against the JAX package's PartitionedQueryStep on a
one-device mesh, on the shapes of tests/test_sharded_partition.py; the
per-key host loop against the JAX host loop on the shapes of
tests/test_partitions.py; and `interop.load_partition`: a JAX run stopped
halfway and resumed in the port gives the rest of the JAX run's output.

Inputs are made with numpy from a seed and handed to both packages, with
explicit timestamps. Output events must be equal in order: strings, ints,
timestamps and event types exactly, floats within rtol 1e-5 (float32 sums
taken in another order, tests/test_numeric_parity.py).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import dtypes as jdtypes
from siddhi_tpu.core.partition import _parse_annotation_time as j_parse
from siddhi_tpu.ops import groupby as jg
from siddhi_tpu_torch import interop
from siddhi_tpu_torch.core import dtypes as tdtypes
from siddhi_tpu_torch.core import superstep
from siddhi_tpu_torch.core.context import parse_annotation_time
from siddhi_tpu_torch.errors import SiddhiAppCreationError
from siddhi_tpu_torch.ops import groupby as tg

FLOAT_RTOL = 1e-5
PAD = (1 << 63) - 1
CPU = torch.device("cpu")


# ----------------------------------------------------------- K4b, plain

def _k4b_calls(name, rng):
    """(K, [(keys, valid), ...]): the calls of one edge case, in order."""
    def call(keys, p=0.9):
        keys = np.asarray(keys, dtype=np.int64)
        return keys, rng.random(keys.shape[0]) < p

    if name == "AJ shape":  # 1,000 keys over K = 1,024, 8,192 lanes (cut)
        pool = rng.integers(-2**62, 2**62, 100)
        return 128, [call(pool[rng.integers(0, 100, 512)]) for _ in range(4)]
    if name == "L = 1":
        return 16, [call([7], 1.0), call([7], 1.0), call([-3], 1.0)]
    if name == "no valid lane":
        return 16, [call(rng.integers(0, 50, 64), 0.0)] * 2
    if name == "every key new":
        return 64, [call(rng.permutation(50) * 1_000_003 - 10**9, 1.0)]
    if name == "every key found":
        keys = rng.integers(-5_000, 5_000, 40)
        return 64, [call(keys, 1.0), call(keys[rng.permutation(40)], 1.0)]
    if name == "int64 extremes":
        ext = np.array([PAD, PAD - 1, -PAD - 1, -PAD, 0, -1, 1])
        return 16, [call(ext[rng.integers(0, 7, 40)]) for _ in range(3)]
    if name == "heavy repeats":
        return 16, [call(rng.choice([5, -9, 2**40], 300)) for _ in range(2)]
    if name == "count + n_new > K":
        return 16, [call(rng.integers(0, 10, 30)),
                    call(rng.integers(10, 40, 60))]
    if name == "eviction":  # a full table receives smaller keys
        return 16, [call(np.arange(1_000, 1_016), 1.0),
                    call(rng.integers(-50, 0, 20), 1.0),
                    call(np.arange(1_000, 1_016), 1.0)]
    if name == "n_new past K":
        return 16, [call(rng.permutation(400) * 7 - 1_000),
                    call(rng.integers(-2**62, 2**62, 400))]
    raise KeyError(name)


K4B_CASES = ("AJ shape", "L = 1", "no valid lane", "every key new",
             "every key found", "int64 extremes", "heavy repeats",
             "count + n_new > K", "eviction", "n_new past K")


@pytest.mark.parametrize("name", K4B_CASES)
def test_k4b_plain_matches_jax(name):
    """Each call's ids and the whole new table (keys, ids, count) exact,
    each side carrying its own table to the next call."""
    K, calls = _k4b_calls(name, np.random.default_rng(K4B_CASES.index(name)))
    jfn = jax.jit(jg.dense_key_lookup_or_insert)
    jt = jg.init_dense_key_table(K)
    tt = tg.init_dense_key_table(K, CPU)
    for i, (keys, valid) in enumerate(calls):
        jt, jids = jfn(jt, jnp.asarray(keys), jnp.asarray(valid))
        tt, tids = tg.dense_key_lookup_or_insert(
            tt, torch.from_numpy(keys), torch.from_numpy(valid))
        for what, a, b in (("ids", tids, jids),
                           ("sorted_keys", tt.sorted_keys, jt.sorted_keys),
                           ("sorted_ids", tt.sorted_ids, jt.sorted_ids),
                           ("count", tt.count, jt.count)):
            assert a.dtype == {"ids": torch.int32, "sorted_keys": torch.int64,
                               "sorted_ids": torch.int32,
                               "count": torch.int32}[what]
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          f"{name} call {i}: {what}")


def test_k4b_eviction_reproduces_the_reference_fault():
    """A full table keeps its K smallest keys: a smaller new key takes a
    live key's entry, and the evicted key is new again, with an id past K
    (its events match no slot). siddhi_tpu/ops/groupby.py:529-551."""
    t = tg.init_dense_key_table(4, CPU)
    t, ids = tg.dense_key_lookup_or_insert(
        t, torch.tensor([10, 20, 30, 40]), torch.ones(4, dtype=torch.bool))
    assert ids.tolist() == [0, 1, 2, 3] and int(t.count) == 4
    t, ids = tg.dense_key_lookup_or_insert(
        t, torch.tensor([5]), torch.ones(1, dtype=torch.bool))
    assert ids.tolist() == [4] and t.sorted_keys.tolist() == [5, 10, 20, 30]
    t, ids = tg.dense_key_lookup_or_insert(
        t, torch.tensor([40]), torch.ones(1, dtype=torch.bool))
    assert ids.tolist() == [4]  # 40 lost its slot 3


# ------------------------------------------------------- app harness

def _mesh_jax():
    return Mesh(np.asarray(jax.devices()[:1]), ("part",))


@contextlib.contextmanager
def _window_capacity(C):
    """Both packages size a time window's ring from the config when the
    runtime is built; these apps hold at most a few dozen events a key."""
    prev = (jdtypes.config.default_window_capacity,
            tdtypes.config.default_window_capacity)
    jdtypes.config.default_window_capacity = C
    tdtypes.config.default_window_capacity = C
    try:
        yield
    finally:
        (jdtypes.config.default_window_capacity,
         tdtypes.config.default_window_capacity) = prev


def _run(pkg, app, actions, *, mesh=False, batch_size=32, stop=None,
         partition_capacity=16):
    """Run `actions` on a runtime of `pkg` (siddhi_tpu or siddhi_tpu_torch)
    and return its Out events as (ts, data, expired) and the runtime.
    Actions: ("send", stream, rows, timestamps), ("flush",),
    ("heartbeat", now); `stop` runs only the first `stop` actions."""
    if pkg is siddhi_tpu_torch:
        m = pkg.SiddhiManager(device="cpu")
        mesh_arg = [CPU] if mesh else None
    else:
        m = pkg.SiddhiManager()
        mesh_arg = _mesh_jax() if mesh else None
    with _window_capacity(1024):
        rt = m.create_siddhi_app_runtime(
            app, batch_size=batch_size, group_capacity=64, mesh=mesh_arg,
            partition_capacity=partition_capacity)
    got = []
    rt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs))
    rt.start()
    _act(rt, actions[:stop])
    return got, rt


def _act(rt, actions):
    for a in actions:
        if a[0] == "send":
            h = rt.get_input_handler(a[1])
            for row, ts in zip(a[2], a[3]):
                h.send(row, timestamp=int(ts))
        elif a[0] == "flush":
            rt.flush()
        else:
            rt.heartbeat(a[1])


def _same(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for i, ((gts, gd, ge), (wts, wd, we)) in enumerate(zip(got, want)):
        assert (gts, ge, len(gd)) == (wts, we, len(wd)), (i, got[i], want[i])
        for g, w in zip(gd, wd):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=FLOAT_RTOL), (i, gd, wd)
            else:
                assert g == w, (i, gd, wd)


def _parity(app, actions, *, mesh=False, **kw):
    want, jrt = _run(siddhi_tpu, app, actions, mesh=mesh, **kw)
    got, trt = _run(siddhi_tpu_torch, app, actions, mesh=mesh, **kw)
    _same(got, want)
    return got, jrt, trt


def _trades(n, n_keys, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"K{int(k)}", float(np.float32(round(p, 2))), int(v))
            for k, p, v in zip(rng.integers(0, n_keys, n),
                               rng.uniform(1, 100, n),
                               rng.integers(1, 50, n))]


def _sends(stream, rows, chunks, t0=1_000, gap=10):
    """Send rows in `chunks` pieces, each followed by a flush."""
    out, step = [], -(-len(rows) // chunks)
    for i in range(0, len(rows), step):
        part = rows[i:i + step]
        out.append(("send", stream, part,
                    t0 + gap * np.arange(i, i + len(part))))
        out.append(("flush",))
    return out


# ---------------------------------------------------- the key-slot path
# Sends of whole 32-lane batches (or one lane bucket throughout): the JAX
# key-slot step compiles once a batch shape.

LENGTH_BATCH = """
define stream S (sym string, price double, vol long);
partition with (sym of S)
begin
  @info(name='q')
  from S#window.lengthBatch(3)
  select sym, sum(price) as total, count() as n
  group by sym
  insert into Out;
end;
"""
SLIDING = """
define stream S (sym string, price double, vol long);
partition with (sym of S)
begin
  @info(name='q')
  from S#window.length(4)
  select sym, sum(price) as total
  group by sym
  insert into Out;
end;
"""
FILTER_INSIDE = """
define stream S (sym string, price double, vol long);
partition with (sym of S)
begin
  @info(name='q')
  from S[vol > 25]#window.lengthBatch(2)
  select sym, sum(price) as total
  group by sym
  insert into Out;
end;
"""
TIME_BATCH = """
@app:playback
define stream S (sym string, price double, vol long);
partition with (sym of S)
begin
  @info(name='q')
  from S#window.timeBatch(1 sec)
  select sym, sum(price) as total, count() as n
  group by sym
  insert into Out;
end;
"""
INT_KEYS = """
define stream S (k long, v double);
partition with (k of S)
begin
  @info(name='q')
  from S#window.lengthBatch(5)
  select k, sum(v) as total, count() as n
  group by k
  insert into Out;
end;
"""


def _int_rows(seed=3, n=128, n_keys=10):
    rng = np.random.default_rng(seed)
    return [(int(k), float(np.float32(v))) for k, v in zip(
        rng.integers(0, n_keys, n), rng.uniform(0, 10, n))]


MESH_SHAPES = {
    "lengthBatch": (LENGTH_BATCH, _sends("S", _trades(60, 5), 3)),
    "sliding": (SLIDING, _sends("S", _trades(50, 4, seed=1), 2)),
    "filter inside": (FILTER_INSIDE, _sends("S", _trades(40, 3, seed=4), 2)),
    "time-window heartbeat": (TIME_BATCH, _sends(
        "S", _trades(32, 3, seed=2), 1, t0=10, gap=50)
        + [("heartbeat", 2_000)]),
    "int keys, many batches": (INT_KEYS, _sends("S", _int_rows(), 4)),
}


@pytest.mark.parametrize("shape", list(MESH_SHAPES))
def test_key_slot_path_matches_jax(shape):
    """The key-slot path against JAX's PartitionedQueryStep on a
    one-device mesh, event for event in slot order."""
    app, actions = MESH_SHAPES[shape]
    got, jrt, trt = _parity(app, actions, mesh=True)
    assert got
    assert jrt.partitions["partition1"]._mesh_step is not None
    tp = trt.partitions["partition1"]
    assert tp._mesh_step is not None and tp._mesh_step.n_slots == 16
    # the key table too
    jk = jrt.partitions["partition1"]._mesh_keys
    for f in ("sorted_keys", "sorted_ids", "count"):
        np.testing.assert_array_equal(getattr(tp._mesh_keys, f).numpy(),
                                      np.asarray(getattr(jk, f)), f)


def test_range_partition_keeps_the_host_loop_with_a_mesh():
    app = """
    define stream S (sym string, price double);
    partition with (price < 50.0 as 'low' or price >= 50.0 as 'high' of S)
    begin
      @info(name='q')
      from S#window.lengthBatch(2)
      select sym, sum(price) as total
      group by sym
      insert into Out;
    end;
    """
    rows = [("A", 10.0), ("A", 20.0), ("B", 60.0), ("B", 70.0)]
    got, _, trt = _parity(app, _sends("S", rows, 1), mesh=True,
                          batch_size=8)
    assert trt.partitions["partition1"]._mesh_step is None
    assert sorted(d for _, d, _ in got) == [
        ("A", 10.0), ("A", 30.0), ("B", 60.0), ("B", 130.0)]


def test_key_slot_overflow_warns_and_drops():
    """12 keys into 8 slots: the table fills, the runtime warns, and the
    keys past capacity drop their events, as in the JAX package."""
    rows = [(f"K{i % 12}", 1.0, 1) for i in range(32)]
    actions = _sends("S", rows, 1)
    with pytest.warns(UserWarning, match="key slots"):
        want, _ = _run(siddhi_tpu, LENGTH_BATCH, actions, mesh=True,
                       partition_capacity=8)
    with pytest.warns(UserWarning, match="key slots"):
        got, _ = _run(siddhi_tpu_torch, LENGTH_BATCH, actions, mesh=True,
                      partition_capacity=8)
    _same(got, want)
    assert {d[0] for _, d, _ in got} == {f"K{i}" for i in range(8)}


def test_mesh_arguments_are_checked():
    tm = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(SiddhiAppCreationError, match="item 10"):
        tm.create_siddhi_app_runtime(LENGTH_BATCH, mesh=[CPU, CPU])
    with pytest.raises(SiddhiAppCreationError, match="no device"):
        tm.create_siddhi_app_runtime(LENGTH_BATCH, mesh=[])
    for refused in ("define trigger T at every 1 sec;",
                    "define function f[python] return int { return 1 };"):
        with pytest.raises(SiddhiAppCreationError, match="not yet ported"):
            tm.create_siddhi_app_runtime(
                "define stream S (a int);\n" + refused)


# ------------------------------------------------------ the host loop

STOCK = ("define stream StockStream (symbol string, price float, "
         "volume long);\n")


def _stock(n, n_keys, seed):
    rng = np.random.default_rng(seed)
    return [(f"S{int(k)}", float(np.float32(p)), int(v)) for k, p, v in zip(
        rng.integers(0, n_keys, n), rng.integers(1, 100, n),
        rng.integers(1, 50, n))]


def _pair_rows(n, n_keys, seed, keyed=True):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_keys, n)
    v = rng.integers(0, 4, n)
    return [((f"k{a}", int(b)) if keyed else (int(b),)) for a, b in zip(k, v)]


JOIN_ON = {"equi": "A.x == B.y", "cross": "A.x < B.y"}


def _join_app(cond, outer=False, broadcast=False):
    b_def = "define stream B (y int);" if broadcast else \
        "define stream B (sym string, y int);"
    keys = "sym of A" if broadcast else "sym of A, sym of B"
    sel = ("A.sym as sym, B.y as y" if broadcast
           else "A.sym as sym, A.x as x, B.y as y")
    join = "left outer join" if outer else "join"
    return (f"define stream A (sym string, x int);\n{b_def}\n"
            f"partition with ({keys}) begin\n"
            f"@info(name='pj') from A#window.length(5) {join} "
            f"B#window.length(5) on {cond} select {sel} insert into Out;\n"
            "end;")


def _join_actions(seed, broadcast=False):
    a = _pair_rows(24, 3, seed)
    b = _pair_rows(24, 3, seed + 1, keyed=not broadcast)
    out = []
    for i in range(0, 24, 8):
        out += [("send", "A", a[i:i + 8], 1_000 + 10 * np.arange(i, i + 8)),
                ("flush",),
                ("send", "B", b[i:i + 8], 1_005 + 10 * np.arange(i, i + 8)),
                ("flush",)]
    return out


HOST_SHAPES = {
    "per-key count": (
        STOCK + "partition with (symbol of StockStream) begin\n"
        "@info(name='q') from StockStream select symbol, count() as n "
        "insert into Out;\nend;",
        _sends("StockStream", _stock(40, 4, 0), 2)),
    "per-key length sum": (
        STOCK + "partition with (symbol of StockStream) begin\n"
        "@info(name='q') from StockStream#window.length(2) "
        "select symbol, sum(price) as total insert into Out;\nend;",
        _sends("StockStream", _stock(40, 3, 1), 4)),
    "stateless filter": (
        STOCK + "partition with (symbol of StockStream) begin\n"
        "@info(name='q') from StockStream[price > 50.0] "
        "select symbol, price insert into Out;\nend;",
        _sends("StockStream", _stock(40, 5, 2), 2)),
    "#inner chaining": (
        STOCK + "partition with (symbol of StockStream) begin\n"
        "from StockStream select symbol, price, count() as n "
        "insert into #Acc;\n"
        "@info(name='q2') from #Acc[n == 2] select symbol, price "
        "insert into Out;\nend;",
        _sends("StockStream", _stock(40, 4, 3), 2)),
    "range routing": (
        "define stream S (symbol string, price float);\n"
        "partition with (price < 50.0 as 'cheap' or price >= 50.0 as 'rich' "
        "of S) begin\n"
        "@info(name='q') from S select symbol, count() as n insert into "
        "Out;\nend;",
        _sends("S", [(s, p) for s, p, _ in _stock(30, 5, 4)], 2)),
    "range drop": (
        "define stream S (symbol string, price float);\n"
        "partition with (price < 50.0 as 'cheap' of S) begin\n"
        "@info(name='q') from S select symbol, price insert into Out;\nend;",
        _sends("S", [(s, p) for s, p, _ in _stock(30, 5, 5)], 2)),
    "equi join": (_join_app(JOIN_ON["equi"]), _join_actions(6)),
    "cross join": (_join_app(JOIN_ON["cross"]), _join_actions(7)),
    "broadcast side": (_join_app(JOIN_ON["equi"], broadcast=True),
                       _join_actions(8, broadcast=True)),
    "outer join": (_join_app(JOIN_ON["equi"], outer=True),
                   _join_actions(9)),
    "pattern": (
        "define stream A (sym string, x int);\n"
        "partition with (sym of A) begin\n"
        "@info(name='pp') from every a=A -> b=A[b.x > a.x] "
        "select a.sym as sym, a.x as ax, b.x as bx insert into Out;\nend;",
        _sends("A", _pair_rows(40, 3, 10), 4)),
    "time window expiry": (
        "@app:playback\n" + STOCK
        + "partition with (symbol of StockStream) begin\n"
        "@info(name='q') from StockStream#window.time(1 sec) "
        "select symbol, sum(volume) as v insert into Out;\nend;",
        _sends("StockStream", _stock(12, 3, 11), 2, t0=100, gap=60)
        + [("heartbeat", 2_000)]
        + _sends("StockStream", _stock(6, 3, 12), 1, t0=2_100, gap=5)),
    "time batch flush": (
        "@app:playback\n" + STOCK
        + "partition with (symbol of StockStream) begin\n"
        "@info(name='q') from StockStream#window.timeBatch(1 sec) "
        "select symbol, sum(volume) as v insert into Out;\nend;",
        _sends("StockStream", _stock(12, 3, 13), 2, t0=100, gap=60)
        + [("heartbeat", 1_500)]),
}


@pytest.mark.parametrize("shape", list(HOST_SHAPES))
def test_host_loop_matches_jax(shape):
    """The per-key host loop against the JAX host loop, event for event
    (keys in key-value order within a batch)."""
    app, actions = HOST_SHAPES[shape]
    got, _, trt = _parity(app, actions, batch_size=8)
    assert got
    assert trt.partitions["partition1"]._mesh_step is None


def test_purge_under_playback_matches_jax():
    app = ("@app:playback\n" + STOCK
           + "@purge(idle.period='1 sec')\n"
           "partition with (symbol of StockStream) begin\n"
           "@info(name='q') from StockStream select symbol, count() as n "
           "insert into Out;\nend;")
    actions = (_sends("StockStream", _stock(10, 3, 14), 1, t0=100, gap=10)
               + [("heartbeat", 5_000)]
               + _sends("StockStream", _stock(10, 3, 15), 1, t0=5_100,
                        gap=10))
    got, jrt, trt = _parity(app, actions, batch_size=8)
    # every key restarted its count after the purge
    assert [n for _, (s, n), _ in got[10:] if s == got[10][1][0]][0] == 1
    assert set(trt.partitions["partition1"].instances) == \
        set(jrt.partitions["partition1"].instances)


def test_annotation_time_matches_jax():
    for text in ("5000", "1 sec", "10 seconds", "1 hour 30 min", "2 days",
                 "1 ms"):
        assert parse_annotation_time(text) == j_parse(text)
    for bad in ("1 fortnight", "1 sec 2"):
        with pytest.raises(Exception):
            j_parse(bad)
        with pytest.raises(SiddhiAppCreationError):
            parse_annotation_time(bad)


def test_superstep_declines_partitioned_queries():
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(LENGTH_BATCH, batch_size=8)
    assert superstep._query_decline(rt.query_runtimes["q"]) == \
        superstep.DECLINE_PARTITION


# ------------------------------------------------------------ interop

@pytest.mark.parametrize("mesh", [False, True], ids=["host loop",
                                                     "key slots"])
def test_load_partition_resumes_a_jax_run(mesh):
    """Half the rounds in the JAX package, its partition's state loaded
    into a fresh port runtime, the other half in the port: the events after
    the cut equal the JAX run's own."""
    app = SLIDING if mesh else HOST_SHAPES["per-key length sum"][0]
    stream = "S" if mesh else "StockStream"
    rows = _trades(48, 5, seed=16) if mesh else _stock(48, 5, 16)
    actions = _sends(stream, rows, 4)
    cut = 4  # two sends and their flushes
    want, jrt = _run(siddhi_tpu, app, actions, mesh=mesh, stop=cut)
    # host copies of the state at the cut, before the JAX run goes on
    jp = jrt.partitions["partition1"]
    strings = jrt.ctx.global_strings.snapshot()
    if mesh:
        carried = dict(slot_states=jax.device_get(jp._mesh_states),
                       key_table=jax.device_get(jp._mesh_keys))
    else:
        carried = dict(
            last_seen=dict(jp.last_seen),
            instances={k: {n: jax.device_get(s) for n, s in inst.items()}
                       for k, inst in jp.instances.items()})
    n_before = len(want)
    _act(jrt, actions[cut:])
    got, trt = _run(siddhi_tpu_torch, app, [], mesh=mesh)
    interop.load_strings(trt, strings)
    interop.load_partition(trt, "partition1", **carried)
    _act(trt, actions[cut:])
    _same(got, want[n_before:])
    assert got
