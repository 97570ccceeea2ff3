"""Carry a running app's state from the JAX package into the port.

The JAX query state, after `jax.device_get`, is a tuple (window state,
selector state, limiter state) of NamedTuples and dataclasses holding
numpy arrays (a lengthBatch or time-batch window's BatchState, a sliding
window's or an expression window's SlidingState, an expressionBatch
window's GeneralBatchState, a session window's SessionState or
KeyedSessionState, a sort window's SortState, a cron window's CronState,
a hopping window's HopState, a frequent window's FrequentState; the
limiter's CounterState, BufferState, SnapshotState, WindowedSnapshotState,
ContentsSnapshotState or GroupedSnapshotState, or () without a rate); a join
query's is (left window, right window, left multimap, right multimap,
selector state); a named window's is its window state; a pattern query's
is a PatternState (its pending tables, active0, seq, dropped, armed0_ts,
gate0_seq and the selector state); a table's is a TableState (cols by
name, ts, valid); an aggregation's (`AggregationRuntime.state`) is a tuple
of DurationStore, one a duration (key_table, bucket_ts, group_cols by
name, comps, alive). The functions here take that state —
or the same fields as plain dicts — and load it into a port runtime
built from the same app text, so the next batches continue where the JAX
runtime stopped. They read fields by name and import nothing of the JAX
package.

    load_app_state(torch_rt, {name: jax_state}, jax_strings,
                   window_states={name: jax_rt.windows[name].state},
                   table_states={tid: jax_rt.tables[tid].state})

`jax_strings` is the JAX runtime's `ctx.global_strings.snapshot()` (or
the plain list of its strings). A partition's per-key instances, or its
key-slot states and dense key table, load with `load_partition`."""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from .core.aggregation import DurationStore
from .core.app_runtime import SiddhiAppRuntime
from .core.event import EventBatch
from .core.join_runtime import JoinQueryRuntime
from .core.pattern_runtime import PatternQueryRuntime, PatternState
from .core.query_runtime import QueryRuntime
from .core.table import TableState
from .ops.aggregators import HLLState
from .ops.groupby import DenseKeyTable, GroupState, KeyTable
from .ops.join import MultimapState
from .ops.pattern import PendingTable
from .ops.ratelimit import (BufferState, ContentsSnapshotState, CounterState,
                            GroupedSnapshotState, SnapshotState,
                            WindowedSnapshotState)
from .ops.selector import SelectorState
from .ops.expression_general import GeneralBatchState
from .ops.windows import BatchState, SessionState, SlidingState, SortState
from .ops.windows_extra import (CronState, FrequentState, HopState,
                                KeyedSessionState)


def _field(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True)).to(dtype=like.dtype,
                                                    device=like.device)
    if t.shape != like.shape:
        raise ValueError(f"state shape {tuple(t.shape)} does not match the "
                         f"port's {tuple(like.shape)}")
    return t


def _ring(a, like: torch.Tensor) -> torch.Tensor:
    """A JAX ring [C] into the port's ring [C + 1] (spare row last)."""
    a = np.asarray(a)
    out = like.clone()
    out[:-1] = _tensor(a, like[:-1])
    out[-1] = 0
    return out


def window_state(window_np, like):
    if like == ():  # pass-through window
        return ()
    if isinstance(like, (SlidingState, GeneralBatchState)):
        # JAX's uint32 ring words, bit for bit, as the port's int32 words
        ring = np.ascontiguousarray(_field(window_np, "ring")).view(np.int32)
        return type(like)(
            ring=_tensor(ring, like.ring),
            **{f: _tensor(_field(window_np, f), getattr(like, f))
               for f in like._fields if f != "ring"})
    if isinstance(like, FrequentState):
        return FrequentState(
            slot_cols={k: _tensor(_field(window_np, "slot_cols")[k], v)
                       for k, v in like.slot_cols.items()},
            **{f: _tensor(_field(window_np, f), getattr(like, f))
               for f in FrequentState._fields if f != "slot_cols"})
    if isinstance(like, SortState):
        return SortState(
            cols={k: _tensor(_field(window_np, "cols")[k], v)
                  for k, v in like.cols.items()},
            **{f: _tensor(_field(window_np, f), getattr(like, f))
               for f in SortState._fields if f != "cols"})
    if not isinstance(like, (BatchState, SessionState, KeyedSessionState,
                             CronState, HopState)):
        raise ValueError(f"window state {type(like).__name__} is not "
                         "ported by interop")
    # ring fields are [C] there and [C + 1] here; the rest as they are
    rings = {f for f in like._fields
             if f.startswith("ring") and f != "ring_cols"}
    return type(like)(
        ring_cols={k: _ring(_field(window_np, "ring_cols")[k], v)
                   for k, v in like.ring_cols.items()},
        **{f: (_ring if f in rings else _tensor)(_field(window_np, f),
                                                 getattr(like, f))
           for f in like._fields if f != "ring_cols"})


def _group(g_np, like):
    """One aggregate's state: a sum component's [K] values, a monotone or
    forever component's GroupState, or a custom aggregator's state (a tuple
    of KeyTable / GroupState for distinctCount, an HLLState)."""
    if isinstance(like, (KeyTable, GroupState, HLLState)):
        return type(like)(*[_tensor(_field(g_np, f), getattr(like, f))
                            for f in like._fields])
    if isinstance(like, tuple):
        if len(g_np) != len(like):
            raise ValueError(f"aggregate state of {len(g_np)} parts, the "
                             f"port's has {len(like)}")
        return tuple(_group(a, b) for a, b in zip(g_np, like))
    return _tensor(g_np, like)


def selector_state(sel_np, like: SelectorState) -> SelectorState:
    groups = _field(sel_np, "groups")
    if len(groups) != len(like.groups):
        raise ValueError(f"{len(groups)} aggregate components in the state, "
                         f"the port's query has {len(like.groups)}")
    kt_np = _field(sel_np, "key_table")
    if (kt_np is None) != (like.key_table is None):
        raise ValueError("key table present on one side only")
    kt = None
    if kt_np is not None:
        kt = KeyTable(*[_tensor(_field(kt_np, f), getattr(like.key_table, f))
                        for f in KeyTable._fields])
    shared = _field(sel_np, "shared_epoch")
    return SelectorState(
        groups=[_group(g, lg) for g, lg in zip(groups, like.groups)],
        key_table=kt,
        epoch=_tensor(_field(sel_np, "epoch"), like.epoch),
        shared_epoch=(None if shared is None
                      else _tensor(shared, like.shared_epoch)))


def _cols(cols_np, like: dict) -> dict:
    if set(cols_np) != set(like):
        raise ValueError(f"columns {sorted(cols_np)} in the state, the "
                         f"port's limiter has {sorted(like)}")
    return {k: _tensor(cols_np[k], v) for k, v in like.items()}


def limiter_state(r_np, like):
    """A rate limiter's state, field by field: dicts of columns by name,
    the buffered limiter's ring an EventBatch, the rest tensors."""
    if like == ():
        if len(r_np):
            raise ValueError("the state has a rate limiter, the port's "
                             "query has none")
        return ()
    if isinstance(like, BufferState):
        ring, rl = _field(r_np, "ring"), like.ring
        return BufferState(
            ring=EventBatch(ts=_tensor(_field(ring, "ts"), rl.ts),
                            cols=_cols(_field(ring, "cols"), rl.cols),
                            valid=_tensor(_field(ring, "valid"), rl.valid),
                            types=_tensor(_field(ring, "types"), rl.types)),
            **{f: _tensor(_field(r_np, f), getattr(like, f))
               for f in ("appended", "flushed", "bucket")})
    col_field = {SnapshotState: "last_cols", WindowedSnapshotState: "cols",
                 GroupedSnapshotState: "rows"}.get(type(like))
    if col_field is None and not isinstance(
            like, (CounterState, ContentsSnapshotState)):
        raise ValueError(f"limiter state {type(like).__name__} is not "
                         "ported by interop")
    return type(like)(**{
        f: (_cols(_field(r_np, f), getattr(like, f)) if f == col_field
            else _tensor(_field(r_np, f), getattr(like, f)))
        for f in like._fields})


def query_state(state, like) -> tuple:
    """One query's (window, selector, limiter) state."""
    w_np, s_np, r_np = state
    w_like, s_like, r_like = like
    return (window_state(w_np, w_like), selector_state(s_np, s_like),
            limiter_state(r_np, r_like))


def load_query_state(qr: QueryRuntime, state) -> None:
    """Load one query's (window, selector, limiter) state."""
    qr.state = query_state(state, qr.state)


def multimap_state(mm_np, like):
    """A join side's multimap: heads and nexts as they are, the u32 hash and
    arrival-tag arrays bit for bit as the port's int32 patterns."""
    if like == ():
        return ()
    return MultimapState(**{
        f: _tensor(np.ascontiguousarray(_field(mm_np, f)).view(np.int32),
                   getattr(like, f))
        for f in MultimapState._fields})


def join_state(state, like) -> tuple:
    """One join query's (left window, right window, left multimap, right
    multimap, selector) state."""
    wl, wr, mml, mmr, sel = state
    lwl, lwr, lmml, lmmr, lsel = like
    return (window_state(wl, lwl), window_state(wr, lwr),
            multimap_state(mml, lmml), multimap_state(mmr, lmmr),
            selector_state(sel, lsel))


def load_join_state(jr: JoinQueryRuntime, state) -> None:
    """Load one join query's state."""
    jr.state = join_state(state, jr.state)


def pending_table(tbl_np, like: PendingTable) -> PendingTable:
    """One position's pending table, field by field."""
    def cols(name):
        src = _field(tbl_np, name)
        return {ref: _tensor(src[ref], t) for ref, t in
                getattr(like, name).items()}

    frames_np = _field(tbl_np, "frames")
    return PendingTable(
        frames={ref: {n: _tensor(frames_np[ref][n], t)
                      for n, t in cs.items()}
                for ref, cs in like.frames.items()},
        frame_valid=cols("frame_valid"), frame_ts=cols("frame_ts"),
        **{f: _tensor(_field(tbl_np, f), getattr(like, f))
           for f in PendingTable._fields[3:]})


def pattern_state(state_np, like: PatternState) -> PatternState:
    """A pattern query's PatternState: its pending tables, scalars and
    selector state."""
    pending = _field(state_np, "pending")
    if len(pending) != len(like.pending):
        raise ValueError(f"{len(pending)} pending tables in the state, the "
                         f"port's pattern has {len(like.pending)}")
    return PatternState(
        pending=tuple(pending_table(t, lt)
                      for t, lt in zip(pending, like.pending)),
        sel_state=selector_state(_field(state_np, "sel_state"),
                                 like.sel_state),
        **{f: _tensor(_field(state_np, f), getattr(like, f))
           for f in ("active0", "seq", "dropped", "armed0_ts",
                     "gate0_seq")})


def load_pattern_state(pr: PatternQueryRuntime, state) -> None:
    """Load one pattern query's state."""
    pr.state = pattern_state(state, pr.state)


def table_state(state_np, like: TableState) -> TableState:
    """A table's state: its columns by name, row timestamps and validity."""
    cols = _field(state_np, "cols")
    if set(cols) != set(like.cols):
        raise ValueError(f"table columns {sorted(cols)} in the state, the "
                         f"port's table has {sorted(like.cols)}")
    return TableState(
        cols={k: _tensor(cols[k], v) for k, v in like.cols.items()},
        ts=_tensor(_field(state_np, "ts"), like.ts),
        valid=_tensor(_field(state_np, "valid"), like.valid))


def load_table(rt: SiddhiAppRuntime, tid: str, state) -> None:
    """Load table `tid`'s rows (its sorted indexes rebuild at next use)."""
    t = rt.tables[tid]
    t.state = table_state(state, t.state)


def duration_store(store_np, like: DurationStore) -> DurationStore:
    """One duration's bucket store: its key table, buckets, group columns
    by name, components and alive flags."""
    groups = _field(store_np, "group_cols")
    if set(groups) != set(like.group_cols):
        raise ValueError(f"group columns {sorted(groups)} in the state, the "
                         f"port's store has {sorted(like.group_cols)}")
    comps = _field(store_np, "comps")
    if len(comps) != len(like.comps):
        raise ValueError(f"{len(comps)} components in the state, the "
                         f"port's store has {len(like.comps)}")
    kt = _field(store_np, "key_table")
    return DurationStore(
        key_table=KeyTable(*[_tensor(_field(kt, f), getattr(like.key_table,
                                                             f))
                             for f in KeyTable._fields]),
        bucket_ts=_tensor(_field(store_np, "bucket_ts"), like.bucket_ts),
        group_cols={g: _tensor(groups[g], v)
                    for g, v in like.group_cols.items()},
        comps=tuple(_tensor(a, b) for a, b in zip(comps, like.comps)),
        alive=_tensor(_field(store_np, "alive"), like.alive))


def load_aggregation(rt: SiddhiAppRuntime, agg_id: str, state_np) -> None:
    """Load aggregation `agg_id`'s duration stores (the JAX runtime's
    `aggregations[agg_id].state`, one store a duration in the same order;
    both runtimes of one group capacity)."""
    agg = rt.aggregations[agg_id]
    if len(state_np) != len(agg.state):
        raise ValueError(f"{len(state_np)} duration stores in the state, "
                         f"the port's aggregation has {len(agg.state)}")
    agg.state = tuple(duration_store(s, like)
                      for s, like in zip(state_np, agg.state))


def dense_key_table(table_np, device) -> DenseKeyTable:
    """A JAX DenseKeyTable (sorted_keys, sorted_ids, count) as the port's."""
    return DenseKeyTable(
        sorted_keys=torch.from_numpy(np.array(
            _field(table_np, "sorted_keys"), dtype=np.int64)).to(device),
        sorted_ids=torch.from_numpy(np.array(
            _field(table_np, "sorted_ids"), dtype=np.int32)).to(device),
        count=torch.tensor(int(np.asarray(_field(table_np, "count"))),
                           dtype=torch.int32, device=device))


def _state_of(qr, state, like):
    """`state` converted by the converter of qr's kind, shaped as `like`."""
    if isinstance(qr, JoinQueryRuntime):
        return join_state(state, like)
    if isinstance(qr, PatternQueryRuntime):
        return pattern_state(state, like)
    return query_state(state, like)


def _slot(tree, j: int):
    """Slot j of a JAX state stacked on a leading slot axis, every array
    indexed at j; NamedTuples and dataclasses become dicts of their
    fields, which the converters read by name."""
    if isinstance(tree, np.ndarray):
        return tree[j]
    if isinstance(tree, Mapping):
        return {k: _slot(v, j) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _slot(getattr(tree, f), j) for f in tree._fields}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _slot(getattr(tree, f.name), j)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slot(v, j) for v in tree)
    return tree


def load_partition(rt: SiddhiAppRuntime, name: str, instances=None,
                   last_seen=None, slot_states=None, key_table=None) -> None:
    """Load partition `name`'s state from the JAX runtime's partition of the
    same app. The host loop: `instances` ({key: {query: state}}, the JAX
    partition's `instances` after `jax.device_get`) and `last_seen` ({key:
    ts}, for @purge; keys not in it are last seen now). The key-slot path:
    `slot_states` (the JAX `_mesh_states`, stacked on the slot axis) and
    `key_table` (its `_mesh_keys`)."""
    pr = rt.partitions[name]
    if pr._mesh_step is not None:
        if slot_states is None or key_table is None or instances:
            raise ValueError(f"partition {name!r} runs the key-slot path: "
                             "pass slot_states and key_table")
        (qr,) = pr.runtimes.values()
        pr._mesh_states = [
            _state_of(qr, _slot(slot_states, j), like)
            for j, like in enumerate(pr._mesh_states)]
        pr._mesh_keys = dense_key_table(key_table, rt.ctx.device)
        return
    if slot_states is not None or key_table is not None:
        raise ValueError(f"partition {name!r} runs the host loop: pass "
                         "instances")
    now = rt.ctx.timestamp_generator.current_time()
    pr.instances = {}
    pr.last_seen = {}
    for key, states in (instances or {}).items():
        if set(states) != set(pr.runtimes):
            raise ValueError(f"key {key!r}: queries {sorted(states)} in the "
                             f"state, the partition has {sorted(pr.runtimes)}")
        pr.instances[key] = {
            n: _state_of(pr.runtimes[n], s, pr.template_states[n])
            for n, s in states.items()}
        pr.last_seen[key] = (last_seen or {}).get(key, now)


def load_strings(rt: SiddhiAppRuntime, strings) -> None:
    """Load the app-global string table: a JAX `StringTable.snapshot()`
    dict (with its transient UUID ring, so carried state holding transient
    codes decodes the same) or a plain list (code i -> strings[i], 0 =
    null)."""
    rt.ctx.global_strings.restore(strings)


def load_app_state(rt: SiddhiAppRuntime, query_states: dict,
                   strings, window_states: Optional[dict] = None,
                   table_states: Optional[dict] = None) -> None:
    """Load every named query's state, every named window's state (the JAX
    runtime's `windows[name].state`), every table's state and the string
    table."""
    for name, state in query_states.items():
        qr = rt.query_runtimes[name]
        if isinstance(qr, JoinQueryRuntime):
            load_join_state(qr, state)
        elif isinstance(qr, PatternQueryRuntime):
            load_pattern_state(qr, state)
        else:
            load_query_state(qr, state)
    for name, state in (window_states or {}).items():
        w = rt.windows[name]
        w.state = window_state(state, w.state)
    for tid, state in (table_states or {}).items():
        load_table(rt, tid, state)
    load_strings(rt, strings)
