"""Partitions — `partition with (<key> of Stream, ...) begin <queries> end`
(counterpart of siddhi_tpu/core/partition.py).

Every inner query is built once; a partition key owns only a copy of the
inner queries' state tuples, swapped into the shared runtimes while the
key's lanes run. Keys therefore cost state memory, not build time. Two
routes run a batch:

- the per-key host loop (no `mesh`): the key expression is evaluated on
  the device, its values and the valid flags are read back, and each key
  present runs the inner queries on the batch with only its lanes valid
  (output ordered by key value within a batch: string keys by intern
  code). Range partitions route each range's lanes; an event matching no
  range is dropped. A stateless inner graph (filter and projection only)
  of a value partition runs once over the whole batch. Non-partitioned
  streams feeding inner queries reach every live key; `@purge(idle.period)`
  drops keys idle past the period on the heartbeat;
- the key-slot path (`mesh=[device]`, parallel/sharded.py): a single value
  partition over one stream feeding one plain query, with no inner
  `#stream`, no `in Table` and no `@purge`, keeps `partition_capacity` slot
  states, maps each key to a slot in first-appearance order (K3's hash of
  the key, then K4b's dense key table) and runs every slot on every batch
  (output ordered by slot). Keys past the capacity drop their events (a
  warning names it) and a later, smaller key can evict a live key's table
  entry, as in the JAX package (ROADMAP.md, Queue 3).

A key's states are deep copies of the template: the port's kernels update
state tensors in place, so no two keys may share one. Snapshot and restore
of a partition wait for persistence (ROADMAP Queue 1 item 7), the
debugger's break points on the key-slot path for the debugger (item 5).
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..errors import DefinitionNotExistError, SiddhiAppCreationError
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.groupby import GroupState, KeyTable, hash_columns
from ..query_api.definition import AttributeType
from ..query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    EveryStateElement,
    JoinInputStream,
    LogicalStateElement,
    NextStateElement,
    OutputAction,
    Partition,
    Query,
    RangePartitionType,
    SingleInputStream,
    StateInputStream,
    StreamStateElement,
)
from .context import parse_annotation_time
from .event import EventBatch
from .stream import Receiver, StreamJunction


def partition_mesh(mesh, device: torch.device) -> Optional[tuple]:
    """The runtime's `mesh` as a tuple of devices: one device, the
    runtime's own, runs the key-slot path; None keeps the host loop. A
    mesh of more devices shards the key slots across them, which is not
    ported: it raises rather than fall back to the host loop."""
    if mesh is None:
        return None
    devs = tuple(torch.device(d) for d in mesh)
    if not devs:
        raise SiddhiAppCreationError("mesh names no device")
    if len(devs) > 1:
        raise SiddhiAppCreationError(
            f"a mesh of {len(devs)} devices shards a partition's key slots "
            "across devices, which is not yet ported to siddhi_tpu_torch "
            "(ROADMAP Queue 1 item 10); pass mesh=[<the runtime's device>]")

    def index(d: torch.device) -> int:
        if d.index is not None:
            return d.index
        return torch.cuda.current_device() if d.type == "cuda" else 0

    if devs[0].type != device.type or index(devs[0]) != index(device):
        raise SiddhiAppCreationError(
            f"mesh device {devs[0]} is not the runtime's device {device}")
    return devs


def _referenced_streams(query: Query):
    """(stream_id, is_inner) pairs consumed by a query."""
    ins = query.input_stream
    if isinstance(ins, SingleInputStream):
        return [(ins.stream_id, ins.is_inner)]
    if isinstance(ins, JoinInputStream):
        return [(ins.left.stream_id, ins.left.is_inner),
                (ins.right.stream_id, ins.right.is_inner)]
    if isinstance(ins, StateInputStream):
        out = []

        def walk(el):
            if isinstance(el, (StreamStateElement, AbsentStreamStateElement)):
                out.append((el.stream.stream_id, el.stream.is_inner))
            elif isinstance(el, NextStateElement):
                walk(el.state)
                walk(el.next)
            elif isinstance(el, EveryStateElement):
                walk(el.state)
            elif isinstance(el, LogicalStateElement):
                walk(el.left)
                walk(el.right)
            elif isinstance(el, CountStateElement):
                walk(el.element)

        walk(ins.state)
        return out
    return []


class _KeySpec:
    """Compiled partition-key extraction for one partitioned stream."""

    def __init__(self, ptype, junction, registry) -> None:
        definition = junction.definition
        sid = definition.id
        attr_types = {a.name: a.type for a in definition.attributes
                      if a.type != AttributeType.OBJECT}
        resolver = TypeResolver({sid: attr_types}, sid, {sid: junction.codec})
        self.is_range = isinstance(ptype, RangePartitionType)
        if self.is_range:
            self.ranges = []  # (key string, batch -> bool[B])
            for rp in ptype.ranges:
                cond = compile_expression(rp.condition, resolver, registry)
                if cond.type != AttributeType.BOOL:
                    raise SiddhiAppCreationError(
                        f"range partition condition for {rp.partition_key!r} "
                        "must be boolean")
                self.ranges.append((rp.partition_key, self._wrap(cond, sid)))
        else:
            executor = compile_expression(ptype.expression, resolver, registry)
            #: batch -> the key values [B]
            self.value_fn = self._wrap(executor, sid)

    @staticmethod
    def _wrap(executor, sid):
        def fn(batch: EventBatch) -> torch.Tensor:
            scope = Scope()
            scope.add_frame(sid, batch.cols, batch.ts, batch.valid,
                            default=True)
            return torch.broadcast_to(executor(scope), batch.valid.shape)

        return fn


class PartitionRuntime:
    """One `partition ... begin ... end` block."""

    def __init__(self, partition: Partition, app_runtime, index: int) -> None:
        self.partition = partition
        self.rt = app_runtime
        self.ctx = app_runtime.ctx
        self.name = f"partition{index}"

        # --- key extraction per partitioned stream ---
        self.key_specs: dict[str, _KeySpec] = {}
        for pt in partition.partition_types:
            sid = pt.stream_id
            junction = app_runtime.junctions.get(sid)
            if junction is None:
                raise DefinitionNotExistError(
                    f"partition stream {sid!r} is not defined")
            if sid in self.key_specs:
                raise SiddhiAppCreationError(
                    f"stream {sid!r} partitioned twice in one partition")
            self.key_specs[sid] = _KeySpec(pt, junction, self.ctx.registry)

        # --- inner graph: proxies for outer streams, junctions for #streams
        self.proxies: dict[str, StreamJunction] = {}
        self.inner_junctions: dict[str, StreamJunction] = {}
        self.runtimes: dict[str, object] = {}
        self._build_inner_queries()

        # --- per-key state instances ---
        self.template_states = {name: qr.state
                                for name, qr in self.runtimes.items()}
        self.stateless = all(self._is_stateless(qr)
                             for qr in self.runtimes.values())
        self.instances: dict = {}  # key -> {query name: state}
        self.last_seen: dict = {}  # key -> last routed ts
        self._active_key = None  # re-entrancy guard of _run_keyed
        self._purge_idle_ms: Optional[int] = None
        ann = next((a for a in partition.annotations or ()
                    if a.name.lower() == "purge"), None)
        if ann is not None:
            idle = ann.element("idle.period") or ann.element("idlePeriod")
            if idle:
                self._purge_idle_ms = parse_annotation_time(idle)

        # --- the key-slot path, when eligible ---
        self._mesh_step = None
        self._init_mesh_path()

        # --- routing subscriptions ---
        for sid in self.proxies:
            outer = app_runtime.junctions[sid]
            if sid in self.key_specs:
                outer.subscribe(_PartitionStreamReceiver(self, sid))
            else:
                outer.subscribe(_GlobalStreamReceiver(self, sid))

    # ------------------------------------------------------------ key slots

    def _init_mesh_path(self) -> None:
        """Run the partition on the key-slot path (parallel/sharded.py
        PartitionedQueryStep) when a mesh is configured and the partition
        fits it: a single value-partitioned stream feeding a single plain
        query. Range partitions, joins and patterns, inner `#streams`, `in
        Table` dependencies and `@purge` (slot states are permanent) stay
        on the host loop."""
        mesh = self.ctx.mesh
        if mesh is None or self.stateless:
            return
        if self._purge_idle_ms is not None:
            return
        if len(self.key_specs) != 1 or len(self.runtimes) != 1:
            return
        if self.inner_junctions or set(self.proxies) != set(self.key_specs):
            return
        from ..parallel.sharded import PartitionedQueryStep
        from .query_runtime import QueryRuntime

        ((sid, spec),) = self.key_specs.items()
        ((_, qr),) = self.runtimes.items()
        if spec.is_range or not isinstance(qr, QueryRuntime) or qr.dep_tables:
            return

        def key_fn(batch: EventBatch) -> torch.Tensor:
            return hash_columns([spec.value_fn(batch)],
                                counter="K3 partition")

        self._mesh_step = PartitionedQueryStep(
            qr.step, mesh, self.ctx.effective_partition_capacity, key_fn)
        self._mesh_states, self._mesh_keys = self._mesh_step.init_state(
            qr.state)
        self._mesh_qr = qr
        self._mesh_sid = sid
        self._mesh_batches = 0
        self._mesh_key_warned = False

    def _mesh_route(self, batch: EventBatch, now: int) -> None:
        qr = self._mesh_qr
        t0 = time.perf_counter_ns()
        if batch.capacity < qr._batch_cap and \
                not qr.window.shape_polymorphic:
            batch = batch.pad_to(qr._batch_cap)
        self._mesh_states, self._mesh_keys, out = self._mesh_step(
            self._mesh_states, self._mesh_keys, batch, now)
        qr._distribute(out, now)
        self.ctx.statistics.track_latency(qr.name,
                                          time.perf_counter_ns() - t0)
        self._mesh_batches += 1
        # key-slot occupancy, read every batch until the table fills: keys
        # that arrive past capacity get slot ids >= n_slots, matching no
        # slot, so their events are DROPPED, and a later key with a smaller
        # hash can evict a live key's table entry (ops/groupby.py merge)
        if not self._mesh_key_warned:
            used = int(self._mesh_keys.count)
            cap = self._mesh_step.n_slots
            if used >= cap:
                warnings.warn(
                    f"partition {self.name!r}: all {cap} key slots used — "
                    "events for any further partition keys are dropped; "
                    "raise partition_capacity", stacklevel=2)
                self._mesh_key_warned = True
        if (qr._has_custom_aggs
                and (self._mesh_batches in (1, 16, 64)
                     or self._mesh_batches % 256 == 0)):
            self._check_mesh_agg_capacity()

    def _check_mesh_agg_capacity(self) -> None:
        """Per-slot distinctCount pair tables overflow independently; warn
        on the fullest slot (one read over every slot a check)."""
        slots = [s[1].groups for s in self._mesh_states]
        for gi, g in enumerate(slots[0]):
            if not (isinstance(g, tuple) and g):
                continue
            if isinstance(g[0], KeyTable):
                cap = g[0].keys.shape[0] // 2  # hash array is 2x id capacity
                worst, missed = torch.stack([
                    torch.stack([gs[gi][0].count.to(torch.int64),
                                 gs[gi][0].misses.to(torch.int64)])
                    for gs in slots]).max(0).values.tolist()
                if worst > int(0.85 * cap):
                    warnings.warn(
                        f"partition {self.name!r}: a key slot's distinctCount "
                        f"pair table is at {worst}/{cap} lifetime-unique "
                        "pairs; counts will corrupt past capacity — raise "
                        "group_capacity", stacklevel=2)
                elif missed > 0:
                    warnings.warn(
                        f"partition {self.name!r}: key lookups exhausted "
                        "their hash probe window and aliased group 0 — raise "
                        "group_capacity", stacklevel=2)
            elif isinstance(g[0], GroupState) and len(g) == 2:
                # string-code fast path: pair table indexed by interning code
                cap = g[0].values.shape[-1]
                n_codes = len(self.ctx.global_strings)
                if n_codes > int(0.85 * cap):
                    warnings.warn(
                        f"partition {self.name!r}: distinctCount code table "
                        f"at {n_codes}/{cap} interned strings; codes past "
                        "capacity are dropped from the count — raise "
                        "group_capacity", stacklevel=2)

    # ---------------------------------------------------------------- build

    def _proxy_for(self, sid: str) -> StreamJunction:
        if sid not in self.proxies:
            outer = self.rt.junctions.get(sid)
            if outer is None:
                raise DefinitionNotExistError(
                    f"stream {sid!r} (used in partition) is not defined")
            self.proxies[sid] = StreamJunction(outer.definition, self.ctx,
                                               codec=outer.codec)
        return self.proxies[sid]

    def _resolve_input(self, sid: str, is_inner: bool) -> StreamJunction:
        if is_inner:
            j = self.inner_junctions.get(sid)
            if j is None:
                raise DefinitionNotExistError(
                    f"inner stream #{sid} consumed before any query inserts "
                    "into it (order inner queries producer-first)")
            return j
        if sid in self.rt.windows:
            return self.rt.windows[sid].output_junction
        return self._proxy_for(sid)

    def _build_inner_queries(self) -> None:
        from .join_runtime import JoinQueryRuntime, _JoinSideReceiver
        from .pattern_runtime import PatternQueryRuntime, _PatternSideReceiver
        from .query_runtime import QueryRuntime

        rt = self.rt
        for i, query in enumerate(self.partition.queries):
            name = query.name or f"{self.name}_query{i + 1}"
            # resolve inputs through proxies and inner junctions
            jmap = {}
            for sid, is_inner in _referenced_streams(query):
                if sid in rt.tables or sid in rt.aggregations:
                    continue
                jmap[sid] = self._resolve_input(sid, is_inner)

            ins = query.input_stream
            if isinstance(ins, JoinInputStream):
                qr = JoinQueryRuntime(query, self.ctx, jmap, self.ctx.registry,
                                      name, tables=rt.tables,
                                      windows=rt.windows,
                                      aggregations=rt.aggregations)
                if qr.left.junction is not None:
                    qr.left.junction.subscribe(_JoinSideReceiver(qr, True))
                if qr.right.junction is not None:
                    qr.right.junction.subscribe(_JoinSideReceiver(qr, False))
            elif isinstance(ins, StateInputStream):
                qr = PatternQueryRuntime(query, self.ctx, jmap,
                                         self.ctx.registry, name,
                                         tables=rt.tables)
                if qr.merged_junction is not None:
                    # its send-order taps stage rows outside any key's run
                    raise SiddhiAppCreationError(
                        f"query {name!r}: a sequence across several streams "
                        "cannot run inside a partition")
                for sid, junction in qr.junctions.items():
                    junction.subscribe(_PatternSideReceiver(qr, sid))
            elif isinstance(ins, SingleInputStream):
                junction = jmap.get(ins.stream_id)
                if junction is None:
                    raise DefinitionNotExistError(
                        f"stream {ins.stream_id!r} is not defined")
                qr = QueryRuntime(query, self.ctx, junction, self.ctx.registry,
                                  name=name, tables=rt.tables)
                junction.subscribe(qr)
            else:
                raise SiddhiAppCreationError(
                    f"{type(ins).__name__} queries are not supported in "
                    "partitions")

            self._wire_inner_output(qr, query)
            qr._partitioned = True  # the app-level heartbeat skips these
            self.runtimes[name] = qr
            rt.query_runtimes[name] = qr  # query callbacks reach inner queries

    def _wire_inner_output(self, qr, query: Query) -> None:
        out = query.output_stream
        if out.action == OutputAction.INSERT and out.target_id \
                and out.is_inner:
            # `insert into #Inner`: a partition-scoped stream whose schema
            # comes from the producing query
            j = self.inner_junctions.get(out.target_id)
            if j is None:
                j = StreamJunction(qr.output_definition, self.ctx,
                                   codec=qr.output_codec)
                self.inner_junctions[out.target_id] = j
            qr.output_junction = j
            return
        # outer targets (streams, tables, windows) leave the partition
        self.rt._wire_output(qr, query)

    @staticmethod
    def _is_stateless(qr) -> bool:
        from ..ops.ratelimit import PassThroughLimiter
        from ..ops.windows import PassThroughWindow
        from .query_runtime import QueryRuntime

        if not isinstance(qr, QueryRuntime):
            return False  # joins and patterns always keep state
        return (isinstance(qr.window, PassThroughWindow)
                and not qr.selector.agg_specs
                and not (qr.query.selector.group_by or ())
                and isinstance(qr.rate_limiter, PassThroughLimiter))

    # -------------------------------------------------------------- routing

    def _instance(self, key):
        inst = self.instances.get(key)
        if inst is None:
            # fresh per-key tensors: steps update states in place, so an
            # instance never aliases the template or another key
            inst = {name: copy.deepcopy(self.template_states[name])
                    for name in self.runtimes}
            self.instances[key] = inst
        return inst

    def route(self, sid: str, batch: EventBatch, now: int) -> None:
        if self._mesh_step is not None:
            self._mesh_route(batch, now)
            return
        proxy = self.proxies[sid]
        spec = self.key_specs[sid]
        if self.stateless and not spec.is_range:
            # value partitions: every valid event has a key, and with no
            # per-key state one full-width pass is the same
            proxy.publish_batch(batch, now)
            return
        valid = batch.valid.cpu().numpy()
        if not valid.any():
            # timer batch: every live instance sees it, so time windows fire
            for key in list(self.instances):
                self._run_keyed(key, lambda: proxy.publish_batch(batch, now))
            return
        if spec.is_range:
            # an event matching no range is dropped (reference:
            # PartitionStreamReceiver — a null key routes nowhere)
            for key, fn in spec.ranges:
                mask = fn(batch) & batch.valid
                if bool(mask.any()):
                    sub = dataclasses.replace(batch, valid=mask)
                    self.last_seen[key] = now
                    self._run_keyed(
                        key, lambda s=sub: proxy.publish_batch(s, now))
            return
        keys_dev = spec.value_fn(batch)
        keys = keys_dev.cpu().numpy()
        for key in np.unique(keys[valid]).tolist():
            sub = dataclasses.replace(batch,
                                      valid=batch.valid & (keys_dev == key))
            self.last_seen[key] = now
            self._run_keyed(key, lambda s=sub: proxy.publish_batch(s, now))

    def broadcast(self, sid: str, batch: EventBatch, now: int) -> None:
        """A non-partitioned stream feeding inner queries reaches every live
        key instance (reference: PartitionStreamReceiver broadcast path)."""
        proxy = self.proxies[sid]
        if self.stateless:
            proxy.publish_batch(batch, now)
            return
        for key in list(self.instances):
            self._run_keyed(key, lambda: proxy.publish_batch(batch, now))

    def _run_keyed(self, key, action: Callable) -> None:
        # re-entrancy: an inner query inserting into an outer stream this
        # partition consumes re-enters here synchronously. The same key:
        # its states are live, run in place; another key: push and pop, so
        # the active key's mid-batch states survive the nested run.
        if self._active_key is not None and key == self._active_key:
            action()
            return
        inst = self._instance(key)
        prev_states = {name: qr.state for name, qr in self.runtimes.items()}
        prev_key, self._active_key = self._active_key, key
        for name, qr in self.runtimes.items():
            qr.state = inst[name]
        try:
            action()
        finally:
            for name, qr in self.runtimes.items():
                inst[name] = qr.state
                qr.state = prev_states[name]
            self._active_key = prev_key

    # --------------------------------------------------------------- timers

    def heartbeat(self, now: int) -> None:
        if self._mesh_step is not None:
            # one all-invalid batch steps every key slot
            proxy = self.proxies[self._mesh_sid]
            self._mesh_route(EventBatch.empty(
                proxy.definition, proxy.batch_size, self.ctx.device), now)
            return
        if self._purge_idle_ms is not None:
            cutoff = now - self._purge_idle_ms
            for key in [k for k, ts in self.last_seen.items() if ts < cutoff]:
                self.instances.pop(key, None)
                self.last_seen.pop(key, None)
        if self.stateless:
            return
        for key in list(self.instances):
            self._run_keyed(
                key, lambda: [j.heartbeat(now) for j in self.proxies.values()])

    @property
    def has_time_semantics(self) -> bool:
        return any(getattr(qr, "has_time_semantics", False)
                   for qr in self.runtimes.values())

    # ------------------------------------------------------------- snapshot

    def snapshot_states(self, fetch: Optional[Callable] = None,
                        prefix: str = ""):
        raise NotImplementedError(
            "partition snapshots come with persistence, which is not yet "
            "ported to siddhi_tpu_torch (ROADMAP Queue 1 item 7)")

    def restore_states(self, snap) -> None:
        raise NotImplementedError(
            "partition restores come with persistence, which is not yet "
            "ported to siddhi_tpu_torch (ROADMAP Queue 1 item 7); "
            "interop.load_partition carries a JAX partition's state over")


class _PartitionStreamReceiver(Receiver):
    """Reference: core/partition/PartitionStreamReceiver.java:44."""

    def __init__(self, runtime: PartitionRuntime, sid: str) -> None:
        self.runtime = runtime
        self.sid = sid

    def on_batch(self, batch: EventBatch, now: int) -> None:
        self.runtime.route(self.sid, batch, now)


class _GlobalStreamReceiver(Receiver):
    def __init__(self, runtime: PartitionRuntime, sid: str) -> None:
        self.runtime = runtime
        self.sid = sid

    def on_batch(self, batch: EventBatch, now: int) -> None:
        self.runtime.broadcast(self.sid, batch, now)
