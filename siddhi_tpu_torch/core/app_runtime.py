"""SiddhiAppRuntime (counterpart of siddhi_tpu/core/app_runtime.py, reduced
to streams, named windows, in-memory tables, incremental aggregations
(with durable @store duration tables), single-input queries, joins of
streams, tables, named windows and aggregations, patterns and sequences,
table outputs (insert, delete, update, update or insert), on-demand
queries, heartbeats, Event and columnar callbacks with optional
asynchronous delivery, the capacity-overflow sweep, @Async ingestion with
device supersteps (@app:superstep) and the wall-clock auto-flush
(@app:autoFlush / auto_flush_ms) and partitions (core/partition.py: the
per-key host loop, or the key-slot path on a one-device `mesh`). Lint,
sharding across devices, persistence, record tables (@store on a table),
triggers, functions and fault streams are not yet ported; an app that
declares them is refused."""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Optional

import torch

from .. import compiler
from ..errors import DefinitionNotExistError, SiddhiAppCreationError
from ..extension.registry import Registry
from ..ops.aggregators import HLLState
from ..ops.groupby import KeyTable
from ..ops.ratelimit import WindowedSnapshotState
from ..ops.windows import SlidingState
from ..ops.windows_extra import KeyedSessionState
from ..query_api import SiddhiApp
from ..query_api.execution import (JoinInputStream, OutputAction, Query,
                                   StateInputStream)
from .aggregation import AggregationRuntime
from .ondemand import OnDemandCrudRuntime, OnDemandQueryRuntime
from .table import InMemoryTable, TableJunctionAdapter, TableOutputExecutor
from .context import (
    SiddhiAppContext,
    TimestampGenerator,
    parse_annotation_time,
)
from .join_runtime import JoinQueryRuntime, _JoinSideReceiver
from .partition import PartitionRuntime, partition_mesh
from .pattern_runtime import (MERGED_SID, PatternQueryRuntime,
                              PatternState, _PatternSideReceiver)
from .query_runtime import FunctionQueryCallback, QueryCallback, QueryRuntime
from .window import NamedWindow, WindowJunctionAdapter
from .stream import (
    AsyncDecoder,
    BatchStreamCallback,
    FunctionBatchCallback,
    FunctionStreamCallback,
    InputHandler,
    StreamCallback,
    StreamJunction,
)


class SiddhiAppRuntime:
    def __init__(self, app: SiddhiApp, registry: Registry,
                 device: torch.device, batch_size: int = 0,
                 group_capacity: int = 0,
                 async_callbacks: bool = False,
                 auto_flush_ms: Optional[float] = None,
                 mesh=None, partition_capacity: int = 0) -> None:
        for what, defs in (("trigger", app.trigger_definitions),
                           ("function", app.function_definitions)):
            if defs:
                raise SiddhiAppCreationError(
                    f"{what} definitions are not yet ported to "
                    "siddhi_tpu_torch")
        self.app = app
        playback = app.annotation("app:playback")
        increment_ms = 0
        if playback is not None:
            # @app:playback(idle.time=..., increment=...): idle.time alone
            # bumps by itself
            text = (playback.element("increment")
                    or playback.element("idle.time"))
            increment_ms = parse_annotation_time(text) if text else 0
        self.ctx = SiddhiAppContext(
            name=app.name, registry=registry,
            timestamp_generator=TimestampGenerator(
                playback=playback is not None,
                playback_increment_ms=increment_ms),
            device=device, batch_size=batch_size,
            group_capacity=group_capacity, async_callbacks=async_callbacks,
            superstep_k=_superstep_k(app), mesh=partition_mesh(mesh, device),
            partition_capacity=partition_capacity)
        # wall-clock auto-flush: staged rows deliver within ~auto_flush_ms
        # with no flush() from the caller (kwarg, or
        # @app:autoFlush('10 ms') / @app:autoFlush(interval='10 ms'))
        af = app.annotation("app:autoFlush")
        if auto_flush_ms is None and af is not None:
            v = af.element("interval") or af.element()
            auto_flush_ms = parse_annotation_time(v) if v else 10.0
        self.auto_flush_ms = auto_flush_ms
        self._flusher_stop: Optional[threading.Event] = None
        self._flusher_thread: Optional[threading.Thread] = None
        self.junctions: dict[str, StreamJunction] = {}
        self.query_runtimes: dict[str, QueryRuntime] = {}
        self.input_handlers: dict[str, InputHandler] = {}
        for sd in app.stream_definitions.values():
            self.junctions[sd.id] = StreamJunction(sd, self.ctx)
        self.tables: dict[str, InMemoryTable] = {}
        for td in app.table_definitions.values():
            if td.annotations and (td.annotation("store")
                                   or td.annotation("Store")):
                raise SiddhiAppCreationError(
                    "record tables (@store) are not yet ported to "
                    "siddhi_tpu_torch (ROADMAP Queue 1 item 1)")
            self.tables[td.id] = InMemoryTable(td, self.ctx)
        self.windows: dict[str, NamedWindow] = {
            wd.id: NamedWindow(wd, self.ctx, registry)
            for wd in app.window_definitions.values()}
        self.aggregations: dict[str, AggregationRuntime] = {}
        for ad in app.aggregation_definitions.values():
            junction = self.junctions.get(ad.input_stream_id)
            if junction is None:
                raise DefinitionNotExistError(
                    f"aggregation {ad.id!r}: stream {ad.input_stream_id!r} "
                    "is not defined")
            self.aggregations[ad.id] = AggregationRuntime(
                ad, self.ctx, junction, registry)
        self._ondemand_cache: dict = {}
        for i, query in enumerate(app.queries):
            self._add_query(query, f"query{i + 1}")
        self.partitions: dict[str, PartitionRuntime] = {}
        for i, p in enumerate(app.partitions):
            pr = PartitionRuntime(p, self, i + 1)
            self.partitions[pr.name] = pr

    def _add_query(self, query: Query, default_name: str) -> None:
        name = query.name or default_name
        if isinstance(query.input_stream, JoinInputStream):
            qr = JoinQueryRuntime(query, self.ctx, self.junctions,
                                  self.ctx.registry, name,
                                  tables=self.tables, windows=self.windows,
                                  aggregations=self.aggregations)
            # left first: with both sides on one stream, the left direction
            # probes before the right one, as in the JAX package; a table
            # side has no junction
            if qr.left.junction is not None:
                qr.left.junction.subscribe(_JoinSideReceiver(qr, True))
            if qr.right.junction is not None:
                qr.right.junction.subscribe(_JoinSideReceiver(qr, False))
        elif isinstance(query.input_stream, StateInputStream):
            qr = PatternQueryRuntime(query, self.ctx, self.junctions,
                                     self.ctx.registry, name,
                                     tables=self.tables)
            if qr.merged_junction is not None:
                # multi-stream sequence: the tagged merged junction (fed by
                # send-order taps on the sources) is the only feed;
                # registered so flush() drives it like any other junction
                qr.merged_junction.subscribe(
                    _PatternSideReceiver(qr, MERGED_SID))
                self.junctions[qr.merged_junction.definition.id] = \
                    qr.merged_junction
            else:
                # one receiver per source junction, in position order
                for sid, junction in qr.junctions.items():
                    junction.subscribe(_PatternSideReceiver(qr, sid))
        else:
            sid = getattr(query.input_stream, "stream_id", None)
            junction = self.junctions.get(sid)
            if junction is None and sid in self.windows:
                # `from W ...` consumes the named window's emissions
                if query.input_stream.handlers.window is not None:
                    raise SiddhiAppCreationError(
                        f"named window {sid!r} cannot take a further window "
                        "in FROM (a window cannot be windowed)")
                junction = self.windows[sid].output_junction
            if junction is None:
                raise DefinitionNotExistError(
                    f"stream {sid!r} is not defined")
            qr = QueryRuntime(query, self.ctx, junction, self.ctx.registry,
                              name=name, tables=self.tables)
            junction.subscribe(qr)
        self.query_runtimes[name] = qr
        self._wire_output(qr, query)

    def _wire_output(self, qr, query: Query) -> None:
        out = query.output_stream
        if out.is_fault:
            raise SiddhiAppCreationError(
                "fault streams (@OnError) are not yet ported to "
                "siddhi_tpu_torch")
        if out.action in (OutputAction.DELETE, OutputAction.UPDATE,
                          OutputAction.UPDATE_OR_INSERT):
            table = self.tables.get(out.target_id)
            if table is None:
                raise DefinitionNotExistError(
                    f"table {out.target_id!r} is not defined")
            aliases = [getattr(query.input_stream, "stream_id", None),
                       getattr(query.input_stream, "reference_id", None)]
            qr.table_executor = TableOutputExecutor(
                table, out, qr.selector.out_types, qr.output_codec,
                self.ctx.registry, out_frame_aliases=aliases)
            return
        if out.target_id in self.tables:
            table = self.tables[out.target_id]
            # unionSet-projection provenance flows into the table, so
            # sizeOfSet(T.attr) stays readable downstream
            table.set_projection_attrs |= {
                n for n in qr.selector.host_set_slots
                if n in table.attr_types}
            qr.output_junction = TableJunctionAdapter(table)
        elif out.target_id in self.windows:
            qr.output_junction = WindowJunctionAdapter(
                self.windows[out.target_id], out_types=qr.selector.out_types)
        elif out.target_id:
            target = self.junctions.get(out.target_id)
            if target is None:
                # auto-define the output stream from the select list
                target = StreamJunction(qr.output_definition, self.ctx,
                                        codec=qr.output_codec)
                self.junctions[out.target_id] = target
            qr.output_junction = target

    def start(self) -> None:
        """Start the background machinery: the async callback decoder
        (async_callbacks=True), every @Async junction's staging ring or
        ingress pipeline, and the auto-flusher (auto_flush_ms)."""
        if self.ctx.async_callbacks and self.ctx.decoder is None:
            self.ctx.decoder = AsyncDecoder()
        for j in self.junctions.values():
            j.start_async()
        if self.auto_flush_ms and self._flusher_thread is None:
            self._flusher_stop = threading.Event()
            self._flusher_thread = threading.Thread(
                target=self._flusher_loop, daemon=True,
                name=f"siddhi-flusher-{self.app.name}")
            self._flusher_thread.start()

    def _flusher_loop(self) -> None:
        """Daemon: bound staged-row latency to ~auto_flush_ms, and drive
        heartbeats for time-semantic queries and windows while idle (not in
        playback). A tick runs under the controller lock."""
        interval = self.auto_flush_ms / 1000.0
        needs_hb = any(qr.has_time_semantics
                       for qr in self.query_runtimes.values()) or any(
            w.has_time_semantics for w in self.windows.values())
        while not self._flusher_stop.wait(interval / 2):
            try:
                with self.ctx.controller_lock:
                    if any(j._staged_rows or j._tap_queue
                           for j in self._all_junctions()):
                        self.flush()
                    elif needs_hb and \
                            not self.ctx.timestamp_generator.playback:
                        self.heartbeat()
            except Exception:  # noqa: BLE001 — the flusher must not die
                logging.getLogger("siddhi_tpu_torch").exception(
                    "auto-flush tick failed")

    def statistics_report(self) -> dict:
        """Statistics.report() and each ingress pipeline's
        stats_snapshot() under "ingress_pipeline"."""
        rep = self.ctx.statistics.report()
        rep["ingress_pipeline"] = {
            sid: j._pipeline.stats_snapshot()
            for sid, j in self.junctions.items()
            if j._pipeline is not None}
        return rep

    def get_input_handler(self, stream_id: str) -> InputHandler:
        if stream_id not in self.input_handlers:
            junction = self.junctions.get(stream_id)
            if junction is None:
                raise DefinitionNotExistError(
                    f"stream {stream_id!r} is not defined")
            self.input_handlers[stream_id] = InputHandler(junction)
        return self.input_handlers[stream_id]

    def add_callback(self, stream_id: str, callback,
                     columnar: bool = False) -> None:
        """Subscribe to a stream. `columnar=True` delivers ColumnarBlock
        batches (compacted numpy columns, lazy string decode) instead of
        Event lists."""
        junction = self.junctions.get(stream_id)
        if junction is None:
            raise DefinitionNotExistError(
                f"stream {stream_id!r} is not defined")
        if columnar and not isinstance(
                callback, (BatchStreamCallback, StreamCallback)):
            callback = FunctionBatchCallback(callback)
        elif not isinstance(callback, (StreamCallback, BatchStreamCallback)):
            callback = FunctionStreamCallback(callback)
        junction.subscribe(callback)

    def add_query_callback(self, query_name: str, callback) -> None:
        qr = self.query_runtimes.get(query_name)
        if qr is None:
            raise DefinitionNotExistError(
                f"query {query_name!r} is not defined")
        if not isinstance(callback, QueryCallback):
            callback = FunctionQueryCallback(callback)
        qr.add_callback(callback)

    def flush(self, now: Optional[int] = None) -> None:
        """Drive every staged batch through the pipeline."""
        for j in self._all_junctions():
            j.flush(now)

    def _all_junctions(self) -> list:
        """The stream junctions, then the named windows' output
        junctions."""
        return (list(self.junctions.values())
                + [w.output_junction for w in self.windows.values()])

    def query(self, text: str, now: Optional[int] = None):
        """Run an on-demand (pull) query against a table, a named window or
        an aggregation (`within ... per '<duration>'`): find, or a write
        form (delete, update, update or insert, insert). Returns the Events
        found (an insert from a store returns the rows it inserted, the
        other write forms none). Compiled once per text."""
        rt = self._ondemand_cache.get(text)
        if rt is None:
            odq = compiler.parse_on_demand_query(text)
            if odq.action != OutputAction.RETURN:
                rt = self._build_crud_runtime(odq)
            else:
                store = self.tables.get(odq.input_store_id)
                if store is None:
                    store = self.windows.get(odq.input_store_id)
                if store is None and \
                        odq.input_store_id in self.aggregations:
                    # an aggregation store: bind `per`/`within` into a view
                    agg = self.aggregations[odq.input_store_id]
                    if odq.per is None:
                        raise SiddhiAppCreationError(
                            f"aggregation {odq.input_store_id!r} queries "
                            "need `per '<duration>'`")
                    store = agg.view(odq.per, odq.within_range)
                    odq = dataclasses.replace(odq, per=None,
                                              within_range=None)
                if store is None:
                    raise DefinitionNotExistError(
                        f"store {odq.input_store_id!r} is not defined")
                rt = OnDemandQueryRuntime(odq, store, self.ctx,
                                          self.ctx.registry)
            self._ondemand_cache[text] = rt
        self.flush()
        t = (now if now is not None
             else self.ctx.timestamp_generator.current_time())
        return rt.execute(t)

    def _build_crud_runtime(self, odq):
        target = self.tables.get(odq.target_id)
        if target is None:
            raise DefinitionNotExistError(
                f"table {odq.target_id!r} is not defined")
        source = None
        if odq.action == OutputAction.INSERT and \
                odq.input_store_id is not None:
            source = self.tables.get(odq.input_store_id)
            if source is None:  # not `or`: an empty table is falsy
                source = self.windows.get(odq.input_store_id)
            if source is None and odq.input_store_id in self.aggregations:
                raise SiddhiAppCreationError(
                    "insert-into from aggregations: query the aggregation "
                    "and insert host-side instead")
            if source is None:
                raise DefinitionNotExistError(
                    f"store {odq.input_store_id!r} is not defined")
        return OnDemandCrudRuntime(odq, target, self.ctx, self.ctx.registry,
                                   source_store=source)

    def drain(self) -> None:
        """Flush staged rows (a barrier over every ingress pipeline) and
        block until every async callback has fired: the barrier of
        async_callbacks=True (with synchronous callbacks the same as
        flush())."""
        self.flush()
        if self.ctx.decoder is not None:
            self.ctx.decoder.drain()

    def heartbeat(self, now: Optional[int] = None) -> None:
        """Advance time: flush, then deliver an empty timer batch to every
        junction that feeds a query with a time-driven window, so its
        expirations fire with no data; a pattern with `within`, an absent
        position or a grouped `every ( ... ) within` steps itself. In
        playback mode a bare heartbeat() bumps the virtual clock by the
        @app:playback increment."""
        tg = self.ctx.timestamp_generator
        if now is None and tg.playback and tg.playback_increment_ms:
            t = tg.advance_idle()
        else:
            t = now if now is not None else tg.current_time()
        self.flush(t)
        for w in self.windows.values():
            if w.has_time_semantics:
                w.heartbeat(t)
        for a in self.aggregations.values():
            a._maybe_evict(t)  # retention purge rides the heartbeat clock
        for pr in self.partitions.values():
            if pr.has_time_semantics or pr._purge_idle_ms is not None:
                pr.heartbeat(t)
        seen: set[int] = set()
        for qr in self.query_runtimes.values():
            # a partition's inner queries run under its own heartbeat
            if not qr.has_time_semantics or getattr(qr, "_partitioned",
                                                    False):
                continue
            if isinstance(qr, PatternQueryRuntime):
                qr.heartbeat(t)  # pattern runtimes drive themselves
                continue
            # a join's time window also expires at probe time; the
            # heartbeat steps both of its sides' windows
            js = (qr.side_junctions() if isinstance(qr, JoinQueryRuntime)
                  else [qr.input_junction])
            for j in js:
                if id(j) not in seen:
                    seen.add(id(j))
                    j.heartbeat(t)
        # overflow counters warn from the heartbeat too
        self.collect_overflow()

    def collect_overflow(self) -> None:
        """Sweep every query's device state for capacity-overflow counters
        and record them in Statistics.record_overflow (one warning per
        counter): window-ring overwrites of live rows, key-table unresolved
        lanes (group-by, distinct pairs), HLL lanes past the group capacity,
        keyed-session key-capacity drops, pattern pending-table drops,
        full-window snapshot ring overwrites and join pair drops, in the
        queries', the named windows' and the aggregations' states. The
        counters stay on the device; one stacked readback fetches them
        all."""
        pending: dict[str, list] = {}

        def scan(label: str, obj) -> None:
            key = None
            if isinstance(obj, KeyTable):
                key, counter = "key_table_unresolved", obj.misses
            elif isinstance(obj, SlidingState):
                key, counter = "window_ring_overflow", obj.overflow
            elif isinstance(obj, KeyedSessionState):
                key, counter = "session_key_dropped", obj.dropped
            elif isinstance(obj, PatternState):
                key, counter = "pattern_pending_dropped", obj.dropped
            elif isinstance(obj, WindowedSnapshotState):
                key, counter = "snapshot_ring_overflow", obj.overflow
            elif isinstance(obj, HLLState):
                key, counter = "hll_groups_dropped", obj.dropped
            if key is not None:
                pending.setdefault(f"{label}.{key}", []).append(counter)
            if isinstance(obj, dict):
                for v in obj.values():
                    scan(label, v)
            elif hasattr(obj, "_fields"):  # NamedTuple: its fields
                for f in obj._fields:
                    scan(label, getattr(obj, f))
            elif isinstance(obj, (tuple, list)):
                for v in obj:
                    scan(label, v)
            elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                for f in dataclasses.fields(obj):  # SelectorState
                    scan(label, getattr(obj, f.name))

        for n, qr in self.query_runtimes.items():
            scan(f"query:{n}", qr.state)
            if isinstance(qr, JoinQueryRuntime) and \
                    qr._dropped_dev is not None:
                pending[f"query:{n}.join_pairs_dropped"] = [qr._dropped_dev]
        for n, w in self.windows.items():
            scan(f"window:{n}", w.state)
        for n, a in self.aggregations.items():
            scan(f"aggregation:{n}", a.state)
        if not pending:
            return
        names = list(pending)
        sums = torch.stack([torch.stack([c.to(torch.int64).reshape(())
                                         for c in pending[k]]).sum()
                            for k in names]).cpu()  # ONE readback
        for name, n in zip(names, sums.tolist()):
            self.ctx.statistics.record_overflow(name, int(n))

    def shutdown(self, flush_durable: bool = True) -> None:
        """Stop the auto-flusher, deliver what is still staged, stop every
        @Async junction's feeder and pipeline and the async decoder (after
        they have delivered everything submitted), then write the
        aggregations' durable duration tables through (`flush_durable`)
        and close them."""
        if self._flusher_stop is not None:
            self._flusher_stop.set()
            self._flusher_thread.join(timeout=5)
            self._flusher_stop = self._flusher_thread = None
        try:
            self.flush()
        finally:
            for j in self.junctions.values():
                j.stop_async()
            if self.ctx.decoder is not None:
                self.ctx.decoder.stop()
                self.ctx.decoder = None
        for a in self.aggregations.values():
            if flush_durable:
                a.flush_durable()
            a.close_durable()


def _superstep_k(app: SiddhiApp) -> int:
    """@app:superstep(k='8'): K async ingress chunks per device dispatch
    (core/superstep.py); SIDDHI_SUPERSTEP_K overrides the annotation."""
    k = 1
    ann = app.annotation("app:superstep")
    if ann is not None:
        v = ann.element("k") or ann.element()
        try:
            k = int(v) if v else 1
        except ValueError as e:
            raise SiddhiAppCreationError(
                f"@app:superstep k must be an integer, got {v!r}") from e
    env = os.environ.get("SIDDHI_SUPERSTEP_K", "").strip()
    if env:
        try:
            k = int(env)
        except ValueError:
            pass
    return max(1, k)
