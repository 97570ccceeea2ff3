"""Query runtime: one single-input query as one step function (counterpart
of siddhi_tpu/core/query_runtime.py).

    step(state, batch, now) -> (state', out_batch)

runs filter mask -> stream functions -> window -> stream functions ->
post-window filters -> selector -> rate limiter on fixed-shape
tensors with no host synchronisation; the only readback is in
`_distribute`, where callbacks decode the output and a table output makes
its one read. JAX donates the state to its jitted step; here the kernels
update the state tensors in place. Tables that `in` conditions probe
enter each step as arguments (their states and sorted indexes), so a step
sees their contents as of that batch.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
import warnings
from typing import Optional

import numpy as np

import torch

from ..errors import SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.aggregators import compact_distinct_state
from ..ops.extrema import (grouped_sliding_extrema_lanes,
                           sliding_extrema_lanes)
from ..ops.groupby import GroupState, KeyTable
from ..ops.expression_window import ExpressionWindow
from ..ops.ratelimit import (ContentsSnapshotLimiter,
                             GroupedSnapshotLimiter, make_rate_limiter)
from ..ops.selector import CompiledSelector
from ..ops.stream_functions import StreamFunctionFactory
from ..ops.window_factories import WindowFactory
from ..ops.windows import (
    LengthBatchWindow,
    PassThroughWindow,
    SlidingWindow,
    TimeBatchWindow,
    WindowOp,
    _unpack_rows,
    make_layout,
    window_has_time_semantics,
)
from ..query_api.definition import Attribute, AttributeType, StreamDefinition
from ..query_api.execution import (
    OutputAction,
    OutputEventType,
    OutputRateType,
    Query,
    SingleInputStream,
)
from ..query_api.expression import (AttributeFunction, Compare, CompareOp,
                                    Constant, Expression, In, Variable)
from . import dtypes
from .context import SiddhiAppContext
from .event import Event, EventBatch, EventType, StreamCodec
from .stream import Receiver, StreamJunction


class QueryCallback:
    """Receives (timestamp, inEvents, removeEvents) per emission."""

    def receive(self, timestamp: int, in_events, remove_events) -> None:
        raise NotImplementedError


class FunctionQueryCallback(QueryCallback):
    def __init__(self, fn):
        self.fn = fn

    def receive(self, timestamp: int, in_events, remove_events) -> None:
        self.fn(timestamp, in_events, remove_events)


def eval_constant(expr: Expression):
    """Evaluate a compile-time-constant window parameter (sizes, periods).
    Variables pass through as AST nodes: some windows take attribute
    references (externalTime's timestamp attribute)."""
    if isinstance(expr, Constant):
        return expr.value
    if isinstance(expr, Variable):
        return expr
    raise SiddhiAppCreationError(f"expected a constant parameter, got {expr!r}")


def _selects_aggregates(selector, registry: Registry) -> bool:
    """True if any select item calls an aggregator: the detection
    CompiledSelector performs, needed before the window is built (a
    full-window snapshot changes the window's expired-lane emission)."""
    from ..ops.aggregators import AggregatorFactory

    def walk(e) -> bool:
        if isinstance(e, AttributeFunction):
            f = registry.lookup(ExtensionKind.AGGREGATOR, e.namespace, e.name)
            if isinstance(f, AggregatorFactory):
                return True
        for a in ("left", "right", "expression"):
            sub = getattr(e, a, None)
            if isinstance(sub, Expression) and walk(sub):
                return True
        return any(isinstance(p, Expression) and walk(p)
                   for p in getattr(e, "parameters", ()) or ())

    return any(walk(a.expression) for a in selector.attributes)


class QueryRuntime(Receiver):
    """Runtime for a single-input-stream query."""

    def __init__(self, query: Query, ctx: SiddhiAppContext,
                 input_junction: StreamJunction, registry: Registry,
                 name: Optional[str] = None,
                 tables: Optional[dict] = None) -> None:
        in_stream = query.input_stream
        if not isinstance(in_stream, SingleInputStream):
            raise SiddhiAppCreationError(
                f"{type(in_stream).__name__} queries are not yet ported to "
                "siddhi_tpu_torch")
        h = in_stream.handlers
        self.query = query
        self.ctx = ctx
        self.name = name or query.name or f"query_{id(self)}"
        self.callbacks: list[QueryCallback] = []
        self.output_junction: Optional[StreamJunction] = None
        #: set by the app runtime for delete / update / update-or-insert
        self.table_executor = None
        self.input_junction = input_junction
        self.tables = tables or {}
        #: tables that `in` conditions probe: their states are step inputs
        self.dep_tables = sorted(tid for tid in _collect_in_sources(query)
                                 if tid in self.tables)
        #: of those, the ones probed by an index-eligible equality: only
        #: these pay the lazy sorted-index rebuild after a mutation
        self._index_tables = _collect_eq_probe_tables(query, self.tables)

        definition = input_junction.definition
        self.frame_ref = in_stream.reference_id
        codec = input_junction.codec
        attr_types = {a.name: a.type for a in definition.attributes
                      if a.type != AttributeType.OBJECT}
        frames = {self.frame_ref: attr_types}
        if self.frame_ref != definition.id:
            frames[definition.id] = attr_types
        codecs = {self.frame_ref: codec, definition.id: codec}
        # `in T` conditions name table attributes (T.attr)
        for tid in self.dep_tables:
            frames[tid] = dict(self.tables[tid].attr_types)
            codecs[tid] = self.tables[tid].codec
        # unionSet-projection provenance: the upstream output's markers and
        # the tables' markers set at wiring time
        set_projections = {}
        sp = {a.name for a in definition.attributes
              if getattr(a, "set_projection", False)}
        if sp:
            set_projections[self.frame_ref] = sp
            set_projections[definition.id] = sp
        for tid in self.dep_tables:
            tsp = getattr(self.tables[tid], "set_projection_attrs", None)
            if tsp:
                set_projections[tid] = set(tsp)
        self.resolver = TypeResolver(frames, self.frame_ref, codecs,
                                     set_projections)

        self.filters = [compile_expression(f, self.resolver, registry)
                        for f in h.filters]
        for f in self.filters:
            if f.type != AttributeType.BOOL:
                raise SiddhiAppCreationError("filter must be boolean")

        # stream functions (reference: StreamFunctionProcessor SPI) append
        # computed columns to the frame: later handlers and the selector
        # see the extended schema. attr_types is the dict the resolver
        # reads, so extending it extends name resolution too.
        self.pre_window_fns = self._compile_stream_fns(
            h.pre_window_functions, attr_types, registry)
        self.post_window_fns = self._compile_stream_fns(
            h.post_window_functions, attr_types, registry)
        self.post_filters = [compile_expression(f, self.resolver, registry)
                             for f in h.post_window_filters]

        batch_cap = input_junction.batch_size
        # the window's layout holds the stream's columns and the pre-window
        # functions' ones
        layout = make_layout({a.name: a.type for a in definition.attributes
                              if a.type != AttributeType.OBJECT})
        for spec, _ in self.pre_window_fns:
            for n, t in spec.new_attrs:
                layout[n] = dtypes.device_dtype(t)
                layout.attr_types[n] = t
        # batch windows materialise EXPIRED lanes only when the output
        # wants them, or when a full-window snapshot pops its ring on them
        # (non-aggregated `output snapshot`; the same flag later picks the
        # limiter, so the two decisions cannot diverge)
        expired_on = query.output_stream.event_type != OutputEventType.CURRENT
        self._selects_aggs = _selects_aggregates(query.selector, registry)
        self._snapshot_full_window = (
            query.output_rate is not None
            and query.output_rate.type == OutputRateType.SNAPSHOT
            and not self._selects_aggs)
        if self._snapshot_full_window:
            expired_on = True
        if h.window is not None:
            wh = h.window
            factory = registry.require(ExtensionKind.WINDOW, wh.namespace,
                                       wh.name)
            assert isinstance(factory, WindowFactory)
            params = [eval_constant(p) for p in wh.parameters]
            registry.validate_params(ExtensionKind.WINDOW, wh.namespace,
                                     wh.name, params, what="window")
            self.window: WindowOp = factory.make(layout, batch_cap, params,
                                                 expired_on)
        else:
            self.window = PassThroughWindow(layout, batch_cap)
        #: min/max over a FIFO sliding window (the expression windows share
        #: its state and FIFO suffix) are range queries over its arrival
        #: order (K8); other windows keep the monotone scans
        self.is_sliding_window = h.window is not None and isinstance(
            self.window, (SlidingWindow, ExpressionWindow))

        select_all = [(a.name, a.type) for a in definition.attributes
                      if a.type != AttributeType.OBJECT]
        for spec, _ in (*self.pre_window_fns, *self.post_window_fns):
            for n, t in spec.new_attrs:
                if n not in dict(select_all):
                    select_all.append((n, t))
        self.selector = CompiledSelector(
            query.selector, self.resolver, registry,
            ctx.effective_group_capacity,
            select_all_attrs=select_all,
            sliding_window=self.is_sliding_window)
        if self.selector.extrema_plan:
            # the range-query extrema path reads WINDOW contents: shapes
            # where window membership diverges from what the aggregator
            # may see are refused
            if self.post_filters:
                raise SiddhiAppCreationError(
                    "min()/max() over a sliding window cannot combine with a "
                    "post-window filter (filtered rows remain in the "
                    "window); filter before the window instead")
            if getattr(self.window, "is_delay", False):
                raise SiddhiAppCreationError(
                    "min()/max() over #window.delay is not supported "
                    "(delay re-emits expired lanes as arrivals)")
        self.output_definition = output_definition(
            query.output_stream.target_id or f"{self.name}_out",
            self.selector)
        self.output_codec = StreamCodec(self.output_definition,
                                        ctx.global_strings)
        self.rate_limiter = self._make_rate_limiter(query, ctx)
        self._batch_cap = batch_cap
        dev = ctx.device
        self.state = (self.window.init_state(dev),
                      self.selector.init_state(dev),
                      self.rate_limiter.init_state(dev))
        self._has_custom_aggs = any(
            spec.custom_scan is not None
            for _, spec, _ in self.selector.agg_specs)
        self._batches_seen = 0
        self._capacity_warned = False
        self._capacity_pressure = False
        self._snapshot_warned = False
        self._last_compacted_live: dict[int, int] = {}
        #: time-driven windows and rates need heartbeats to flush
        self.has_time_semantics = (window_has_time_semantics(self.window)
                                   or self.rate_limiter.has_time_semantics)

    def _make_rate_limiter(self, query: Query, ctx: SiddhiAppContext):
        """The output rate limiter: a full-window snapshot over a FIFO
        window keeps a ring of the projected rows, over a findable non-FIFO
        window it re-projects the window's contents."""
        out_layout = {n: dtypes.device_dtype(t)
                      for n, t in self.selector.out_types.items()
                      if t != AttributeType.OBJECT}
        fifo = isinstance(self.window, (SlidingWindow, LengthBatchWindow,
                                        TimeBatchWindow))
        findable = (getattr(type(self.window), "contents", None) is not None
                    and not isinstance(self.window, PassThroughWindow))
        limiter = make_rate_limiter(
            query.output_rate, out_layout, self.window.chunk_width,
            grouped=bool(query.selector.group_by),
            group_capacity=ctx.effective_group_capacity,
            fifo_window=fifo and self._snapshot_full_window,
            has_aggregates=self._selects_aggs,
            window_capacity=getattr(self.window, "C", 0),
            contents_window=findable and self._snapshot_full_window)
        if isinstance(limiter, GroupedSnapshotLimiter):
            self.selector.expose_group_slot = True
        if isinstance(limiter, ContentsSnapshotLimiter):
            if self.post_window_fns or self.post_filters:
                raise SiddhiAppCreationError(
                    "`output snapshot` over a non-FIFO window cannot combine "
                    "with post-window functions/filters (snapshots re-project "
                    "the raw window contents); apply them before the window")
            sel = query.selector
            if sel.order_by or sel.limit is not None \
                    or sel.offset is not None:
                raise SiddhiAppCreationError(
                    "`output snapshot` over a non-FIFO window cannot combine "
                    "with order by / limit / offset (snapshots re-emit the "
                    "whole live window set)")
        return limiter

    def _compile_stream_fns(self, handlers, attr_types: dict,
                            registry: Registry) -> list:
        out = []
        for h in handlers:
            factory = registry.require(ExtensionKind.STREAM_FUNCTION,
                                       h.namespace, h.name)
            assert isinstance(factory, StreamFunctionFactory)
            arg_ex = [compile_expression(p, self.resolver, registry)
                      for p in h.parameters]
            spec = factory.make(tuple(a.type for a in arg_ex))
            for n, t in spec.new_attrs:
                attr_types[n] = t
            out.append((spec, arg_ex))
        return out

    def _apply_fns(self, fns, batch: EventBatch, scope: Scope):
        """Append each stream function's columns (cast to their declared
        types) and re-register the frame."""
        for spec, arg_ex in fns:
            new_cols = spec.apply(*[a(scope) for a in arg_ex])
            declared = dict(spec.new_attrs)
            batch = dataclasses.replace(batch, cols={
                **batch.cols,
                **{n: c.to(dtypes.device_dtype(declared[n]))
                   for n, c in new_cols.items()}})
            scope.add_frame(self.frame_ref, batch.cols, batch.ts,
                            batch.valid, default=True)
        return batch

    def _table_states(self) -> dict:
        """tid -> (state, sorted indexes) of the tables `in` probes."""
        return {tid: (self.tables[tid].state,
                      self.tables[tid].probe_indexes()
                      if tid in self._index_tables else {})
                for tid in self.dep_tables}

    def step(self, state, batch: EventBatch, now: int):
        """One micro-batch through filter -> stream functions -> window ->
        stream functions -> post-window filters -> selector -> limiter."""
        wstate, sstate, rstate = state
        scope = Scope()
        scope.add_frame(self.frame_ref, batch.cols, batch.ts, batch.valid,
                        default=True)
        scope.extras["now"] = now
        for tid, (tstate, tidx) in self._table_states().items():
            scope.extras[f"table:{tid}"] = tstate
            scope.extras[f"tableidx:{tid}"] = tidx
            scope.extras[f"in:{tid}"] = self.tables[tid].contains_probe
        mask = batch.valid
        for f in self.filters:
            mask = mask & f(scope)
        batch = batch.where_valid(mask)
        if self.pre_window_fns:
            scope.add_frame(self.frame_ref, batch.cols, batch.ts,
                            batch.valid, default=True)
            batch = self._apply_fns(self.pre_window_fns, batch, scope)
        ring_side = (self._extrema_ring_side(wstate)
                     if self.selector.extrema_plan else None)
        wstate_pre = wstate
        wstate, chunk = self.window.step(wstate, batch, now)
        cscope = Scope()
        cscope.add_frame(self.frame_ref, chunk.cols, chunk.ts, chunk.valid,
                         default=True)
        cscope.extras = dict(scope.extras)
        chunk = self._apply_fns(self.post_window_fns, chunk, cscope)
        for f in self.post_filters:
            # post-window filters drop CURRENT lanes only
            chunk = chunk.where_valid(
                f(cscope) | (chunk.types != int(EventType.CURRENT)))
        if ring_side is not None:
            self._extrema_lanes(ring_side, wstate_pre, chunk, cscope)
        sstate, out = self.selector.step(sstate, chunk, cscope)
        if getattr(self.rate_limiter, "needs_window_contents", False):
            rstate, out = self.rate_limiter.step_contents(
                rstate, self._projected_contents(wstate, now), now)
        else:
            rstate, out = self.rate_limiter.step(rstate, out, now)
        return (wstate, sstate, rstate), out

    def _projected_contents(self, wstate, now) -> EventBatch:
        """A non-FIFO snapshot's rows: the window's live contents after the
        step (so this watermark's evictions apply) through the select list
        and HAVING; ts keeps each row's arrival instant."""
        w_cols, w_ts, w_live = self.window.contents(wstate, now)
        s2 = Scope()
        s2.add_frame(self.frame_ref, w_cols, w_ts, w_live, default=True)
        s2.extras["now"] = now
        proj = {name: torch.broadcast_to(ce(s2), w_ts.shape).contiguous()
                for name, ce in self.selector.out_exprs}
        if self.selector.having is not None:
            h2 = Scope()
            h2.add_frame(self.frame_ref, w_cols, w_ts, w_live)
            h2.add_frame("__out__", proj, w_ts, w_live, default=True)
            h2.extras["now"] = now
            w_live = w_live & self.selector.having(h2)
        return EventBatch(ts=w_ts, cols=proj, valid=w_live,
                          types=torch.zeros(w_ts.shape, dtype=torch.int8,
                                            device=w_ts.device))

    def _extrema_ring_side(self, wstate_pre):
        """The extrema arguments (and group hashes) over the PRE-step ring
        rows, taken before the window step: on the card the step appends to
        the ring in place, and 4-byte columns unpack as views of it."""
        ring_cols, ring_ts = _unpack_rows(wstate_pre.ring, self.window.layout)
        rscope = Scope()
        rscope.add_frame(self.frame_ref, ring_cols, ring_ts,
                         torch.ones(ring_ts.shape, dtype=torch.bool,
                                    device=ring_ts.device), default=True)
        ghash = self.selector.extrema_group_hash
        vals = [args[0](rscope).clone()
                for _, _, args in self.selector.extrema_plan]
        return vals, (ghash(rscope) if ghash is not None else None)

    def _extrema_lanes(self, ring_side, wstate_pre, chunk, cscope) -> None:
        """Sliding min/max per chunk lane (K8), handed to the selector as
        extras["extrema:<slot>"]."""
        ring_vals, ring_gkey = ring_side
        ghash = self.selector.extrema_group_hash
        cur_gkey = ghash(cscope) if ghash is not None else None
        for (slot, op, args), rv in zip(self.selector.extrema_plan,
                                        ring_vals):
            cur = args[0](cscope)
            if cur_gkey is not None:
                v = grouped_sliding_extrema_lanes(
                    op, rv, ring_gkey, wstate_pre.expired,
                    wstate_pre.appended, chunk, cur, cur_gkey)
            else:
                v = sliding_extrema_lanes(op, rv, wstate_pre.expired,
                                          wstate_pre.appended, chunk, cur)
            cscope.extras[f"extrema:{slot}"] = v

    def on_batch(self, batch: EventBatch, now: int) -> None:
        t0 = time.perf_counter_ns()
        if batch.capacity < self._batch_cap and \
                not self.window.shape_polymorphic:
            batch = batch.pad_to(self._batch_cap)
        self.state, out = self.step(self.state, batch, now)
        self._distribute(out, now)
        self.ctx.statistics.track_latency(self.name,
                                          time.perf_counter_ns() - t0)
        self._post_step_maintenance()

    def _post_step_maintenance(self) -> None:
        """Per-batch housekeeping after the step: the custom-aggregate
        compaction cadence (batches 1, 16, 64, then every 256, or every 4
        while a table runs hot) and the one-shot snapshot-overflow warning
        (every 256 batches). Each check reads a few scalars back from the
        device; the step itself never does."""
        self._batches_seen += 1
        interval = 4 if self._capacity_pressure else 256
        if (self._has_custom_aggs
                and (self._batches_seen in (1, 16, 64)
                     or self._batches_seen % interval == 0)):
            self._check_custom_agg_capacity()
        if (not self._snapshot_warned and self._batches_seen % 256 == 0
                and hasattr(self.state[2], "overflow")):
            n = int(self.state[2].overflow)
            if n > 0:
                warnings.warn(
                    f"query {self.name!r}: {n} output lanes exceeded "
                    "snapshot_group_capacity and are missing from periodic "
                    "snapshots — raise config.snapshot_group_capacity",
                    stacklevel=2)
                self._snapshot_warned = True

    def _check_custom_agg_capacity(self) -> None:
        """distinctCount's (group, value) pair table only grows inside a
        step. Past 85% occupancy (or past 50% with 20% of the capacity new
        since the last rebuild) the monitor compacts it to its live pairs
        (ops/aggregators.py compact_distinct_state) and warns only if the
        live pairs alone still exceed 85%."""
        pressure = False
        for gi, g in enumerate(self.state[1].groups):
            if not (isinstance(g, tuple) and g):
                continue
            if isinstance(g[0], KeyTable):
                kt = g[0]
                cap = kt.keys.shape[0] // 2  # hash array is 2x id capacity
                count = int(kt.count)
                pressure = pressure or count > int(0.5 * cap)
                grown = count - self._last_compacted_live.get(gi, 0)
                if (count > int(0.85 * cap)
                        or (count > int(0.5 * cap)
                            and grown > int(0.2 * cap))):
                    sstate = self.state[1]
                    new_g = compact_distinct_state(g, int(sstate.epoch))
                    groups = list(sstate.groups)
                    groups[gi] = new_g
                    self.state = (self.state[0],
                                  dataclasses.replace(sstate, groups=groups),
                                  self.state[2])
                    live = int(new_g[0].count)
                    self._last_compacted_live[gi] = live
                    if live > int(0.85 * cap) and not self._capacity_warned:
                        warnings.warn(
                            f"query {self.name!r}: distinctCount pair table "
                            f"still at {live}/{cap} live (group,value) pairs "
                            "after compaction; counts will corrupt past "
                            "capacity — raise group_capacity", stacklevel=2)
                        self._capacity_warned = True
                elif int(kt.misses) > 0 and not self._capacity_warned:
                    warnings.warn(
                        f"query {self.name!r}: {int(kt.misses)} key lookups "
                        "could not be placed and their events were dropped "
                        "from the aggregate — raise group_capacity",
                        stacklevel=2)
                    self._capacity_warned = True
            elif isinstance(g[0], GroupState) and len(g) == 2:
                # string-code fast path: pair table indexed by interning code
                cap = g[0].values.shape[0]
                n_codes = len(self.ctx.global_strings)
                if n_codes > int(0.85 * cap) and not self._capacity_warned:
                    warnings.warn(
                        f"query {self.name!r}: distinctCount code table at "
                        f"{n_codes}/{cap} interned strings; codes past "
                        "capacity are dropped from the count — raise "
                        "group_capacity", stacklevel=2)
                    self._capacity_warned = True
        self._capacity_pressure = pressure

    def _selector_state(self):
        """The selector's part of this runtime's state."""
        return self.state[1]

    def _distribute(self, out: EventBatch, now: int) -> None:
        action = self.query.output_stream.action
        etype = self.query.output_stream.event_type
        uuid_slots = self.selector.host_uuid_slots
        forwards = (self.output_junction is not None
                    or self.table_executor is not None)
        if uuid_slots and forwards:
            # a fresh uuid4 per emitted lane, interned into the string
            # table's bounded transient ring: downstream queries, tables
            # and callbacks all see the same value
            out = self._intern_uuid_columns(out)
        if self.callbacks:
            events = out.to_host_events(self.output_codec)
            set_slots = self.selector.host_set_slots
            if set_slots and events:
                # raw unionSet: the live value set, materialised once for
                # the batch's events
                names = [a.name for a in self.output_definition.attributes]
                subs = [(names.index(n), self.selector.union_set_values(
                    self._selector_state(), n, self.ctx.global_strings))
                    for n in set_slots]
                events = [_with_values(e, subs) for e in events]
            if uuid_slots and not forwards and events:
                # callback-only output: fresh uuids, nothing interned
                names = [a.name for a in self.output_definition.attributes]
                idxs = [names.index(u) for u in uuid_slots]
                events = [_with_values(e, [(i, str(uuid.uuid4()))
                                           for i in idxs])
                          for e in events]
            in_events = [e for e in events if not e.is_expired] or None
            remove_events = ([e for e in events if e.is_expired] or None
                             if etype != OutputEventType.CURRENT else None)
            if etype == OutputEventType.EXPIRED:
                in_events = None
            if in_events or remove_events:
                for cb in self.callbacks:
                    cb.receive(now, in_events, remove_events)
        if (action == OutputAction.INSERT and self.output_junction is not None
                and self.output_junction.receivers):
            self.output_junction.publish_batch(
                _select_event_type(out, etype), now)
        elif (action in (OutputAction.DELETE, OutputAction.UPDATE,
                         OutputAction.UPDATE_OR_INSERT)
              and self.table_executor is not None):
            self.table_executor.apply(_select_event_type(out, etype))

    def _intern_uuid_columns(self, out: EventBatch) -> EventBatch:
        valid = out.valid.cpu().numpy()
        cols = dict(out.cols)
        for slot in self.selector.host_uuid_slots:
            tbl = self.output_codec.string_tables[slot]
            codes = np.zeros(out.capacity, np.int32)
            for i in np.nonzero(valid)[0]:
                codes[i] = tbl.encode_transient(str(uuid.uuid4()))
            cols[slot] = torch.from_numpy(codes).to(out.valid.device)
        return dataclasses.replace(out, cols=cols)

    def add_callback(self, cb: QueryCallback) -> None:
        self.callbacks.append(cb)


def _select_event_type(out: EventBatch, etype: OutputEventType) -> EventBatch:
    if etype == OutputEventType.CURRENT:
        keep = out.types == int(EventType.CURRENT)
    elif etype == OutputEventType.EXPIRED:
        keep = out.types == int(EventType.EXPIRED)
    else:
        keep = ((out.types == int(EventType.CURRENT))
                | (out.types == int(EventType.EXPIRED)))
    # forwarded events enter the next stream as fresh CURRENT arrivals
    return dataclasses.replace(out, valid=out.valid & keep,
                               types=out.types.new_zeros(out.types.shape))


def output_definition(stream_id: str, selector) -> StreamDefinition:
    """A query's output schema; a raw unionSet output carries the
    set-size-projection marker that sizeOfSet reads downstream."""
    return StreamDefinition(id=stream_id, attributes=tuple(
        Attribute(n, t, set_projection=n in selector.host_set_slots)
        for n, t in selector.out_types.items()))


def _with_values(e: Event, subs) -> Event:
    """`e` with data[i] = v for each (i, v) of subs."""
    data = list(e.data)
    for i, v in subs:
        data[i] = v
    return Event(e.timestamp, tuple(data), is_expired=e.is_expired)


def _walk(node, visit) -> None:
    """Visit every expression node below `node`; `visit` returns True to
    stop the descent at a node."""
    if node is None or not isinstance(node, Expression):
        return
    if visit(node):
        return
    for attr in ("left", "right", "expression"):
        sub = getattr(node, attr, None)
        if isinstance(sub, Expression):
            _walk(sub, visit)
    for p in getattr(node, "parameters", ()) or ():
        _walk(p, visit)


def _collect_in_sources(query: Query) -> set:
    """Table ids named by `in T` conditions anywhere in the query."""
    found: set = set()

    def visit(node):
        if isinstance(node, In):
            found.add(node.source_id)
            _walk(node.expression, visit)
            return True
        return False

    h = query.input_stream.handlers
    for f in (*getattr(h, "filters", ()),
              *getattr(h, "post_window_filters", ())):
        _walk(f, visit)
    for a in query.selector.attributes:
        _walk(a.expression, visit)
    _walk(query.selector.having, visit)
    return found


def _collect_eq_probe_tables(query: Query, tables: dict) -> set:
    """Tables probed by a single equality `in` condition on an indexable
    attribute: the only ones whose sorted indexes a step reads."""
    found: set = set()

    def visit(node):
        if isinstance(node, In):
            e = node.expression
            t = tables.get(node.source_id)
            if (t is not None and isinstance(e, Compare)
                    and e.op == CompareOp.EQUAL
                    and hasattr(t, "indexable_eq_attrs")):
                for side in (e.left, e.right):
                    if (isinstance(side, Variable)
                            and side.stream_id == node.source_id
                            and side.attribute in t.indexable_eq_attrs()):
                        found.add(node.source_id)
            _walk(e, visit)
            return True
        return False

    h = query.input_stream.handlers
    for f in (*h.filters, *h.post_window_filters):
        _walk(f, visit)
    _walk(query.selector.having, visit)
    return found
