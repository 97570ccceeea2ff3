"""Query runtime: one single-input query as one step function (counterpart
of siddhi_tpu/core/query_runtime.py).

    step(state, batch, now) -> (state', out_batch)

runs filter mask -> window -> selector -> rate limiter on fixed-shape
tensors with no host synchronisation; the only readback is in
`_distribute`, where callbacks decode the output. JAX donates the state to
its jitted step; here the kernels update the state tensors in place.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

from ..errors import SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.aggregators import compact_distinct_state
from ..ops.groupby import GroupState, KeyTable
from ..ops.ratelimit import make_rate_limiter
from ..ops.selector import CompiledSelector
from ..ops.window_factories import WindowFactory
from ..ops.windows import (
    PassThroughWindow,
    WindowOp,
    make_layout,
    window_has_time_semantics,
)
from ..query_api.definition import Attribute, AttributeType, StreamDefinition
from ..query_api.execution import (
    OutputAction,
    OutputEventType,
    Query,
    SingleInputStream,
)
from ..query_api.expression import Constant, Expression, Variable
from .context import SiddhiAppContext
from .event import EventBatch, EventType, StreamCodec
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


class QueryRuntime(Receiver):
    """Runtime for a single-input-stream query."""

    def __init__(self, query: Query, ctx: SiddhiAppContext,
                 input_junction: StreamJunction, registry: Registry,
                 name: Optional[str] = None) -> None:
        in_stream = query.input_stream
        if not isinstance(in_stream, SingleInputStream):
            raise SiddhiAppCreationError(
                f"{type(in_stream).__name__} queries are not yet ported to "
                "siddhi_tpu_torch")
        h = in_stream.handlers
        if (h.pre_window_functions or h.post_window_functions
                or h.post_window_filters):
            raise SiddhiAppCreationError(
                "stream functions and post-window filters are not yet ported "
                "to siddhi_tpu_torch")
        self.query = query
        self.ctx = ctx
        self.name = name or query.name or f"query_{id(self)}"
        self.callbacks: list[QueryCallback] = []
        self.output_junction: Optional[StreamJunction] = None
        self.input_junction = input_junction

        definition = input_junction.definition
        self.frame_ref = in_stream.reference_id
        codec = input_junction.codec
        attr_types = {a.name: a.type for a in definition.attributes
                      if a.type != AttributeType.OBJECT}
        frames = {self.frame_ref: attr_types}
        if self.frame_ref != definition.id:
            frames[definition.id] = attr_types
        self.resolver = TypeResolver(
            frames, self.frame_ref,
            {self.frame_ref: codec, definition.id: codec})

        self.filters = [compile_expression(f, self.resolver, registry)
                        for f in h.filters]
        for f in self.filters:
            if f.type != AttributeType.BOOL:
                raise SiddhiAppCreationError("filter must be boolean")

        batch_cap = input_junction.batch_size
        layout = make_layout(attr_types)
        # batch windows materialise EXPIRED lanes only when the output
        # wants them
        expired_on = query.output_stream.event_type != OutputEventType.CURRENT
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

        self.selector = CompiledSelector(
            query.selector, self.resolver, registry,
            ctx.effective_group_capacity,
            select_all_attrs=list(attr_types.items()))
        self.output_definition = StreamDefinition(
            id=query.output_stream.target_id or f"{self.name}_out",
            attributes=tuple(Attribute(n, t)
                             for n, t in self.selector.out_types.items()))
        self.output_codec = StreamCodec(self.output_definition,
                                        ctx.global_strings)
        self.rate_limiter = make_rate_limiter(query.output_rate)
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
        self._last_compacted_live: dict[int, int] = {}
        #: time-driven windows need heartbeats to flush expirations
        self.has_time_semantics = window_has_time_semantics(self.window)

    def step(self, state, batch: EventBatch, now: int):
        """One micro-batch through filter -> window -> selector -> limiter."""
        wstate, sstate, rstate = state
        scope = Scope()
        scope.add_frame(self.frame_ref, batch.cols, batch.ts, batch.valid,
                        default=True)
        mask = batch.valid
        for f in self.filters:
            mask = mask & f(scope)
        batch = batch.where_valid(mask)
        wstate, chunk = self.window.step(wstate, batch, now)
        cscope = Scope()
        cscope.add_frame(self.frame_ref, chunk.cols, chunk.ts, chunk.valid,
                         default=True)
        sstate, out = self.selector.step(sstate, chunk, cscope)
        rstate, out = self.rate_limiter.step(rstate, out, now)
        return (wstate, sstate, rstate), out

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
        while a table runs hot). Each check reads a few scalars back from
        the device; the step itself never does."""
        self._batches_seen += 1
        interval = 4 if self._capacity_pressure else 256
        if (self._has_custom_aggs
                and (self._batches_seen in (1, 16, 64)
                     or self._batches_seen % interval == 0)):
            self._check_custom_agg_capacity()

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

    def _distribute(self, out: EventBatch, now: int) -> None:
        action = self.query.output_stream.action
        etype = self.query.output_stream.event_type
        if self.callbacks:
            events = out.to_host_events(self.output_codec)
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
