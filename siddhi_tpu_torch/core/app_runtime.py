"""SiddhiAppRuntime (counterpart of siddhi_tpu/core/app_runtime.py, reduced
to streams, single-input queries, stream-stream joins and heartbeats). Lint, admission control,
sharding, supersteps, persistence, tables, windows, triggers, aggregations
and partitions are not yet ported; an app that declares them is refused."""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import DefinitionNotExistError, SiddhiAppCreationError
from ..extension.registry import Registry
from ..query_api import SiddhiApp
from ..query_api.execution import JoinInputStream, OutputAction, Query
from .context import (
    SiddhiAppContext,
    TimestampGenerator,
    parse_annotation_time,
)
from .join_runtime import JoinQueryRuntime, _JoinSideReceiver
from .query_runtime import FunctionQueryCallback, QueryCallback, QueryRuntime
from .stream import FunctionStreamCallback, InputHandler, StreamCallback, StreamJunction


class SiddhiAppRuntime:
    def __init__(self, app: SiddhiApp, registry: Registry,
                 device: torch.device, batch_size: int = 0,
                 group_capacity: int = 0) -> None:
        for what, defs in (("table", app.table_definitions),
                           ("window", app.window_definitions),
                           ("trigger", app.trigger_definitions),
                           ("aggregation", app.aggregation_definitions),
                           ("function", app.function_definitions),
                           ("partition", app.partitions)):
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
            group_capacity=group_capacity)
        self.junctions: dict[str, StreamJunction] = {}
        self.query_runtimes: dict[str, QueryRuntime] = {}
        self.input_handlers: dict[str, InputHandler] = {}
        for sd in app.stream_definitions.values():
            self.junctions[sd.id] = StreamJunction(sd, self.ctx)
        for i, query in enumerate(app.queries):
            self._add_query(query, f"query{i + 1}")

    def _add_query(self, query: Query, default_name: str) -> None:
        name = query.name or default_name
        if isinstance(query.input_stream, JoinInputStream):
            qr = JoinQueryRuntime(query, self.ctx, self.junctions,
                                  self.ctx.registry, name)
            # left first: with both sides on one stream, the left direction
            # probes before the right one, as in the JAX package
            qr.left.junction.subscribe(_JoinSideReceiver(qr, True))
            qr.right.junction.subscribe(_JoinSideReceiver(qr, False))
        else:
            sid = getattr(query.input_stream, "stream_id", None)
            junction = self.junctions.get(sid)
            if junction is None:
                raise DefinitionNotExistError(
                    f"stream {sid!r} is not defined")
            qr = QueryRuntime(query, self.ctx, junction, self.ctx.registry,
                              name=name)
            junction.subscribe(qr)
        self.query_runtimes[name] = qr
        out = query.output_stream
        if out.action != OutputAction.INSERT or out.is_fault:
            raise SiddhiAppCreationError(
                "only `insert into <stream>` outputs are ported to "
                "siddhi_tpu_torch")
        if out.target_id:
            target = self.junctions.get(out.target_id)
            if target is None:
                # auto-define the output stream from the select list
                target = StreamJunction(qr.output_definition, self.ctx,
                                        codec=qr.output_codec)
                self.junctions[out.target_id] = target
            qr.output_junction = target

    def start(self) -> None:
        """Nothing runs in the background in this slice; kept for the
        reference's lifecycle."""

    def get_input_handler(self, stream_id: str) -> InputHandler:
        if stream_id not in self.input_handlers:
            junction = self.junctions.get(stream_id)
            if junction is None:
                raise DefinitionNotExistError(
                    f"stream {stream_id!r} is not defined")
            self.input_handlers[stream_id] = InputHandler(junction)
        return self.input_handlers[stream_id]

    def add_callback(self, stream_id: str, callback) -> None:
        junction = self.junctions.get(stream_id)
        if junction is None:
            raise DefinitionNotExistError(
                f"stream {stream_id!r} is not defined")
        if not isinstance(callback, StreamCallback):
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
        for j in list(self.junctions.values()):
            j.flush(now)

    def heartbeat(self, now: Optional[int] = None) -> None:
        """Advance time: flush, then deliver an empty timer batch to every
        junction that feeds a query with a time-driven window, so its
        expirations fire with no data. In playback mode a bare heartbeat()
        bumps the virtual clock by the @app:playback increment."""
        tg = self.ctx.timestamp_generator
        if now is None and tg.playback and tg.playback_increment_ms:
            t = tg.advance_idle()
        else:
            t = now if now is not None else tg.current_time()
        self.flush(t)
        seen: set[int] = set()
        for qr in self.query_runtimes.values():
            if not qr.has_time_semantics:
                continue
            # a join's time window also expires at probe time; the
            # heartbeat steps both of its sides' windows
            js = (qr.side_junctions() if isinstance(qr, JoinQueryRuntime)
                  else [qr.input_junction])
            for j in js:
                if id(j) not in seen:
                    seen.add(id(j))
                    j.heartbeat(t)

    def shutdown(self) -> None:
        """Deliver what is still staged; nothing else holds resources."""
        self.flush()
