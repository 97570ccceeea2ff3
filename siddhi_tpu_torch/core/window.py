"""Named windows — `define window W (...) <window spec> output <type> events`
(counterpart of siddhi_tpu/core/window.py).

A named window is one window operator whose state lives on the device and
is shared by every consumer: queries `insert into W` feed its append step,
and queries `from W ...` subscribe to its output junction, which carries
the emitted chunk (CURRENT on arrival, EXPIRED on expiry, filtered by the
definition's `output ... events` clause) device to device. Joins and
on-demand queries read its live rows through `contents(state, now)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..errors import SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..ops.window_factories import WindowFactory
from ..ops.windows import (PassThroughWindow, WindowOp, make_layout,
                           window_has_time_semantics)
from ..query_api.definition import (AttributeType, StreamDefinition,
                                    WindowDefinition)
from . import dtypes
from .context import SiddhiAppContext
from .event import EventBatch, EventType, StreamCodec
from .stream import StreamJunction


class NamedWindow:
    """Runtime of one `define window`."""

    def __init__(self, definition: WindowDefinition, ctx: SiddhiAppContext,
                 registry: Registry) -> None:
        self.definition = definition
        self.ctx = ctx
        self.attr_types = {a.name: a.type for a in definition.attributes
                           if a.type != AttributeType.OBJECT}
        # the window's emission stream shares the definition's schema
        self.stream_definition = StreamDefinition(
            id=definition.id, attributes=definition.attributes,
            annotations=definition.annotations)
        self.codec = StreamCodec(self.stream_definition, ctx.global_strings)
        self.output_junction = StreamJunction(
            self.stream_definition, ctx, codec=self.codec)

        layout = make_layout(self.attr_types)
        batch_cap = ctx.effective_batch_size
        wh = definition.window
        if wh is not None:
            factory = registry.require(ExtensionKind.WINDOW, wh.namespace,
                                       wh.name)
            assert isinstance(factory, WindowFactory)
            from .query_runtime import eval_constant
            params = [eval_constant(p) for p in wh.parameters]
            registry.validate_params(ExtensionKind.WINDOW, wh.namespace,
                                     wh.name, params, what="window")
            self.window: WindowOp = factory.make(layout, batch_cap, params,
                                                 True)
        else:
            # `define window W (...)` with no spec: pass-through emission,
            # no retained contents
            self.window = PassThroughWindow(layout, batch_cap)

        self.state = self.window.init_state(ctx.device)
        out_type = (definition.output_event_type or "all").lower()
        if out_type not in ("all", "current", "expired"):
            raise SiddhiAppCreationError(
                f"window {definition.id!r}: bad output event type "
                f"{out_type!r}")
        self.output_event_type = out_type
        self.has_time_semantics = window_has_time_semantics(self.window)

    def append(self, batch: EventBatch, now: int) -> None:
        """Insert arrivals (the CURRENT lanes of `batch`) and publish the
        window's emissions downstream."""
        cap = self.ctx.effective_batch_size
        if batch.capacity < cap and not self.window.shape_polymorphic:
            # a window that bakes in its batch capacity takes narrower
            # (bucketed) inserts widened to it
            batch = batch.pad_to(cap)
        self.state, chunk = self.window.step(self.state, batch, now)
        self.output_junction.publish_batch(
            self._apply_output_event_type(chunk), now)

    def heartbeat(self, now: int) -> None:
        """Advance time with no data so time-driven expirations emit."""
        cap = self.ctx.effective_batch_size
        if self.window.shape_polymorphic:
            cap = dtypes.bucket_capacity(0, cap)  # timer batch: min bucket
        self.append(EventBatch.empty(self.stream_definition, cap,
                                     self.ctx.device), now)

    def contents(self, state, now: int):
        """The rows in the window now, as (cols, ts, valid): what a join
        side or an on-demand query reads."""
        if isinstance(self.window, PassThroughWindow):
            return self.window.contents(state, now, device=self.ctx.device)
        return self.window.contents(state, now)

    def _apply_output_event_type(self, chunk: EventBatch) -> EventBatch:
        if self.output_event_type == "current":
            keep = chunk.types == int(EventType.CURRENT)
        elif self.output_event_type == "expired":
            keep = chunk.types == int(EventType.EXPIRED)
        else:
            return chunk
        return dataclasses.replace(chunk, valid=chunk.valid & keep)


class WindowJunctionAdapter:
    """The query-output junction interface onto a named-window insert,
    renaming the query's output columns positionally onto the window
    schema (the reference's InsertIntoWindowCallback matches by
    position)."""

    def __init__(self, window: NamedWindow, out_types: dict):
        self.window = window
        self.rename: Optional[dict] = None
        out_names = list(out_types.keys())
        win_names = list(window.attr_types.keys())
        if len(out_names) != len(win_names):
            raise SiddhiAppCreationError(
                f"insert into window {window.definition.id!r}: query emits "
                f"{len(out_names)} attributes, window has {len(win_names)}")
        for on, wn in zip(out_names, win_names):
            if out_types[on] != window.attr_types[wn]:
                raise SiddhiAppCreationError(
                    f"insert into window {window.definition.id!r}: "
                    f"attribute {on!r} is {out_types[on].name}, window "
                    f"attribute {wn!r} is {window.attr_types[wn].name}")
        if out_names != win_names:
            self.rename = dict(zip(out_names, win_names))

    #: a query publishes into the window whether or not anyone reads it
    receivers = (True,)

    def publish_batch(self, batch: EventBatch, now: int) -> None:
        if self.rename:
            batch = dataclasses.replace(
                batch, cols={self.rename[k]: v
                             for k, v in batch.cols.items()})
        self.window.append(batch, now)
