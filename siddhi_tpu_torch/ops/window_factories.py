"""Window extension registrations (counterpart of
siddhi_tpu/ops/window_factories.py; this slice ports lengthBatch and the
sliding windows length, time, timeLength, delay and externalTime). The
other window names stay registered and raise "not yet ported".

Each factory receives the stream's column layout, the junction batch
capacity, the window parameters (constants evaluated; attribute references
as `Variable`s) and whether the query consumes expired events."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind, ExtensionMeta, Parameter
from ..query_api.expression import Variable
from .windows import LengthBatchWindow, SlidingWindow


@dataclass
class WindowFactory:
    make: Callable  # (layout, batch_cap, params: list, expired_on: bool) -> WindowOp


def _int_param(params, i, name):
    if len(params) <= i:
        raise SiddhiAppCreationError(f"window {name!r} needs parameter "
                                     f"{i + 1}")
    v = params[i]
    if not isinstance(v, int):
        raise SiddhiAppCreationError(
            f"{name} parameter {i + 1} must be int/time, got {v!r}")
    return v


def _make_length(layout, batch_cap, params, expired_on):
    return SlidingWindow(layout, batch_cap,
                         length=_int_param(params, 0, "length"))


def _make_length_batch(layout, batch_cap, params, expired_on):
    return LengthBatchWindow(layout, batch_cap,
                             _int_param(params, 0, "lengthBatch"),
                             expired_on=expired_on)


def _make_time(layout, batch_cap, params, expired_on):
    return SlidingWindow(layout, batch_cap,
                         time_ms=_int_param(params, 0, "time"))


def _make_time_length(layout, batch_cap, params, expired_on):
    n = _int_param(params, 1, "timeLength")
    return SlidingWindow(layout, batch_cap,
                         time_ms=_int_param(params, 0, "timeLength"),
                         length=n, capacity=n)


def _make_delay(layout, batch_cap, params, expired_on):
    return SlidingWindow(layout, batch_cap,
                         time_ms=_int_param(params, 0, "delay"),
                         is_delay=True)


def _make_external_time(layout, batch_cap, params, expired_on):
    # externalTime(tsAttr, W): the first parameter is an attribute
    if len(params) < 2 or not isinstance(params[0], Variable):
        raise SiddhiAppCreationError(
            "externalTime needs (timestampAttr, window.time)")
    return SlidingWindow(layout, batch_cap, time_ms=params[1],
                         ts_attr=params[0].attribute)


def _not_yet_ported(name: str):
    def make(layout, batch_cap, params, expired_on):
        raise SiddhiAppCreationError(
            f"window {name!r} is not yet ported to siddhi_tpu_torch")
    return make


def register_all() -> None:
    def reg(name, make, desc, params):
        GLOBAL.register(ExtensionKind.WINDOW, "", name, WindowFactory(make),
                        meta=ExtensionMeta(description=desc,
                                           parameters=tuple(params)))

    P = Parameter
    reg("length", _make_length,
        "Sliding window holding the last N events.",
        [P("window.length", ("int",), doc="number of events retained")])
    reg("lengthBatch", _make_length_batch,
        "Tumbling window emitting every N events.",
        [P("window.length", ("int",), doc="events per batch")])
    reg("time", _make_time,
        "Sliding window holding events of the last T time units.",
        [P("window.time", ("time",), doc="retention period")])
    reg("timeLength", _make_time_length,
        "Sliding window bounded by BOTH time and count.",
        [P("window.time", ("time",), doc="retention period"),
         P("window.length", ("int",), doc="max events retained")])
    reg("delay", _make_delay,
        "Emits events after a fixed delay.",
        [P("window.delay", ("time",), doc="delay period")])
    reg("externalTime", _make_external_time,
        "Sliding time window over an event-attribute clock.",
        [P("timestamp", ("attribute",), doc="the time attribute"),
         P("window.time", ("time",), doc="retention period")])
    for name in ("expression", "expressionBatch", "timeBatch", "batch",
                 "externalTimeBatch", "session", "sort", "cron", "hopping",
                 "frequent", "lossyFrequent"):
        GLOBAL.register(ExtensionKind.WINDOW, "", name,
                        WindowFactory(_not_yet_ported(name)))


register_all()
