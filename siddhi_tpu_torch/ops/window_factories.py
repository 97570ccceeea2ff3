"""Window extension registrations (counterpart of
siddhi_tpu/ops/window_factories.py: lengthBatch, batch, timeBatch,
externalTimeBatch, the sliding windows length, time, timeLength, delay and
externalTime, session (plain and keyed), sort, expression,
expressionBatch, cron, hopping, frequent and lossyFrequent).

Each factory receives the stream's column layout, the junction batch
capacity, the window parameters (constants evaluated; attribute references
as `Variable`s) and whether the query consumes expired events."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind, ExtensionMeta, Parameter
from ..query_api.expression import Variable
from .windows import (LengthBatchWindow, PassThroughWindow, SessionWindow,
                      SlidingWindow, SortWindow, TimeBatchWindow)


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


def _make_time_batch(layout, batch_cap, params, expired_on):
    return TimeBatchWindow(layout, batch_cap,
                           _int_param(params, 0, "timeBatch"),
                           expired_on=expired_on,
                           start_time=params[1] if len(params) > 1 else None)


def _make_external_time_batch(layout, batch_cap, params, expired_on):
    if len(params) < 2 or not isinstance(params[0], Variable):
        raise SiddhiAppCreationError(
            "externalTimeBatch needs (timestampAttr, window.time "
            "[, startTime])")
    return TimeBatchWindow(layout, batch_cap, params[1],
                           expired_on=expired_on,
                           start_time=params[2] if len(params) > 2 else None,
                           ts_attr=params[0].attribute)


def _make_batch(layout, batch_cap, params, expired_on):
    # without a length the arrival chunk is the batch
    if not params:
        return PassThroughWindow(layout, batch_cap)
    return LengthBatchWindow(layout, batch_cap, params[0],
                             expired_on=expired_on)


def _make_session(layout, batch_cap, params, expired_on):
    gap = _int_param(params, 0, "session")
    if len(params) > 1:
        key = params[1]
        if not isinstance(key, Variable):
            raise SiddhiAppCreationError(
                "session key must be a stream attribute")
        from .windows_extra import KeyedSessionWindow
        return KeyedSessionWindow(layout, batch_cap, gap, key.attribute)
    return SessionWindow(layout, batch_cap, gap)


def _make_sort(layout, batch_cap, params, expired_on):
    n = _int_param(params, 0, "sort")
    keys = []
    i = 1
    while i < len(params):
        v = params[i]
        if not isinstance(v, Variable):
            raise SiddhiAppCreationError("sort() keys must be attributes")
        order = 1
        if i + 1 < len(params) and isinstance(params[i + 1], str):
            order = -1 if params[i + 1].lower() == "desc" else 1
            i += 1
        keys.append((v.attribute, order))
        i += 1
    if not keys:
        raise SiddhiAppCreationError("sort() needs at least one key attribute")
    return SortWindow(layout, batch_cap, n, keys)


def _make_cron(layout, batch_cap, params, expired_on):
    from .windows_extra import CronWindow
    if len(params) != 1 or not isinstance(params[0], str):
        raise SiddhiAppCreationError("cron window needs ('<cron expression>')")
    return CronWindow(layout, batch_cap, params[0], expired_on=expired_on)


def _make_hopping(layout, batch_cap, params, expired_on):
    from .windows_extra import HoppingWindow
    w = _int_param(params, 0, "hopping")
    h = _int_param(params, 1, "hopping")
    return HoppingWindow(layout, batch_cap, w, h)


def _frequent_keys(params, start):
    keys = []
    for p in params[start:]:
        if not isinstance(p, Variable):
            raise SiddhiAppCreationError(
                "frequent key parameters must be attributes")
        keys.append(p.attribute)
    return keys or None


def _make_frequent(layout, batch_cap, params, expired_on):
    from .windows_extra import FrequentWindow
    n = _int_param(params, 0, "frequent")
    return FrequentWindow(layout, batch_cap, n,
                          key_attrs=_frequent_keys(params, 1))


def _make_lossy_frequent(layout, batch_cap, params, expired_on):
    from .windows_extra import FrequentWindow
    if not params or not isinstance(params[0], float):
        raise SiddhiAppCreationError(
            "lossyFrequent needs (supportThreshold [, errorBound] "
            "[, attrs...])")
    support = params[0]
    has_error = len(params) > 1 and isinstance(params[1], float)
    error = params[1] if has_error else support / 10.0
    start = 2 if has_error else 1
    if not 0.0 < support < 1.0:
        raise SiddhiAppCreationError(
            f"lossyFrequent supportThreshold must be in (0, 1), got "
            f"{support}")
    if not 0.0 < error < support:
        raise SiddhiAppCreationError(
            f"lossyFrequent errorBound must be in (0, supportThreshold), "
            f"got {error}")
    n_slots = max(int(1.0 / error), 16)
    return FrequentWindow(layout, batch_cap, n_slots,
                          key_attrs=_frequent_keys(params, start),
                          support=support, error=error, lossy=True)


def _make_expression(layout, batch_cap, params, expired_on):
    """expression(condition): conditions monotone by construction (count()
    and event-timestamp spans) take the vectorized binary-search path;
    anything else the reference's exact pop loop (K13a)."""
    from .expression_general import GeneralExpressionWindow
    from .expression_window import ExpressionWindow
    if not params or not isinstance(params[0], str):
        raise SiddhiAppCreationError(
            "expression window needs a condition string, e.g. "
            "expression('count() <= 20')")
    try:
        return ExpressionWindow(layout, batch_cap, params[0])
    except SiddhiAppCreationError:
        return GeneralExpressionWindow(layout, batch_cap, params[0])


def _make_expression_batch(layout, batch_cap, params, expired_on):
    """expressionBatch('count() <= N') is exactly lengthBatch(N); every
    other condition segments greedily with one check per arrival (K13a)."""
    from ..compiler import parse_expression
    from .expression_general import GeneralExpressionBatchWindow
    from .expression_window import plan_expression
    if not params or not isinstance(params[0], str):
        raise SiddhiAppCreationError(
            "expressionBatch window needs a condition string")
    include_trigger = False
    if len(params) > 1:
        if isinstance(params[1], bool):
            include_trigger = params[1]
        else:
            raise SiddhiAppCreationError(
                "expressionBatch second parameter (includeTriggeringEvent) "
                "must be a constant bool")
    if len(params) > 2:
        raise SiddhiAppCreationError(
            "expressionBatch stream-input-events mode (3rd parameter) is "
            "not supported on this engine")
    try:
        conjuncts = plan_expression(parse_expression(params[0]))
    except SiddhiAppCreationError:
        conjuncts = None
    if (conjuncts is not None and len(conjuncts) == 1
            and conjuncts[0].kind == "count" and not include_trigger):
        c = conjuncts[0]
        n = int(c.limit) - (1 if c.strict else 0)
        if n < 1:
            raise SiddhiAppCreationError(
                "expressionBatch count bound admits no events")
        return LengthBatchWindow(layout, batch_cap, n, expired_on=expired_on)
    return GeneralExpressionBatchWindow(layout, batch_cap, params[0],
                                        include_trigger=include_trigger)


def register_all() -> None:
    def reg(name, make, desc, params, repeat_last=False):
        GLOBAL.register(ExtensionKind.WINDOW, "", name, WindowFactory(make),
                        meta=ExtensionMeta(description=desc,
                                           parameters=tuple(params),
                                           repeat_last=repeat_last))

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
    reg("timeBatch", _make_time_batch,
        "Tumbling window flushing every T time units.",
        [P("window.time", ("time",), doc="batch period"),
         P("start.time", ("int", "time"), optional=True, default=0,
           doc="bucket epoch offset")])
    reg("timeLength", _make_time_length,
        "Sliding window bounded by BOTH time and count.",
        [P("window.time", ("time",), doc="retention period"),
         P("window.length", ("int",), doc="max events retained")])
    reg("delay", _make_delay,
        "Emits events after a fixed delay.",
        [P("window.delay", ("time",), doc="delay period")])
    reg("batch", _make_batch,
        "Chunk-boundary tumbling window.",
        [P("window.length", ("int",), optional=True,
           doc="events per batch (default: the arrival chunk)")])
    reg("externalTime", _make_external_time,
        "Sliding time window over an event-attribute clock.",
        [P("timestamp", ("attribute",), doc="the time attribute"),
         P("window.time", ("time",), doc="retention period")])
    reg("externalTimeBatch", _make_external_time_batch,
        "Tumbling time window over an event-attribute clock.",
        [P("timestamp", ("attribute",), doc="the time attribute"),
         P("window.time", ("time",), doc="batch period"),
         P("start.time", ("int", "time"), optional=True,
           doc="first bucket start"),
         P("timeout", ("time",), optional=True,
           doc="flush timeout past the bucket end")])
    reg("session", _make_session,
        "Session window keyed by a gap of inactivity.",
        [P("window.session", ("time",), doc="session gap"),
         P("window.key", ("attribute",), optional=True,
           doc="per-key sessions"),
         P("window.allowedlatency", ("time",), optional=True,
           doc="late-arrival grace period")])
    reg("sort", _make_sort,
        "Keeps the top-N events by sort order.",
        [P("window.length", ("int",), doc="events retained"),
         P("attribute", ("attribute", "string"), optional=True,
           doc="sort key(s), each optionally followed by 'asc'/'desc'")],
        repeat_last=True)
    reg("expression", _make_expression,
        "Sliding window retaining events while the expression holds.",
        [P("expression", ("string", "bool"),
           doc="retain condition over the window contents")])
    reg("expressionBatch", _make_expression_batch,
        "Tumbling window flushing when the expression turns false.",
        [P("expression", ("string", "bool"),
           doc="retain condition; flush on violation"),
         P("include.triggering.event", ("bool",), optional=True,
           default=False,
           doc="start the next batch with the violating arrival"),
         P("stream.current.event", ("bool",), optional=True, default=False,
           doc="reference stream-mode flag (rejected with guidance)")])
    reg("cron", _make_cron,
        "Tumbling window flushing on a cron schedule.",
        [P("cron.expression", ("string",), doc="quartz-layout cron")])
    reg("hopping", _make_hopping,
        "Hopping time window (period, hop).",
        [P("window.time", ("time",), doc="window span"),
         P("hop.time", ("time",), doc="hop step")])
    reg("frequent", _make_frequent,
        "Retains the most frequent event variants (Misra-Gries).",
        [P("event.count", ("int",), doc="variants tracked"),
         P("attribute", ("attribute",), optional=True,
           doc="key attributes (default: all)")],
        repeat_last=True)
    reg("lossyFrequent", _make_lossy_frequent,
        "Lossy-counting frequent-variant window.",
        [P("support.threshold", ("double",), doc="min relative frequency"),
         # position 2 is the error bound OR already an attribute (the
         # factory tells which)
         P("error.bound", ("double", "attribute"), optional=True,
           doc="counting error bound, or the first key attribute"),
         P("attribute", ("attribute",), optional=True,
           doc="key attributes (default: all)")],
        repeat_last=True)

register_all()
