"""Per-app context (counterpart of siddhi_tpu/core/context.py, reduced to
what the port's slice needs)."""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..errors import SiddhiAppCreationError
from ..extension.registry import Registry
from . import dtypes
from .event import StringTable


_TIME_UNITS_MS = {
    "millisecond": 1, "milliseconds": 1, "ms": 1,
    "second": 1000, "seconds": 1000, "sec": 1000,
    "minute": 60_000, "minutes": 60_000, "min": 60_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "day": 86_400_000, "days": 86_400_000,
    "month": 2_592_000_000, "months": 2_592_000_000,
    "year": 31_536_000_000, "years": 31_536_000_000,
}


def parse_annotation_time(text: str) -> int:
    """Annotation time strings like '1 hour', '10 sec', '5000' -> ms."""
    parts = text.strip().lower().split()
    if len(parts) == 1:
        return int(parts[0])
    if len(parts) % 2 != 0 or any(u not in _TIME_UNITS_MS
                                  for u in parts[1::2]):
        raise SiddhiAppCreationError(f"bad time literal {text!r}")
    return sum(int(v) * _TIME_UNITS_MS[u]
               for v, u in zip(parts[::2], parts[1::2]))


class TimestampGenerator:
    """Wall-clock time by default; in playback mode the clock follows the
    largest event timestamp seen, and `advance_idle()` bumps it by the
    @app:playback increment (a heartbeat on an idle stream)."""

    def __init__(self, playback: bool = False,
                 playback_increment_ms: int = 0) -> None:
        self.playback = playback
        self.playback_increment_ms = playback_increment_ms
        self._lock = threading.Lock()
        self._last_event_ts: Optional[int] = None

    def current_time(self) -> int:
        if self.playback:
            return 0 if self._last_event_ts is None else self._last_event_ts
        return int(time.time() * 1000)

    def observe_event_time(self, ts: int) -> None:
        # producers race this check-then-set; the watermark never regresses
        with self._lock:
            if self._last_event_ts is None or ts > self._last_event_ts:
                self._last_event_ts = ts

    def advance_idle(self) -> int:
        """Playback idle bump: virtual clock += increment; the new time."""
        with self._lock:
            if self.playback and self._last_event_ts is not None:
                self._last_event_ts += self.playback_increment_ms
        return self.current_time()


@dataclass
class Statistics:
    """Per-query step latency (host clock around the step and its
    distribution), per-stream batch counts, the capacity-overflow counters
    and the bounded-ingress counters (rows an @Async junction shed, its
    deepest staging)."""

    batches: dict = field(default_factory=dict)  # stream -> batches
    query_latency_ns: dict = field(default_factory=dict)  # query -> (sum, n)
    #: capacity-overflow counters ("<runtime>.<structure>" -> lifetime rows
    #: dropped or overwritten past a fixed device capacity), filled by
    #: SiddhiAppRuntime.collect_overflow. Each counter warns once.
    overflow: dict = field(default_factory=dict)
    _overflow_warned: set = field(default_factory=set)
    #: stream -> {policy: rows} shed by a bounded @Async junction, policy
    #: one of drop.new | drop.old | block.timeout; exact by construction
    ingress_dropped: dict = field(default_factory=dict)
    queue_hwm: dict = field(default_factory=dict)  # stream -> max staged

    def track_ingress_drop(self, stream_id: str, policy: str, n: int) -> None:
        per = self.ingress_dropped.setdefault(stream_id, {})
        per[policy] = per.get(policy, 0) + n

    def track_queue_depth(self, stream_id: str, depth: int) -> None:
        if depth > self.queue_hwm.get(stream_id, 0):
            self.queue_hwm[stream_id] = depth

    def track_batch(self, stream_id: str) -> None:
        self.batches[stream_id] = self.batches.get(stream_id, 0) + 1

    def track_latency(self, query: str, ns: int) -> None:
        total, n = self.query_latency_ns.get(query, (0, 0))
        self.query_latency_ns[query] = (total + ns, n + 1)

    def record_overflow(self, name: str, n: int) -> None:
        """Register a lifetime overflow counter reading; warns ONCE per
        counter the first time it goes positive (an @OnError-style signal —
        results past this point may be missing rows)."""
        if n <= 0:
            self.overflow.pop(name, None)
            return
        self.overflow[name] = n
        if name not in self._overflow_warned:
            self._overflow_warned.add(name)
            warnings.warn(
                f"{name}: {n} rows exceeded a fixed device capacity and "
                "were dropped/overwritten — results may be missing rows; "
                "raise the relevant capacity (see Statistics.report()"
                "['overflow'])", stacklevel=3)

    def report(self) -> dict:
        """A snapshot of the counters (the overflow ones as of the last
        SiddhiAppRuntime.collect_overflow)."""
        return {"batches": dict(self.batches),
                "query_latency_ns": dict(self.query_latency_ns),
                "overflow": dict(self.overflow),
                "ingress_dropped": {s: dict(d) for s, d
                                    in self.ingress_dropped.items()},
                "backpressure": {"queue_hwm": dict(self.queue_hwm)}}


@dataclass
class SiddhiAppContext:
    name: str
    registry: Registry
    timestamp_generator: TimestampGenerator
    device: torch.device
    batch_size: int = 0  # 0 = dtypes.config.default_batch_size
    group_capacity: int = 0  # 0 = dtypes.config.default_group_capacity
    statistics: Statistics = field(default_factory=Statistics)
    #: app-global string table shared by every codec
    global_strings: StringTable = field(default_factory=StringTable)
    #: serializes device work and staging between producer threads and
    #: flush (a plain re-entrant lock)
    controller_lock: threading.RLock = field(default_factory=threading.RLock)
    #: async stream-callback decode (create_siddhi_app_runtime(...,
    #: async_callbacks=True)): the packed device-to-host readback is
    #: enqueued at delivery and decoded on worker threads, so the
    #: controller thread never waits for the copy. Opt-in because it changes
    #: visible semantics: flush() may return before callbacks ran —
    #: runtime.drain() is the barrier.
    async_callbacks: bool = False
    decoder: object = None  # stream.AsyncDecoder while started
    #: device-resident supersteps: K full ingress chunks per dispatch
    #: (@app:superstep(k=) / SIDDHI_SUPERSTEP_K; core/superstep.py)
    superstep_k: int = 1
    #: the devices of a partition's key-slot path along one axis (a tuple
    #: holding the runtime's device; None: the per-key host loop)
    mesh: Optional[tuple] = None
    #: key slots of the key-slot path; 0 = default_partition_capacity
    partition_capacity: int = 0

    @property
    def effective_batch_size(self) -> int:
        return self.batch_size or dtypes.config.default_batch_size

    @property
    def effective_group_capacity(self) -> int:
        return self.group_capacity or dtypes.config.default_group_capacity

    @property
    def effective_partition_capacity(self) -> int:
        return (self.partition_capacity
                or dtypes.config.default_partition_capacity)
