"""Per-app context (counterpart of siddhi_tpu/core/context.py, reduced to
what the port's slice needs)."""

from __future__ import annotations

import threading
import time
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
    distribution) and per-stream batch counts."""

    batches: dict = field(default_factory=dict)  # stream -> batches
    query_latency_ns: dict = field(default_factory=dict)  # query -> (sum, n)

    def track_batch(self, stream_id: str) -> None:
        self.batches[stream_id] = self.batches.get(stream_id, 0) + 1

    def track_latency(self, query: str, ns: int) -> None:
        total, n = self.query_latency_ns.get(query, (0, 0))
        self.query_latency_ns[query] = (total + ns, n + 1)


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

    @property
    def effective_batch_size(self) -> int:
        return self.batch_size or dtypes.config.default_batch_size

    @property
    def effective_group_capacity(self) -> int:
        return self.group_capacity or dtypes.config.default_group_capacity
