"""Stream junctions, input handlers and stream callbacks (counterpart of
siddhi_tpu/core/stream.py; synchronous staging, flush and heartbeats only —
the async decoder, the wire packing, parallel ingress, WAL and breakers are
not yet ported).

`send` / `send_batch` stage host rows; a full batch or `flush()` encodes
them into a fixed-capacity columnar batch on the app's device and delivers
it to every receiver. `send_columns` encodes whole numpy columns at once.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from ..query_api.definition import StreamDefinition
from . import dtypes
from .context import SiddhiAppContext
from .event import Event, EventBatch, StreamCodec


class Receiver:
    """Junction subscriber."""

    def on_batch(self, batch: EventBatch, now: int) -> None:
        raise NotImplementedError


class StreamCallback(Receiver):
    """User-facing stream subscriber: override `receive`, or wrap a plain
    function with FunctionStreamCallback."""

    _junction: "StreamJunction" = None

    def receive(self, events: list[Event]) -> None:
        raise NotImplementedError

    def on_batch(self, batch: EventBatch, now: int) -> None:
        events = batch.to_host_events(self._junction.codec)
        if events:
            self.receive(events)


class FunctionStreamCallback(StreamCallback):
    def __init__(self, fn: Callable[[list[Event]], None]):
        self.fn = fn

    def receive(self, events: list[Event]) -> None:
        self.fn(events)


class StreamJunction:
    """Per-stream hub: staging buffers and receiver fan-out."""

    def __init__(self, definition: StreamDefinition, ctx: SiddhiAppContext,
                 codec: Optional[StreamCodec] = None) -> None:
        self.definition = definition
        self.ctx = ctx
        self.codec = codec or StreamCodec(definition, ctx.global_strings)
        self.receivers: list[Receiver] = []
        self.batch_size = ctx.effective_batch_size
        self._staged_rows: list = []
        self._staged_ts: list[int] = []

    def subscribe(self, receiver: Receiver) -> None:
        if isinstance(receiver, StreamCallback):
            receiver._junction = self
        self.receivers.append(receiver)

    # ---------------------------------------------------------------- ingest

    def send_rows(self, tss: Sequence[int], rows: Sequence) -> None:
        if not rows:
            return
        with self.ctx.controller_lock:
            self._staged_ts.extend(tss)
            self._staged_rows.extend(rows)
            full = len(self._staged_rows) >= self.batch_size
        self.ctx.timestamp_generator.observe_event_time(int(max(tss)))
        if full:
            self.flush()

    def send_column_batch(self, ts_arr: np.ndarray, cols: dict,
                          n: int) -> None:
        """Deliver encoded numpy columns, chunked to the batch capacity."""
        if n == 0:
            return
        self.ctx.timestamp_generator.observe_event_time(int(ts_arr[:n].max()))
        cap = self.batch_size
        with self.ctx.controller_lock:
            self.flush()  # staged rows first: preserve arrival order
            now = self.ctx.timestamp_generator.current_time()
            for start in range(0, n, cap):
                m = min(cap, n - start)
                self._deliver(self._batch(ts_arr[start:start + m],
                                          {k: v[start:start + m]
                                           for k, v in cols.items()}, m), now)

    def _batch(self, ts: np.ndarray, cols: dict, m: int) -> EventBatch:
        """Pad m rows to their lane bucket (timestamps padded with the last
        value, so they stay monotone) and move them to the device."""
        pcap = dtypes.bucket_capacity(m, self.batch_size)
        ts_p = np.empty(pcap, dtype=np.int64)
        ts_p[:m] = ts[:m]
        ts_p[m:] = ts[m - 1] if m else 0
        cols_p = {}
        for k, v in cols.items():
            pad = np.zeros(pcap, dtype=v.dtype)
            pad[:m] = v[:m]
            cols_p[k] = pad
        return EventBatch.from_numpy(ts_p, cols_p, m, self.ctx.device)

    def publish_batch(self, batch: EventBatch, now: int) -> None:
        """Device-side publication (query output chaining)."""
        with self.ctx.controller_lock:
            if self._staged_rows:
                self.flush()
            self._deliver(batch, now)

    def flush(self, now: Optional[int] = None) -> None:
        with self.ctx.controller_lock:
            if not self._staged_rows:
                return
            rows, tss = self._staged_rows, self._staged_ts
            self._staged_rows, self._staged_ts = [], []
            if now is None:
                now = self.ctx.timestamp_generator.current_time()
            cap = self.batch_size
            for start in range(0, len(rows), cap):
                chunk = rows[start:start + cap]
                m = len(chunk)
                cols = self.codec.rows_to_columns(chunk)
                self._deliver(self._batch(np.asarray(tss[start:start + m],
                                                     dtype=np.int64),
                                          cols, m), now)

    def heartbeat(self, now: int) -> None:
        """Advance time with no data: flush staged rows, then deliver an
        empty batch so time-window expirations fire (the reference
        Scheduler's TIMER events). The smallest lane bucket keeps idle
        heartbeats off the full-capacity kernels."""
        with self.ctx.controller_lock:
            self.flush(now)
            self._deliver(EventBatch.empty(
                self.definition, dtypes.bucket_capacity(0, self.batch_size),
                self.ctx.device), now)

    def _deliver(self, batch: EventBatch, now: int) -> None:
        self.ctx.statistics.track_batch(self.definition.id)
        for r in self.receivers:
            r.on_batch(batch, now)


class InputHandler:
    """User ingestion facade: send() stages rows; delivery happens when a
    batch is full or on runtime.flush()."""

    def __init__(self, junction: StreamJunction) -> None:
        self.junction = junction

    def send(self, data, timestamp: Optional[int] = None) -> None:
        if isinstance(data, Event):
            self.junction.send_rows([data.timestamp], [data.data])
            return
        if isinstance(data, list) and data and isinstance(data[0], Event):
            self.junction.send_rows([e.timestamp for e in data],
                                    [e.data for e in data])
            return
        ts = timestamp if timestamp is not None else \
            self.junction.ctx.timestamp_generator.current_time()
        self.junction.send_rows([ts], [tuple(data)])

    def send_batch(self, rows: Sequence[Sequence], timestamps=None) -> None:
        """Stage many rows in one call. `timestamps`: None (one arrival time
        for the whole batch), a single int, or a per-row sequence."""
        n = len(rows)
        if n == 0:
            return
        if timestamps is None or isinstance(timestamps, int):
            ts = timestamps if timestamps is not None else \
                self.junction.ctx.timestamp_generator.current_time()
            tss = [ts] * n
        else:
            if len(timestamps) != n:
                raise ValueError(
                    f"send_batch: {n} rows but {len(timestamps)} timestamps")
            tss = [int(t) for t in timestamps]
        self.junction.send_rows(tss, [tuple(r) for r in rows])

    def send_columns(self, columns: dict, timestamps=None,
                     count: Optional[int] = None) -> None:
        """Columnar ingestion: numpy arrays (one per attribute) encode
        vectorized and enter the pipeline with no per-row Python work.
        String columns take str object arrays or int32 codes."""
        j = self.junction
        n = count if count is not None else \
            min(len(v) for v in columns.values())
        if n == 0:
            return
        if timestamps is None or isinstance(timestamps, int):
            ts = timestamps if timestamps is not None else \
                j.ctx.timestamp_generator.current_time()
            ts_arr = np.full(n, ts, dtype=np.int64)
        else:
            ts_arr = np.asarray(timestamps, dtype=np.int64)
            if ts_arr.shape[0] < n:
                raise ValueError(
                    f"send_columns: {n} rows but {ts_arr.shape[0]} timestamps")
        with j.ctx.controller_lock:  # interning mutates the shared table
            cols = j.codec.encode_columns(columns, n)
            j.send_column_batch(ts_arr, cols, n)
