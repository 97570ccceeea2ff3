"""Stream junctions, input handlers, stream callbacks and the async
decoder (counterpart of siddhi_tpu/core/stream.py; staging, flush,
heartbeats, Event and columnar callbacks, synchronous or asynchronous
delivery — parallel ingress, WAL, breakers and @OnError are not yet
ported).

`send` / `send_batch` stage host rows; a full batch or `flush()` encodes
them into a fixed-capacity columnar batch on the app's device and delivers
it to every receiver. `send_columns` encodes whole numpy columns at once.
A junction may carry send-order taps: a multi-stream sequence copies every
row of its source streams, in the order they were sent, into its merged
junction (`stage_row`); a tapped junction takes each row through its taps
one by one, whichever way it was sent.

A callback receives a step's output through one packed readback
(ops/wire.py, K12a on the card): `_deliver` packs the batch and starts its
copy to the host at once, under the controller lock and on the step's
stream, because the next step may update the output's tensors in place.
Without a decoder the callback then waits for that copy; with
`async_callbacks=True` the AsyncDecoder's workers wait and decode while the
controller goes on.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..ops.wire import Readback, WireHost
from ..query_api.definition import StreamDefinition
from . import dtypes
from .context import SiddhiAppContext
from .event import (Event, EventBatch, EventType, StreamCodec,
                    events_from_columns, host_events)

_log = logging.getLogger("siddhi_tpu_torch")


class Receiver:
    """Junction subscriber."""

    def on_batch(self, batch: EventBatch, now: int) -> None:
        raise NotImplementedError


class _HostReceiver(Receiver):
    """A subscriber that takes the host form of a batch (`on_host`): the
    junction hands it one shared packed readback per delivery."""

    _junction: "StreamJunction" = None

    def on_host(self, host: WireHost, now: int) -> None:
        raise NotImplementedError


class StreamCallback(_HostReceiver):
    """User-facing stream subscriber: override `receive`, or wrap a plain
    function with FunctionStreamCallback."""

    def receive(self, events: list[Event]) -> None:
        raise NotImplementedError

    def on_host(self, host: WireHost, now: int) -> None:
        events = host_events(host, self._junction.codec)
        if events:
            self.receive(events)


class FunctionStreamCallback(StreamCallback):
    def __init__(self, fn: Callable[[list[Event]], None]):
        self.fn = fn

    def receive(self, events: list[Event]) -> None:
        self.fn(events)


class ColumnarBlock:
    """One delivered output micro-batch, as columns: compacted numpy arrays
    in DEVICE dtypes (doubles arrive as float32, strings as int32
    dictionary codes). `strings(name)` decodes a string column;
    `to_events()` materializes Event objects. Delivery by block skips the
    per-event object construction. The callbacks of one stream share the
    arrays of a delivery (one readback): treat them as read-only."""

    __slots__ = ("timestamps", "columns", "is_expired", "count", "_codec")

    def __init__(self, timestamps, columns, is_expired, count, codec):
        self.timestamps = timestamps  # int64[count]
        self.columns = columns  # name -> numpy[count] (device dtypes)
        self.is_expired = is_expired  # bool[count]
        self.count = count
        self._codec = codec

    def __len__(self) -> int:
        return self.count

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def strings(self, name: str) -> list:
        """Decode a string column's codes to Python strings (native
        map_codes unless the column holds transient codes)."""
        return self._codec.string_tables[name].decode_column(
            self.columns[name])

    def to_events(self) -> list[Event]:
        """Event objects, with the same decode as the Event callback."""
        return events_from_columns(self._codec, self.timestamps,
                                   self.is_expired, self.columns)


class BatchStreamCallback(_HostReceiver):
    """Columnar (batch-level) stream subscriber: override `receive_batch`,
    or wrap a function via add_callback(..., columnar=True)."""

    def receive_batch(self, block: ColumnarBlock) -> None:
        raise NotImplementedError

    def on_host(self, host: WireHost, now: int) -> None:
        if host.count == 0:
            return
        self.receive_batch(ColumnarBlock(
            timestamps=host.ts, columns=host.cols,
            is_expired=host.types == int(EventType.EXPIRED),
            count=host.count, codec=self._junction.codec))


class FunctionBatchCallback(BatchStreamCallback):
    def __init__(self, fn: Callable[[ColumnarBlock], None]):
        self.fn = fn

    def receive_batch(self, block: ColumnarBlock) -> None:
        self.fn(block)


class AsyncDecoder:
    """Background device-to-host decode for stream callbacks.

    `submit` runs on the controller thread: the junction has already packed
    the batch and enqueued its copy into pinned memory (K12a, one copy, one
    event), so submit only queues it. Two stages of threads follow:

      fetch workers (N)   wait for the copy's event (the wait releases the
                          GIL) and unpack it into fresh numpy arrays; they
                          launch no device work
      delivery thread (1) calls the callbacks strictly in submit order
                          (a sequence-numbered reorder buffer)

    The input queue bounds the buffers in flight, hence the pinned memory;
    the reorder buffer is bounded too (fetch-to-deliver backpressure). A
    failing callback is logged and delivery goes on."""

    N_FETCH = int(os.environ.get("SIDDHI_DECODE_WORKERS", "2"))

    def __init__(self, maxsize: int = 32) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        #: max decoded-but-undelivered batches held in the reorder buffer
        self._max_lag = max(maxsize, self.N_FETCH + 1)
        self._seq = 0
        self._deliver_next = 0
        self._buffer: dict = {}
        self._cv = threading.Condition()
        self._stopping = False
        self._threads = [
            threading.Thread(target=self._fetch_loop, daemon=True,
                             name=f"siddhi-fetch-{i}")
            for i in range(self.N_FETCH)]
        self._threads.append(threading.Thread(
            target=self._deliver_loop, daemon=True, name="siddhi-decoder"))
        for t in self._threads:
            t.start()

    def submit(self, receiver: _HostReceiver, readback: Readback,
               now: int) -> None:
        """Queue one receiver's delivery (controller thread, under the
        controller lock). The bounded put may block; the workers never take
        the controller lock, so the queue always drains."""
        self._q.put((self._seq, receiver, readback, now))
        self._seq += 1

    def _fetch_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                seq, receiver, readback, now = item
                try:
                    host = readback.result()
                except Exception:  # noqa: BLE001 — the worker must not die
                    _log.exception("async readback failed")
                    host = None
                with self._cv:
                    # backpressure the fetch-to-deliver stage: at most
                    # N_FETCH seqs are in flight and every seq below the
                    # smallest of them is buffered or delivered, so
                    # delivery always progresses and notifies
                    while (seq - self._deliver_next > self._max_lag
                           and not self._stopping):
                        self._cv.wait(timeout=0.2)
                    self._buffer[seq] = (receiver, host, now)
                    self._cv.notify_all()
            finally:
                self._q.task_done()

    def _deliver_loop(self) -> None:
        while True:
            with self._cv:
                while (self._deliver_next not in self._buffer
                       and not self._stopping):
                    self._cv.wait(timeout=0.2)
                if self._stopping and self._deliver_next not in self._buffer:
                    return
                receiver, host, now = self._buffer.pop(self._deliver_next)
                self._deliver_next += 1
            if host is not None:
                try:
                    receiver.on_host(host, now)
                except Exception:  # noqa: BLE001 — async path must not die
                    _log.exception("async stream callback failed")
            with self._cv:
                self._cv.notify_all()

    def drain(self) -> None:
        """Block until every submitted batch has been delivered."""
        self._q.join()  # all fetches done
        with self._cv:
            while self._deliver_next < self._seq:
                self._cv.wait(timeout=0.2)

    def stop(self) -> None:
        self.drain()
        for _ in range(self.N_FETCH):
            self._q.put(None)
        self._q.join()
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30)


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
        #: send-order interceptors fn(ts, data): multi-stream sequence
        #: queries tap their source junctions to build a merged arrival
        #: stream in true per-event send order
        self.taps: list[Callable] = []
        #: rows staged by taps from any producer thread (`stage_row`),
        #: drained into the staging buffers at the next flush
        self._tap_queue: list = []
        self._tap_lock = threading.Lock()

    def subscribe(self, receiver: Receiver) -> None:
        if isinstance(receiver, _HostReceiver):
            receiver._junction = self
        self.receivers.append(receiver)

    # ---------------------------------------------------------------- ingest

    def send_rows(self, tss: Sequence[int], rows: Sequence) -> None:
        if not rows:
            return
        if self.taps:
            # sequence taps need true per-row send order
            for ts, row in zip(tss, rows):
                for tap in self.taps:
                    tap(ts, row)
                self._stage_rows((ts,), (row,))
            return
        self._stage_rows(tss, rows)

    def _stage_rows(self, tss: Sequence[int], rows: Sequence) -> None:
        with self.ctx.controller_lock:
            self._staged_ts.extend(tss)
            self._staged_rows.extend(rows)
            full = len(self._staged_rows) >= self.batch_size
        self.ctx.timestamp_generator.observe_event_time(int(max(tss)))
        if full:
            self.flush()

    def stage_row(self, ts: int, data: Sequence) -> None:
        """Thread-safe staging from any producer thread (the sequence taps
        run on whichever thread called the source's send); the rows enter
        the staging buffers under the controller lock at the next flush."""
        with self._tap_lock:
            self._tap_queue.append((ts, data))
            full = len(self._tap_queue) >= self.batch_size
        self.ctx.timestamp_generator.observe_event_time(ts)
        if full:
            self.flush()

    def send_column_batch(self, ts_arr: np.ndarray, cols: dict,
                          n: int) -> None:
        """Deliver encoded numpy columns, chunked to the batch capacity. A
        tapped junction takes the rows one by one through its taps: the
        columns decode back to host rows."""
        if n == 0:
            return
        if self.taps:
            events = events_from_columns(
                self.codec, np.ascontiguousarray(ts_arr[:n]),
                np.zeros(n, dtype=bool), {k: v[:n] for k, v in cols.items()})
            self.send_rows([e.timestamp for e in events],
                           [tuple(e.data) for e in events])
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
            if self.taps:
                # taps need host rows: only a derived stream feeding a
                # multi-stream sequence pays this readback
                for ev in batch.to_host_events(self.codec):
                    for tap in self.taps:
                        tap(ev.timestamp, tuple(ev.data))
            if self._staged_rows:
                self.flush()
            self._deliver(batch, now)

    def flush(self, now: Optional[int] = None) -> None:
        with self.ctx.controller_lock:
            if self._tap_queue:
                with self._tap_lock:
                    q, self._tap_queue = self._tap_queue, []
                for ts, row in q:
                    self._staged_ts.append(ts)
                    self._staged_rows.append(row)
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
        decoder = self.ctx.decoder
        readback = None
        if any(isinstance(r, _HostReceiver) for r in self.receivers):
            # one pack and copy for every callback, enqueued now: a later
            # step may update the output's tensors in place
            readback = batch.readback()
        for r in self.receivers:
            if not isinstance(r, _HostReceiver):
                r.on_batch(batch, now)
            elif decoder is not None:
                decoder.submit(r, readback, now)
            else:
                r.on_host(readback.result(), now)


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
