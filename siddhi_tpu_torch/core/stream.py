"""Stream junctions, input handlers, stream callbacks and the async
decoder (counterpart of siddhi_tpu/core/stream.py; staging, flush,
heartbeats, Event and columnar callbacks, synchronous or asynchronous
delivery, and @Async: the micro-batch size, the MPSC staging ring and its
feeder, bounded admission with drop policies, and the parallel ingress
pipeline of core/ingress.py — WAL, breakers, @OnError, fault diversion and
source pause/resume are not yet ported).

`send` / `send_batch` stage host rows; a full batch or `flush()` encodes
them into a fixed-capacity columnar batch on the app's device and delivers
it to every receiver. `send_columns` encodes whole numpy columns at once.
A junction may carry send-order taps: a multi-stream sequence copies every
row of its source streams, in the order they were sent, into its merged
junction (`stage_row`); a tapped junction takes each row through its taps
one by one, whichever way it was sent.

`@Async(buffer.size=N)` sets the junction's micro-batch to N rows. Once the
app starts, producers of an @Async stream hand rows to a native MPSC ring
that a feeder thread drains (`workers` = 0), or to the parallel ingress
pipeline (`workers` > 0, or SIDDHI_INGRESS_WORKERS); `overflow.policy`
`drop.new` / `drop.old` with `max.staged` bounds the staged rows instead,
every shed row counted in Statistics.

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
import time
from typing import Callable, Optional, Sequence

import numpy as np

from .. import native
from ..errors import SiddhiAppCreationError
from ..ops.wire import Readback, WireHost
from ..query_api.definition import StreamDefinition
from . import dtypes
from .context import SiddhiAppContext, parse_annotation_time
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
        #: rows staged by taps from any producer thread (`stage_row`), and
        #: a bounded junction's admitted rows, drained into the staging
        #: buffers at the next flush
        self._tap_queue: list = []
        self._tap_lock = threading.Lock()
        #: per-thread guard: the ring drain's nested flushes do not drain
        self._reentry = threading.local()
        self._ring = None
        self._ring_cap = 0
        self._feeder: Optional[threading.Thread] = None
        self._feeder_stop: Optional[threading.Event] = None
        self._feeder_wake: Optional[threading.Event] = None
        self._pipeline = None  # core/ingress.IngressPipeline while started
        self.ingress_workers = 0
        self.capacity: Optional[int] = None
        self.overflow_policy = "block"
        self.block_timeout_s: Optional[float] = None
        self.high_watermark = 0.8
        self.low_watermark = 0.2
        #: sources feeding this junction, the pause()/resume() targets of
        #: the watermarks (sources are not yet ported: always empty)
        self.attached_sources: list = []
        ann = definition.annotation("async") if definition.annotations \
            else None
        self.is_async = ann is not None
        if ann is not None:
            self._parse_async(ann)

    def _parse_async(self, ann) -> None:
        """@Async(buffer.size=N, workers=W, overflow.policy=block|drop.new|
        drop.old, max.staged=M, block.timeout='1 sec', high.watermark=0.8,
        low.watermark=0.2): the micro-batch size, the staging ring's
        capacity, the pipeline's workers and the admission bound."""
        sid = self.definition.id
        bs = ann.element("buffer.size")
        if bs:
            self.batch_size = int(bs)
        self._ring_cap = max(4 * self.batch_size, 1024)
        w = ann.element("workers")
        if w:
            self.ingress_workers = int(w)
        if self.ingress_workers == 0:
            self.ingress_workers = int(
                os.environ.get("SIDDHI_INGRESS_WORKERS", "0") or 0)
        pol = (ann.element("overflow.policy") or "block").lower()
        if pol not in ("block", "drop.new", "drop.old", "fault"):
            raise SiddhiAppCreationError(
                f"@Async on {sid!r}: overflow.policy {pol!r} "
                "must be block | drop.new | drop.old | fault")
        if pol == "fault":
            raise SiddhiAppCreationError(
                f"@Async on {sid!r}: overflow.policy 'fault' is not yet "
                "ported to siddhi_tpu_torch (it diverts to fault streams "
                "and the error store, ROADMAP Queue 1 item 5)")
        self.overflow_policy = pol
        ms = ann.element("max.staged")
        self.capacity = int(ms) if ms else self._ring_cap
        if self.capacity < self.batch_size and pol != "block":
            raise SiddhiAppCreationError(
                f"@Async on {sid!r}: max.staged "
                f"({self.capacity}) must be >= buffer.size "
                f"({self.batch_size})")
        bt = ann.element("block.timeout")
        if bt:
            self.block_timeout_s = parse_annotation_time(bt) / 1000.0
        hw = ann.element("high.watermark")
        lw = ann.element("low.watermark")
        self.high_watermark = float(hw) if hw else 0.8
        self.low_watermark = float(lw) if lw else 0.2
        if not 0.0 <= self.low_watermark < self.high_watermark <= 1.0:
            raise SiddhiAppCreationError(
                f"@Async on {sid!r}: need "
                "0 <= low.watermark < high.watermark <= 1")

    def _pad_cap(self, m: int) -> int:
        """Delivery capacity for `m` staged rows: the smallest power-of-two
        lane bucket holding them."""
        return dtypes.bucket_capacity(m, self.batch_size)

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
                self._admit((ts,), (row,))
            return
        self._admit(tss, rows)

    def _admit(self, tss: Sequence[int], rows: Sequence) -> None:
        """Route rows into the bounded pre-staging, the parallel pipeline,
        the MPSC ring or the synchronous staging. A thread that holds the
        controller lock (a callback sending into an @Async stream) stages
        synchronously: the ring's only drainer needs that lock."""
        self.ctx.timestamp_generator.observe_event_time(int(max(tss)))
        if not self._lock_owned():
            if self._bounded_mode():
                self._stage_bounded(zip(tss, rows))
                return
            if self._pipeline is not None:
                done = self._pipeline.submit_rows(tss, rows)
                if done >= len(rows):
                    return
                # pipeline stopping: the rest stages synchronously
                tss, rows = tss[done:], rows[done:]
            if self._ring is not None:
                done = self._push_ring(tss, rows)
                if done >= len(rows):
                    return
                tss, rows = tss[done:], rows[done:]
        self._stage_rows(tss, rows)

    def _stage_rows(self, tss: Sequence[int], rows: Sequence) -> None:
        with self.ctx.controller_lock:
            self._staged_ts.extend(tss)
            self._staged_rows.extend(rows)
            full = len(self._staged_rows) >= self.batch_size
        if full:
            self.flush()

    def _push_ring(self, tss: Sequence[int], rows: Sequence) -> int:
        """Push rows into the MPSC ring, waiting while it is full (the
        Disruptor's blocking wait); `block.timeout` bounds the wait and
        sheds the rest, counted. Returns the rows consumed: fewer when
        shutdown detached the ring (the caller stages the rest)."""
        push = native.load().ring_push
        deadline = (None if self.block_timeout_s is None
                    else time.monotonic() + self.block_timeout_s)
        for i, (ts, row) in enumerate(zip(tss, rows)):
            while True:
                ring = self._ring
                if ring is None:
                    return i
                if push(ring, ts, tuple(row)):
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    self.ctx.statistics.track_ingress_drop(
                        self.definition.id, "block.timeout", len(rows) - i)
                    return len(rows)
                self._feeder_wake.set()
                time.sleep(0.0002)
        return len(rows)

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
        pcap = self._pad_cap(m)
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
        if self._pipeline is not None and not self._lock_owned():
            # barrier: every row submitted to the pipeline before this
            # flush is delivered when it returns (lock holders skip it:
            # the feeder needs the controller lock to make progress)
            self._pipeline.drain()
        with self.ctx.controller_lock:
            if self._ring is not None and not getattr(self._reentry,
                                                      "draining", False):
                self._drain_ring()
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

    # ------------------------------------------------------------ async mode

    def _lock_owned(self) -> bool:
        """True when THIS thread holds the controller lock (a callback
        inside _deliver sending into an async stream)."""
        return self.ctx.controller_lock._is_owned()

    def _bounded_mode(self) -> bool:
        """Producer-side admission control: a capacity with a drop policy.
        Rows then enter the pre-staging queue only, and delivery is pulled
        by the feeder, the auto-flusher or flush(), so the bound caps host
        memory."""
        return self.capacity is not None and self.overflow_policy != "block"

    def _stage_bounded(self, items) -> None:
        """Admission for drop.new / drop.old: each row enters the
        pre-staging queue or is shed, every decision counted."""
        stats = self.ctx.statistics
        sid = self.definition.id
        with self._tap_lock:
            q = self._tap_queue
            for ts, row in items:
                if len(q) < self.capacity:
                    q.append((ts, row))
                elif self.overflow_policy == "drop.old":
                    q.pop(0)
                    q.append((ts, row))
                    stats.track_ingress_drop(sid, "drop.old", 1)
                else:
                    stats.track_ingress_drop(sid, "drop.new", 1)
            depth = len(q)
        stats.track_queue_depth(sid, depth)
        if self._feeder_wake is not None:
            self._feeder_wake.set()

    def start_async(self) -> None:
        """App start: the parallel pipeline (workers > 0, block policy, no
        taps), the bounded feeder (drop policies), or the MPSC ring and its
        feeder; synchronous without the native extension."""
        if not self.is_async or self._feeder is not None \
                or self._pipeline is not None:
            return
        if (self.ingress_workers > 0 and self.overflow_policy == "block"
                and not self.taps and not self.codec.object_attrs):
            from .ingress import IngressPipeline
            try:
                self._pipeline = IngressPipeline(self, self.ingress_workers)
                self._pipeline.start()
                return
            except Exception:  # noqa: BLE001 — logged, the ring runs
                _log.exception(
                    "@Async(workers=%d) on %r: ingress pipeline failed to "
                    "start; falling back to the staging ring",
                    self.ingress_workers, self.definition.id)
                self._pipeline = None
        sid = self.definition.id
        self._feeder_stop = threading.Event()
        self._feeder_wake = threading.Event()
        if self._bounded_mode():
            self._feeder = threading.Thread(
                target=self._bounded_feed_loop, daemon=True,
                name=f"siddhi-feeder-{sid}")
            self._feeder.start()
            return
        nat = native.load()
        if nat is None:
            _log.info("@Async on %r: native ring unavailable; staying "
                      "synchronous", sid)
            self._feeder_stop = self._feeder_wake = None
            return
        self._ring = nat.ring_new(self._ring_cap)
        self._feeder = threading.Thread(target=self._feed_loop, daemon=True,
                                        name=f"siddhi-feeder-{sid}")
        self._feeder.start()

    def stop_async(self) -> None:
        if self._pipeline is not None:
            # detach first: producers mid-submit stage synchronously; stop()
            # delivers everything already claimed
            p, self._pipeline = self._pipeline, None
            p.stop()
        if self._feeder is None:
            return
        self._feeder_stop.set()
        self._feeder_wake.set()
        ring, self._ring = self._ring, None
        self._feeder.join(timeout=120)
        if self._feeder.is_alive():  # pragma: no cover — wedged step
            _log.warning("async feeder for %r did not stop; leaving its "
                         "ring attached", self.definition.id)
            return
        with self.ctx.controller_lock:
            self._drain_ring(ring=ring)
        self._feeder = None

    def _feed_loop(self) -> None:
        nat = native.load()
        while not self._feeder_stop.is_set():
            ring = self._ring
            if ring is None:
                break
            if nat.ring_size(ring) == 0:
                self._feeder_wake.wait(timeout=0.001)
                self._feeder_wake.clear()
                continue
            try:
                with self.ctx.controller_lock:
                    self._drain_ring(max_batches=4, ring=ring)
            except Exception:  # noqa: BLE001 — the feeder must not die
                _log.exception("async feeder error on %r",
                               self.definition.id)

    def _bounded_feed_loop(self) -> None:
        """Drainer of a bounded junction: flush whenever the pre-staging
        queue holds rows."""
        while not self._feeder_stop.is_set():
            if not self._tap_queue:
                self._feeder_wake.wait(timeout=0.001)
                self._feeder_wake.clear()
                continue
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — the feeder must not die
                _log.exception("bounded feeder error on %r",
                               self.definition.id)

    def _drain_ring(self, max_batches: Optional[int] = None,
                    ring=None) -> None:
        """Pop ring rows into the staging buffers and flush them a batch at
        a time. Single consumer: callers hold the controller lock."""
        ring = ring if ring is not None else self._ring
        if ring is None or getattr(self._reentry, "draining", False):
            return
        pop = native.load().ring_pop_batch
        self._reentry.draining = True
        try:
            batches = 0
            while max_batches is None or batches < max_batches:
                tss, rows = pop(ring, self.batch_size)
                if not rows:
                    break
                self._staged_ts.extend(tss)
                self._staged_rows.extend(rows)
                self.flush()
                batches += 1
        finally:
            self._reentry.draining = False

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
        if j._pipeline is not None and not j.taps and not j._lock_owned():
            # parallel ingress: claim ring runs here; the workers encode and
            # intern, the feeder delivers
            j.ctx.timestamp_generator.observe_event_time(
                int(ts_arr[:n].max()))
            done = j._pipeline.submit_columns(ts_arr, columns, n)
            if done >= n:
                return
            ts_arr = ts_arr[done:]
            columns = {k: np.asarray(v)[done:] for k, v in columns.items()}
            n -= done
        with j.ctx.controller_lock:  # interning mutates the shared table
            cols = j.codec.encode_columns(columns, n)
            j.send_column_batch(ts_arr, cols, n)
