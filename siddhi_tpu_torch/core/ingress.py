"""Parallel ingress pipeline of an @Async(workers=N) stream (counterpart of
siddhi_tpu/core/ingress.py, without the SXF1 wire path and the shard
router).

    producers --claim--> [decode/intern workers] --publish-->
        lock-free columnar ring --pop--> [feeder] --H2D--> step

  stage 1  submit: producer threads claim contiguous ring runs (claim
           order is delivery order) and hand the payload to the workers;
           a full ring is blocking backpressure.
  stage 2  decode/intern: N workers convert rows or columns to fixed-width
           buffers and write them into their claimed runs (the native
           colring_write copies with the GIL released). Interning is the
           one ordered stage: workers take an intern ticket and intern in
           claim order, under the controller lock.
  stage 3  feed: one consumer pops contiguous published runs into batch-
           sized chunks of a host block (pinned memory on the card), copies
           each block to the device with one non-blocking copy on a side
           stream, makes the step's stream wait on the copy's event and
           delivers under the controller lock. A block is refilled only
           after its copy's event has completed, so the copy of chunk k+1
           overlaps the steps of chunk k. With @app:superstep(k=K) the
           feeder stages K full chunks in one block and hands it to the
           superstep runner (core/superstep.py): one copy, K steps, one
           readback per emitting slot.

With one producer the delivered batches are bit-identical to the
synchronous path: the same chunk boundaries (batch_size from offset 0), the
same padding of a partial chunk at a flush (`_pad_cap`, monotone ts, zero
columns) and the same string codes (ticket-ordered interning). With several
producers the interleaving is the claim order; every row is delivered.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels, native
from .event import EventBatch

_log = logging.getLogger("siddhi_tpu_torch")

#: np dtype name -> colring type code (widths: b=1, i=4, l=8, f=4, d=8)
_NP_TYPECODE = {"bool": "b", "int8": "b", "int32": "i", "int64": "l",
                "float32": "f", "float64": "d"}
_TORCH = {"bool": torch.bool, "int8": torch.int8, "int32": torch.int32,
          "int64": torch.int64, "float32": torch.float32,
          "float64": torch.float64}

#: seconds a drain() barrier waits before it raises TimeoutError
DRAIN_TIMEOUT_S = 120.0


def _typecodes(np_dtypes: Sequence[np.dtype]) -> Optional[bytes]:
    codes = []
    for dt in np_dtypes:
        c = _NP_TYPECODE.get(dt.name)
        if c is None:
            return None
        codes.append(c)
    return "".join(codes).encode("ascii")


class _NativeColRing:
    """Thin adapter over the native lock-free columnar ring."""

    def __init__(self, cap: int, typecodes: bytes, nmod) -> None:
        self._n = nmod
        self._r = nmod.colring_new(cap, typecodes)
        self.capacity = nmod.colring_capacity(self._r)

    def claim(self, n: int) -> int:
        return self._n.colring_claim(self._r, n)

    def write(self, start: int, n: int, ts, cols) -> None:
        self._n.colring_write(self._r, start, n, ts, cols)

    def pop(self, max_n: int, ts_out, cols_out) -> int:
        return self._n.colring_pop(self._r, max_n, ts_out, cols_out)

    def size(self) -> int:
        return self._n.colring_size(self._r)

    def hwm(self) -> int:
        return self._n.colring_hwm(self._r)


class _PyColRing:
    """Pure-Python ring with the same surface: a lock guards claim(),
    numpy slice copies write and pop, and per-slot sequence stamps carry
    the publish order as in the native ring (SIDDHI_NATIVE=0, or no C
    compiler)."""

    def __init__(self, cap: int, dtypes_list: Sequence[np.dtype]) -> None:
        c = 1
        while c < cap:
            c <<= 1
        self.capacity = c
        self._mask = c - 1
        self._ts = np.zeros(c, dtype=np.int64)
        self._cols = [np.zeros(c, dtype=dt) for dt in dtypes_list]
        self._seq = np.zeros(c, dtype=np.int64)
        self._head = 0
        self._tail = 0
        self._hwm = 0
        self._lock = threading.Lock()

    def claim(self, n: int) -> int:
        with self._lock:
            if self._head + n - self._tail > self.capacity:
                return -1
            s = self._head
            self._head += n
            self._hwm = max(self._hwm, self._head - self._tail)
            return s

    def write(self, start: int, n: int, ts, cols) -> None:
        cap, mask = self.capacity, self._mask
        s0 = start & mask
        first = min(cap - s0, n)
        second = n - first
        self._ts[s0:s0 + first] = ts[:first]
        if second:
            self._ts[:second] = ts[first:n]
        for dst, src in zip(self._cols, cols):
            dst[s0:s0 + first] = src[:first]
            if second:
                dst[:second] = src[first:n]
        idx = np.arange(start, start + n) & mask
        self._seq[idx] = np.arange(start + 1, start + n + 1)

    def pop(self, max_n: int, ts_out, cols_out) -> int:
        t, cap, mask = self._tail, self.capacity, self._mask
        max_n = min(max_n, len(ts_out))
        if max_n <= 0:
            return 0
        want = np.arange(t + 1, t + max_n + 1)
        got = self._seq[np.arange(t, t + max_n) & mask]
        ok = got == want
        n = max_n if ok.all() else int(ok.argmin())
        if n == 0:
            return 0
        s0 = t & mask
        first = min(cap - s0, n)
        second = n - first
        ts_out[:first] = self._ts[s0:s0 + first]
        if second:
            ts_out[first:n] = self._ts[:second]
        for dst, src in zip(cols_out, self._cols):
            dst[:first] = src[s0:s0 + first]
            if second:
                dst[first:n] = src[:second]
        self._seq[np.arange(t, t + n) & mask] = 0
        self._tail = t + n
        return n

    def size(self) -> int:
        return self._head - self._tail

    def hwm(self) -> int:
        return self._hwm


class _HostBlock:
    """`rows` ingress chunks of `bs` lanes in one host buffer (pinned on
    the card). Each row holds the timestamps, then each column, every
    region 8-byte aligned, so one copy moves all rows and each row's
    regions view as typed device tensors. `event` marks the end of the
    last copy that reads the block."""

    def __init__(self, rows: int, bs: int, np_dtypes, pin: bool) -> None:
        offs, at = self.offsets(bs, np_dtypes)
        self.mem = torch.empty((rows, at), dtype=torch.uint8,
                               pin_memory=pin)
        arr = self.mem.numpy()
        self.ts = [arr[r, :8 * bs].view(np.int64) for r in range(rows)]
        self.cols = [[arr[r, o:o + dt.itemsize * bs].view(dt)
                      for o, dt in zip(offs, np_dtypes)]
                     for r in range(rows)]
        self.event: Optional[torch.cuda.Event] = None

    @staticmethod
    def offsets(bs: int, np_dtypes) -> tuple[list, int]:
        """Each column's byte offset in a row, and the row's bytes."""
        offs, at = [], 8 * bs
        for dt in np_dtypes:
            offs.append(at)
            at += -(-dt.itemsize * bs // 8) * 8
        return offs, at

    def wait(self) -> None:
        """Block until no copy reads the block any more."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None


class IngressPipeline:
    """Per-junction parallel ingress: worker pool, columnar ring, feeder.

    Lock discipline: producers take only the submit lock (claim and
    enqueue) and never the controller lock; workers take the intern ticket
    and, while interning, the controller lock; the feeder takes the
    controller lock only around delivery; drain() runs only on threads
    that do not hold the controller lock (junction.flush checks).
    """

    def __init__(self, junction, workers: int) -> None:
        self.j = junction
        self.ctx = junction.ctx
        self.workers = max(1, int(workers))
        defn = junction.definition
        if junction.codec.object_attrs:
            raise ValueError("ingress pipeline: OBJECT attrs have no "
                             "columnar layout")
        self.attrs = [a.name for a in defn.attributes]
        self.np_dtypes = [junction.codec.np_dtypes[n] for n in self.attrs]
        self.torch_dtypes = [_TORCH[dt.name] for dt in self.np_dtypes]
        tcs = _typecodes(self.np_dtypes)
        if tcs is None:
            raise ValueError("ingress pipeline: unsupported dtype in schema")
        self._string_attrs = set(junction.codec.string_tables)
        self._ordered = bool(self._string_attrs)
        cap = junction._ring_cap
        nat = None if native.disabled() else native.load()
        if nat is not None and hasattr(nat, "colring_new"):
            self.ring = _NativeColRing(cap, tcs, nat)
        else:
            self.ring = _PyColRing(cap, self.np_dtypes)
        self.device = self.ctx.device
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._blocks: dict[int, list] = {}  # rows -> [block, block]
        self._next_block: dict[int, int] = {}
        self._q: queue.Queue = queue.Queue()
        #: claim and enqueue run under this lock, so queue order is claim
        #: order: the invariant the intern tickets need
        self._submit_lock = threading.Lock()
        self._ticket_cv = threading.Condition()
        self._next_ticket = 0
        self._stopping = False
        self._error: Optional[BaseException] = None
        self._threads: list[threading.Thread] = []
        self._feeder: Optional[threading.Thread] = None
        self._feeder_stop = threading.Event()
        self._flush_req = threading.Event()
        # a barrier flush (drain/stop) as opposed to the backpressure flush
        # a full ring raises: only a barrier disassembles a staged
        # superstep (staging keeps popping the ring, so space frees)
        self._barrier_req = threading.Event()
        self._feeder_idle = threading.Event()
        self._feeder_idle.set()
        self._ss_k = 1
        self._ss_runner = None
        self._ss_decline: Optional[str] = None
        self._ss_supersteps = 0
        self._ss_scan_ns = 0
        self._ss_replay_ns = 0
        self._t0 = time.monotonic()
        self._worker_busy_ns = [0] * self.workers
        self._worker_decode_ns = [0] * self.workers
        self._worker_intern_ns = [0] * self.workers
        self._worker_runs = [0] * self.workers
        self._h2d_ns = 0
        self._h2d_count = 0
        self._device_ns = 0
        self._batches = 0
        self._overlapped = 0
        self._rows_in = 0
        self._runs_in = 0
        self._rows_out = 0  # feeder only: rows handed to the receivers

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        sid = self.j.definition.id
        for i in range(self.workers):
            t = threading.Thread(target=self._worker_loop, args=(i,),
                                 daemon=True,
                                 name=f"siddhi-ingress-{sid}-w{i}")
            t.start()
            self._threads.append(t)
        self._feeder = threading.Thread(target=self._feed_loop, daemon=True,
                                        name=f"siddhi-ingress-{sid}-feed")
        self._feeder.start()

    def stop(self) -> None:
        """No new submits; queued runs finish (an unpublished claimed run
        would strand the rows behind it), the feeder delivers the rest,
        threads join."""
        self._stopping = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=120)
        self._barrier_req.set()
        self._flush_req.set()
        self._feeder_stop.set()
        if self._feeder is not None:
            self._feeder.join(timeout=120)
            if self._feeder.is_alive():  # pragma: no cover — wedged step
                _log.warning("ingress feeder for %r did not stop",
                             self.j.definition.id)

    # ---------------------------------------------------------------- submit

    def _claim_blocking(self, n: int, deadline: Optional[float]) -> int:
        """Claim n contiguous slots, waiting while the ring is full.
        Returns -1 on block.timeout expiry, -2 when the pipeline stopped;
        raises the feeder's error if it died."""
        while True:
            if self._error is not None:
                raise self._error
            if self._stopping:
                return -2
            s = self.ring.claim(n)
            if s >= 0:
                return s
            if deadline is not None and time.monotonic() >= deadline:
                return -1
            self._flush_req.set()
            time.sleep(0.0002)

    def _deadline(self) -> Optional[float]:
        bt = self.j.block_timeout_s
        return None if bt is None else time.monotonic() + bt

    def _submit(self, n: int, run_of) -> int:
        """Claim runs of at most batch_size rows and queue `run_of(i, m,
        start)` for the workers. Returns the rows consumed: a short count
        means the pipeline is stopping and the caller owns the rest."""
        if self._stopping:
            return 0
        bs = self.j.batch_size
        deadline = self._deadline()
        i = 0
        while i < n:
            m = min(bs, n - i)
            with self._submit_lock:
                s = self._claim_blocking(m, deadline)
                if s == -2:
                    return i
                if s == -1:
                    self.ctx.statistics.track_ingress_drop(
                        self.j.definition.id, "block.timeout", n - i)
                    return n
                self._rows_in += m
                self._runs_in += 1
                self._q.put(run_of(i, m, s))
            i += m
        return n

    def submit_rows(self, tss: Sequence[int], rows: Sequence) -> int:
        """Producer-thread entry of the row path."""
        return self._submit(len(rows), lambda i, m, s: (
            "rows", s, m, tss[i:i + m], rows[i:i + m]))

    def submit_columns(self, ts_arr: np.ndarray, columns: dict,
                       n: int) -> int:
        """Producer-thread entry of the columnar path: `columns` maps attr
        -> numpy array (numeric, pre-encoded int codes, or str/None
        objects)."""
        specs = []
        for name in self.attrs:
            if name not in columns:
                raise ValueError(
                    f"send_columns: missing column {name!r} for stream "
                    f"{self.j.definition.id!r}")
            arr = np.asarray(columns[name])
            if arr.shape[0] < n:
                raise ValueError(
                    f"send_columns: column {name!r} has {arr.shape[0]} "
                    f"rows, expected {n}")
            strs = name in self._string_attrs and \
                not np.issubdtype(arr.dtype, np.integer)
            specs.append(("strs" if strs else "num", arr))
        ts_arr = np.asarray(ts_arr, dtype=np.int64)
        return self._submit(n, lambda i, m, s: (
            "cols", s, m, ts_arr[i:i + m],
            [(kind, a[i:i + m]) for kind, a in specs]))

    # --------------------------------------------------------------- workers

    def _take_ticket(self, start: int) -> None:
        with self._ticket_cv:
            while self._next_ticket != start:
                self._ticket_cv.wait(timeout=0.05)

    def _release_ticket(self, start: int, n: int) -> None:
        with self._ticket_cv:
            self._next_ticket = start + n
            self._ticket_cv.notify_all()

    def _encode_rows(self, start: int, m: int, payload) -> tuple:
        codec = self.j.codec
        if not self._ordered:
            cols = codec.rows_to_columns(payload, n_pad=m)
            return tuple(cols[a] for a in self.attrs), 0
        # rows_to_columns interns inline: ticket-order the whole decode,
        # under the controller lock (synchronous paths share the table)
        self._take_ticket(start)
        ti = time.perf_counter_ns()
        try:
            with self.ctx.controller_lock:
                cols = codec.rows_to_columns(payload, n_pad=m)
        finally:
            self._release_ticket(start, m)
        return (tuple(cols[a] for a in self.attrs),
                time.perf_counter_ns() - ti)

    def _encode_cols(self, start: int, m: int, payload) -> tuple:
        out, intern_ns, took = [], 0, False
        try:
            for name, dt, (kind, a) in zip(self.attrs, self.np_dtypes,
                                           payload):
                if kind == "num":
                    out.append(np.ascontiguousarray(a, dtype=dt))
                    continue
                if not took and self._ordered:
                    self._take_ticket(start)
                    took = True
                ti = time.perf_counter_ns()
                with self.ctx.controller_lock:
                    codes = self.j.codec.string_tables[name].encode_array(a)
                intern_ns += time.perf_counter_ns() - ti
                out.append(np.ascontiguousarray(codes, dtype=dt))
        finally:
            if self._ordered:
                if not took:
                    self._take_ticket(start)
                self._release_ticket(start, m)
        return tuple(out), intern_ns

    def _worker_loop(self, wid: int) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            t0 = time.perf_counter_ns()
            kind, start, m, ts, payload = item
            try:
                if kind == "rows":
                    cols, intern_ns = self._encode_rows(start, m, payload)
                else:
                    cols, intern_ns = self._encode_cols(start, m, payload)
                self.ring.write(start, m,
                                np.ascontiguousarray(ts, dtype=np.int64),
                                cols)
                self._worker_intern_ns[wid] += intern_ns
                spent = time.perf_counter_ns() - t0
                self._worker_busy_ns[wid] += spent
                self._worker_decode_ns[wid] += spent - intern_ns
                self._worker_runs[wid] += 1
                self._feeder_idle.clear()
            except Exception:  # noqa: BLE001 — logged, the run publishes 0s
                _log.exception("ingress worker error on %r",
                               self.j.definition.id)
                try:
                    self.ring.write(start, m, np.zeros(m, dtype=np.int64),
                                    tuple(np.zeros(m, dtype=dt)
                                          for dt in self.np_dtypes))
                except Exception:  # noqa: BLE001
                    pass
            finally:
                self._q.task_done()

    # --------------------------------------------------------------- staging

    def _take_block(self, rows: int) -> _HostBlock:
        """The next of this size's two host blocks, once no copy reads
        it (the double buffer)."""
        pool = self._blocks.get(rows)
        if pool is None:
            pool = self._blocks[rows] = [
                _HostBlock(rows, self.j.batch_size, self.np_dtypes,
                           self._cuda) for _ in range(2)]
            self._next_block[rows] = 0
        i = self._next_block[rows]
        self._next_block[rows] = 1 - i
        block = pool[i]
        block.wait()
        return block

    def upload(self, block: _HostBlock, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of a block on the device: one copy. On the card it
        runs on a side stream; the current stream waits on its event, and
        the block is not refilled before the event."""
        t0 = time.perf_counter_ns()
        if not self._cuda:
            dev = block.mem[lo:hi].clone()
        else:
            cur = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._side):
                dev = block.mem[lo:hi].to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._side)
            block.event = ev
            cur.wait_event(ev)
            dev.record_stream(cur)
            self._overlapped += hi - lo
        self._h2d_ns += time.perf_counter_ns() - t0
        self._h2d_count += hi - lo
        return dev

    def batch_of(self, dev: torch.Tensor, r: int) -> EventBatch:
        """Row r of an uploaded block as a full EventBatch."""
        bs = self.j.batch_size
        row = dev[r]
        cols = {name: row[o:o + dt.itemsize * bs].view(td)
                for name, dt, td, o in zip(self.attrs, self.np_dtypes,
                                           self.torch_dtypes,
                                           _HostBlock.offsets(
                                               bs, self.np_dtypes)[0])}
        return EventBatch(
            ts=row[:8 * bs].view(torch.int64), cols=cols,
            valid=torch.ones(bs, dtype=torch.bool, device=dev.device),
            types=torch.zeros(bs, dtype=torch.int8, device=dev.device))

    # ---------------------------------------------------------------- feeder

    def _deliver_locked(self, batch: EventBatch, m: int) -> None:
        j = self.j
        t0 = time.perf_counter_ns()
        with self.ctx.controller_lock:
            if j._staged_rows or j._tap_queue:
                j.flush()  # staged (sync-path) rows first: arrival order
            j._deliver(batch, self.ctx.timestamp_generator.current_time())
        self._device_ns += time.perf_counter_ns() - t0
        self._batches += 1
        self._rows_out += m

    def _deliver_chunk(self, block: _HostBlock, r: int) -> None:
        """Per-batch delivery of one staged full chunk."""
        dev = self.upload(block, r, r + 1)
        self._deliver_locked(self.batch_of(dev, 0), self.j.batch_size)

    def _deliver_partial(self, block: _HostBlock, r: int, m: int) -> None:
        """A partial chunk at a flush barrier: m rows padded to their lane
        bucket, timestamps monotone, columns zero."""
        pcap = self.j._pad_cap(m)
        ts_c = np.empty(pcap, dtype=np.int64)
        ts_c[:m] = block.ts[r][:m]
        ts_c[m:] = block.ts[r][m - 1]
        cols = {}
        for name, src in zip(self.attrs, block.cols[r]):
            pad = np.zeros(pcap, dtype=src.dtype)
            pad[:m] = src[:m]
            cols[name] = pad
        t0 = time.perf_counter_ns()
        batch = EventBatch.from_numpy(ts_c, cols, m, self.device)
        self._h2d_ns += time.perf_counter_ns() - t0
        self._h2d_count += 1
        self._deliver_locked(batch, m)

    def _superstep_dispatch(self, block: _HostBlock) -> int:
        """Run K staged chunks as one superstep (core/superstep.py). Returns
        how many leading chunks it consumed; the caller delivers the rest
        through the per-batch path (0: plan declined, topology changed). A
        kernel that does not build or launch raises: the per-batch path
        launches the same kernels."""
        if self._ss_decline is not None:
            return 0
        if self._ss_runner is None or not self._ss_runner.revalidate():
            from .superstep import build_runner
            self._ss_runner, reason = build_runner(self, self._ss_k)
            if self._ss_runner is None:
                self._ss_decline = reason
                _log.warning(
                    "superstep(k=%d) declined for stream %r: %s — falling "
                    "back to per-batch dispatch", self._ss_k,
                    self.j.definition.id, reason)
                return 0
        try:
            consumed = self._ss_runner.dispatch(block)
        except kernels.KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — the app's own step error
            # steps update their states in place: the runner replayed the
            # iterations that finished and dropped (and counted) the
            # failing chunk; the chunks after it go per batch
            consumed = int(getattr(e, "superstep_consumed", 0))
            self._ss_decline = f"runtime error during dispatch: {e!r}"
            self._ss_runner = None
            _log.exception(
                "superstep(k=%d) dispatch failed for stream %r (%d of %d "
                "chunks consumed) — disabling supersteps", self._ss_k,
                self.j.definition.id, consumed, self._ss_k)
            return consumed
        if consumed:
            self._ss_supersteps += 1
        return consumed

    def _feed_loop(self) -> None:
        try:
            self._feed()
        except BaseException as e:  # noqa: BLE001 — surfaced by drain()
            self._error = e
            _log.exception("ingress feeder for %r stopped",
                           self.j.definition.id)
        finally:
            self._feeder_idle.set()

    def _feed(self) -> None:
        bs = self.j.batch_size
        ring = self.ring
        self._ss_k = self.ctx.superstep_k
        superstep = self._ss_k > 1
        rows = self._ss_k if superstep else 1
        block = self._take_block(rows)
        r = 0  # chunks staged in the block
        fill = 0  # rows in chunk r
        while True:
            got = ring.pop(bs - fill, block.ts[r][fill:],
                           tuple(c[fill:] for c in block.cols[r]))
            fill += got
            if fill == bs:
                fill = 0
                if not superstep:
                    self._deliver_chunk(block, 0)
                    block = self._take_block(1)
                    continue
                r += 1
                if r == rows:
                    for i in range(self._superstep_dispatch(block), rows):
                        self._deliver_chunk(block, i)
                    r = 0
                    if self._ss_decline is not None:
                        superstep, rows = False, 1
                    block = self._take_block(rows)
                continue
            if got:
                continue  # partially filled: keep popping while data flows
            flushing = self._flush_req.is_set()
            if flushing and r and not self._barrier_req.is_set() \
                    and not self._feeder_stop.is_set():
                # a full ring's backpressure flush while a superstep
                # stages: staging keeps popping, so ignore it (delivering
                # the partial fill first would reorder rows)
                flushing = False
            if flushing and (fill or r):
                for i in range(r):  # staged chunks, oldest first
                    self._deliver_chunk(block, i)
                if fill:
                    self._deliver_partial(block, r, fill)
                r = fill = 0
                block = self._take_block(rows)
                continue
            if fill == 0 and r == 0 and ring.size() == 0 \
                    and self._q.unfinished_tasks == 0:
                self._feeder_idle.set()
                if self._feeder_stop.is_set():
                    return
                self._flush_req.clear()
                self._barrier_req.clear()
                self._flush_req.wait(timeout=0.001)
            elif self._feeder_stop.is_set() and ring.size() == 0 \
                    and self._q.unfinished_tasks == 0:
                self._flush_req.set()  # stopping with a partial chunk
            else:
                time.sleep(0.0002)

    # ----------------------------------------------------------------- drain

    def drain(self, timeout: Optional[float] = None) -> None:
        """Barrier: every row submitted before this call is delivered when
        it returns. Raises the feeder's error if it died, and TimeoutError
        past `timeout` (DRAIN_TIMEOUT_S)."""
        deadline = time.monotonic() + (DRAIN_TIMEOUT_S if timeout is None
                                       else timeout)
        while time.monotonic() < deadline:
            if self._error is not None:
                raise self._error
            if self._q.unfinished_tasks == 0:
                self._barrier_req.set()
                self._flush_req.set()
                if self._feeder_idle.is_set() and self.ring.size() == 0 \
                        and self._q.unfinished_tasks == 0:
                    if self._error is not None:
                        raise self._error
                    return
            time.sleep(0.0005)
        raise TimeoutError(f"ingress drain timed out on "
                           f"{self.j.definition.id!r} (ring="
                           f"{self.ring.size()})")

    # ------------------------------------------------------------ statistics

    def stats_snapshot(self) -> dict:
        elapsed_ns = max((time.monotonic() - self._t0) * 1e9, 1.0)
        delivered = self._batches
        return {
            "workers": self.workers,
            "superstep_k": self._ss_k,
            "supersteps_dispatched": self._ss_supersteps,
            "superstep_decline": self._ss_decline,
            "superstep_scan_ms": self._ss_scan_ns / 1e6,
            "superstep_replay_ms": self._ss_replay_ns / 1e6,
            "ring_capacity": self.ring.capacity,
            "ring_depth_hwm": self.ring.hwm(),
            "rows_in": self._rows_in,
            "runs_in": self._runs_in,
            "rows_delivered": self._rows_out,
            "batches_delivered": delivered,
            "batches_overlapped": self._overlapped,
            "h2d_overlap_ratio": (self._overlapped / self._h2d_count
                                  if self._h2d_count else 0.0),
            "worker_utilization": (sum(self._worker_busy_ns)
                                   / (elapsed_ns * self.workers)),
            "stage_ms": {
                "decode": _stage_cell(sum(self._worker_decode_ns),
                                      sum(self._worker_runs)),
                "intern": _stage_cell(sum(self._worker_intern_ns),
                                      sum(self._worker_runs)),
                "h2d": _stage_cell(self._h2d_ns, self._h2d_count),
                "device": _stage_cell(self._device_ns, self._batches),
            },
        }


def _stage_cell(total_ns: int, count: int) -> dict:
    total_ms = total_ns / 1e6
    return {"total_ms": total_ms, "batches": count,
            "mean_ms": total_ms / count if count else 0.0}
