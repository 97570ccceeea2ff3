"""Device-resident supersteps: K ingress chunks per dispatch (counterpart
of siddhi_tpu/core/superstep.py).

The async ingress feeder (core/ingress.py) stages K consecutive full
chunks in one host block, and the runner here moves the block to the
device with ONE copy, then runs the whole eligible query chain — every
runtime reachable from the ingress junction through scannable junctions —
K times in order, each step updating its state in place as the per-batch
path does. Each emitting node's published form (`_select_event_type`) is
copied into `[K, W]` stacks; one K12b pack per emitting slot then compacts
every valid row, in (iteration, lane) order, with the per-iteration counts
into one device buffer, and one copy moves it to pinned host memory.

The states are written back before any replay. The replay goes through
the K iterations in order and re-publishes slice k exactly where the
per-batch path would have: a terminal junction's callbacks take slice k of
the packed host buffer (with `async_callbacks=True` the K slices share the
one readback, and the decoder waits on its copy once); a junction with
device receivers gets a batch rebuilt from that slice through
`publish_batch`. Statistics, the per-query maintenance
(`_post_step_maintenance`) and the join drop accounting replay per k.
Rows are bit-identical to K = 1: the compaction keeps lane order and no
reader looks at an invalid lane.

Eligibility is decided at the first staged superstep by a walk from the
ingress junction and revalidated cheaply per dispatch; an ineligible plan
declines loudly (one log line and `stats_snapshot()["superstep_decline"]`)
and the per-batch path runs from then on. The knob is
`@app:superstep(k=)` / SIDDHI_SUPERSTEP_K (core/app_runtime.py).

No CUDA graph: each step takes `now` as a Python int and uses it in tensor
arithmetic, so a captured graph would replay the `now` of its capture.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..ops.superstep_pack import PackedHost, superstep_pack
from ..query_api.definition import AttributeType
from ..query_api.execution import EventTrigger, OutputAction
from .event import EventBatch
from .stream import _HostReceiver, StreamJunction

# ----------------------------------------------------------- decline taxonomy
DECLINE_RECEIVER = "receiver is not a scannable query/join/shared-group"
DECLINE_BREAKER = "query has a circuit breaker"
DECLINE_FAULT = "fault-stream query"
DECLINE_OBJECT = "OBJECT-typed attributes have no scannable layout"
DECLINE_TABLE = "table dependency or input fallback"
DECLINE_CALLBACK = "query callbacks attached"
DECLINE_HOST_SLOT = "host uuid()/unionSet() selector slots"
DECLINE_ACTION = "non-INSERT output action (table executor)"
DECLINE_PARTITION = "partitioned query"
DECLINE_JOIN_BUILD = "join build side is a table/named-window/aggregation"
DECLINE_JOIN_TRIGGER = "join side does not trigger output"
DECLINE_JUNCTION = "junction has taps/event-time gate/redirect/error handler/WAL"
DECLINE_FAN_IN = "fan-in: junction fed by multiple scanned producers"
DECLINE_PLAYBACK = "playback clock advances per delivery"
DECLINE_EMPTY = "no receivers on the async stream"


class _Decline(Exception):
    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class _Node:
    """One step of the chain: a QueryRuntime or one triggering join side.
    `parent` is the node whose published output feeds it (-1: the ingress
    chunk); `cap` the capacity its input is padded to, as the per-batch
    receiver pads it."""

    __slots__ = ("kind", "qr", "name", "parent", "children", "cap",
                 "pad_always", "etype", "out_junction", "step")

    def __init__(self, kind: str, qr, parent: int, cap: int,
                 pad_always: bool, step) -> None:
        self.kind = kind
        self.qr = qr
        self.name = qr.name
        self.parent = parent
        self.children: list[int] = []
        self.cap = cap
        self.pad_always = pad_always
        self.etype = qr.query.output_stream.event_type
        self.out_junction = qr.output_junction
        self.step = step


# ------------------------------------------------------------ eligibility


def _host_slots(qr) -> bool:
    return bool(qr.selector.host_uuid_slots
                or getattr(qr.selector, "host_set_slots", None))


def _query_decline(qr) -> Optional[str]:
    """Why this QueryRuntime cannot run in a superstep (None: it can). A
    partition's inner query runs under its partition's routing. Circuit
    breakers are not ported yet: their check (DECLINE_BREAKER) comes with
    them."""
    if getattr(qr, "_partitioned", False):
        return DECLINE_PARTITION
    if qr.query.input_stream.is_fault:
        return DECLINE_FAULT
    if any(a.type == AttributeType.OBJECT
           for a in qr.input_junction.definition.attributes):
        return DECLINE_OBJECT
    if qr.dep_tables:
        return DECLINE_TABLE
    if qr.callbacks:
        return DECLINE_CALLBACK
    if _host_slots(qr):
        return DECLINE_HOST_SLOT
    if qr.query.output_stream.action != OutputAction.INSERT or \
            qr.table_executor is not None:
        return DECLINE_ACTION
    return None


def _join_decline(r) -> Optional[str]:
    """Why this join side cannot run in a superstep. Only stream-stream
    joins whose scanned side triggers output are eligible."""
    qr = r.runtime
    side = qr.left if r.from_left else qr.right
    build = qr.right if r.from_left else qr.left
    triggers = (qr.trigger == EventTrigger.ALL
                or (qr.trigger == EventTrigger.LEFT and r.from_left)
                or (qr.trigger == EventTrigger.RIGHT and not r.from_left))
    if not triggers:
        return DECLINE_JOIN_TRIGGER
    if build.is_table or build.is_named_window or build.is_aggregation:
        return DECLINE_JOIN_BUILD
    if qr.callbacks:
        return DECLINE_CALLBACK
    if _host_slots(qr):
        return DECLINE_HOST_SLOT
    if qr.query.output_stream.action != OutputAction.INSERT or \
            qr.table_executor is not None:
        return DECLINE_ACTION
    if side.junction is not None and any(
            a.type == AttributeType.OBJECT
            for a in side.junction.definition.attributes):
        return DECLINE_OBJECT
    return None


def _junction_decline(j) -> Optional[str]:
    """Taps are the port's only junction feature a superstep cannot replay
    (event-time gates, redirects, error handlers and the WAL are not
    ported yet)."""
    return DECLINE_JUNCTION if j.taps else None


def _sink_dark(j) -> bool:
    """True when publishing to `j` is a no-op, as the per-batch
    `_distribute` decides it: no receivers."""
    return not j.receivers


class _PackedReadback:
    """One emitting slot's packed superstep on its way to the host: the
    pinned buffer and the copy's event, waited on once, shared by the K
    slices."""

    def __init__(self, host: torch.Tensor, layout, event) -> None:
        self._host = host
        self.layout = layout
        self._event = event
        self._lock = threading.Lock()
        self._packed: Optional[PackedHost] = None
        self._slices: dict = {}

    def packed(self) -> PackedHost:
        with self._lock:
            if self._packed is None:
                if self._event is not None:
                    self._event.synchronize()  # releases the GIL
                self._packed = PackedHost(self._host.numpy(), self.layout)
                self._host = None
            return self._packed

    def slice(self, k: int):
        packed = self.packed()
        with self._lock:
            if k not in self._slices:
                self._slices[k] = packed.slice(k)
            return self._slices[k]


class _SliceReadback:
    """Slice k of a packed superstep, with the surface of ops/wire.py's
    Readback: `result()` (any thread) waits for the one copy."""

    def __init__(self, shared: _PackedReadback, k: int) -> None:
        self._shared = shared
        self._k = k

    def result(self):
        return self._shared.slice(self._k)


class SuperstepRunner:
    """One runner per async ingress junction, built at the first staged
    superstep. `dispatch(block)` returns False when this superstep must go
    through the per-batch path (the plan no longer matches the topology)."""

    def __init__(self, pipeline, k: int) -> None:
        self.pipeline = pipeline
        self.j = pipeline.j
        self.ctx = pipeline.ctx
        self.k = int(k)
        self.nodes: list[_Node] = []
        self.roots: list[int] = []
        self._build_plan()
        self._junctions = [self.j] + [n.out_junction for n in self.nodes
                                      if n.children]
        self._snaps = [tuple(id(r) for r in j.receivers)
                       for j in self._junctions]
        self._emit_flags = self._current_emit_flags()

    # ------------------------------------------------------------ plan build

    def _build_plan(self) -> None:
        if self.ctx.timestamp_generator.playback:
            raise _Decline(DECLINE_PLAYBACK)
        if not self.j.receivers:
            raise _Decline(DECLINE_EMPTY)
        why = _junction_decline(self.j)
        if why:
            raise _Decline(why)
        self._add_receivers(self.j, -1, {id(self.j)}, require=True)
        if not self.nodes:
            raise _Decline(DECLINE_EMPTY)
        self.roots = [i for i, n in enumerate(self.nodes) if n.parent < 0]

    def _add_receivers(self, j, parent: int, claimed: set,
                       require: bool) -> bool:
        """Take every receiver of `j` into the plan. At the ingress
        junction (require=True) an ineligible receiver declines the whole
        plan; at a chain junction the parent stays terminal instead.
        Fan-in onto a claimed junction always declines: replayed
        deliveries would reorder against the in-chain consumption."""
        from .join_runtime import _JoinSideReceiver
        from .query_runtime import QueryRuntime
        mark = len(self.nodes)
        added: list[int] = []
        try:
            for r in list(j.receivers):
                if type(r) is QueryRuntime:
                    why = _query_decline(r)
                    if why:
                        raise _Decline(f"{r.name}: {why}")
                    node = _Node("query", r, parent, r._batch_cap,
                                 not r.window.shape_polymorphic, r.step)
                elif isinstance(r, _JoinSideReceiver):
                    qr = r.runtime
                    why = _join_decline(r)
                    if why:
                        raise _Decline(f"{qr.name}: {why}")
                    side = qr.left if r.from_left else qr.right
                    node = _Node("join", qr, parent, side.junction.batch_size,
                                 True, (qr._step_left if r.from_left
                                        else qr._step_right))
                else:
                    raise _Decline(
                        f"{type(r).__name__}: {DECLINE_RECEIVER}")
                self.nodes.append(node)
                added.append(len(self.nodes) - 1)
                if parent >= 0:
                    self.nodes[parent].children.append(len(self.nodes) - 1)
            # run through each added node's output junction when every one
            # of ITS receivers is eligible too
            for idx in added:
                oj = self.nodes[idx].out_junction
                if not isinstance(oj, StreamJunction) or not oj.receivers:
                    continue  # a table/window adapter consumes terminally
                if id(oj) in claimed:
                    raise _Decline(DECLINE_FAN_IN)
                if _junction_decline(oj):
                    continue  # terminal: the replay publishes into it
                claimed.add(id(oj))
                if not self._add_receivers(oj, idx, claimed, require=False):
                    claimed.discard(id(oj))
            return True
        except _Decline as d:
            if require or d.reason == DECLINE_FAN_IN:
                raise
            del self.nodes[mark:]
            if parent >= 0:
                self.nodes[parent].children = [
                    c for c in self.nodes[parent].children if c < mark]
            return False

    def _current_emit_flags(self) -> tuple:
        """Per node: is its terminal output observed? Nodes whose output
        the chain consumes never deliver terminally."""
        return tuple(not n.children and n.out_junction is not None
                     and not _sink_dark(n.out_junction)
                     for n in self.nodes)

    # -------------------------------------------------------------- dispatch

    def revalidate(self) -> bool:
        """The chain's topology (receiver lists, callbacks) still matches
        the plan; False: the caller delivers per batch and rebuilds."""
        for j, snap in zip(self._junctions, self._snaps):
            if tuple(id(r) for r in j.receivers) != snap:
                return False
        return not any(n.qr.callbacks or _host_slots(n.qr)
                       for n in self.nodes)

    def _prepare(self, node: _Node, batch: EventBatch) -> EventBatch:
        if batch.capacity < node.cap and node.pad_always:
            return batch.pad_to(node.cap)
        return batch

    def dispatch(self, block) -> int:
        """Run one superstep over the K chunks of `block` (feeder thread,
        controller lock not held). Returns how many leading chunks it
        consumed: K, or 0 when the plan no longer matches the topology and
        the caller delivers every chunk per batch.

        An error of the app's own step at iteration k leaves iterations
        0..k-1 applied in place: their outputs are packed and replayed, the
        failing chunk's rows are counted as dropped (Statistics
        `ingress_dropped[stream]["superstep.error"]`, its partial state
        change cannot be undone), and the error is raised with
        `superstep_consumed = k + 1` so that the caller delivers the
        chunks after it per batch. A kernel fault (kernels.KernelError)
        propagates as it is."""
        if not self.revalidate():
            return 0
        self._emit_flags = self._current_emit_flags()
        pipe, ctx, K = self.pipeline, self.ctx, self.k
        dev = pipe.upload(block, 0, K)  # one host-to-device copy
        with ctx.controller_lock:
            # staged (sync-path) rows first: arrival order
            for cj in self._junctions:
                if cj._staged_rows or cj._tap_queue:
                    cj.flush()
            now = ctx.timestamp_generator.current_time()
            d0 = time.perf_counter_ns()
            stacks, drops, done, err = self._run(dev, now)
            consumed = K if err is None else done + 1
            try:
                if err is not None:
                    ctx.statistics.track_ingress_drop(
                        self.j.definition.id, "superstep.error",
                        self.j.batch_size)
                readbacks = {i: self._readback(*st)
                             for i, st in stacks.items()}
                scan_ns = time.perf_counter_ns() - d0
                pipe._ss_scan_ns += scan_ns
                self._replay(readbacks, drops, now, scan_ns, done)
            except Exception as e:
                e.superstep_consumed = consumed  # type: ignore[attr-defined]
                raise
            spent = time.perf_counter_ns() - d0
            pipe._ss_replay_ns += spent - scan_ns
            pipe._device_ns += spent
            pipe._batches += done
            pipe._rows_out += done * self.j.batch_size
        if err is not None:
            err.superstep_consumed = consumed  # type: ignore[attr-defined]
            raise err
        return K

    def _run(self, dev: torch.Tensor, now: int):
        """The K iterations of the chain; the states are written back at
        the end. Returns each emitting node's [K, W] stacks, each join
        node's summed drop count, the iterations that finished and the
        app's step error that stopped the next one (None: all K ran)."""
        nodes, flags, K = self.nodes, self._emit_flags, self.k
        states = {id(n.qr): n.qr.state for n in nodes}
        drops: list = [None] * len(nodes)
        stacks: dict = {}
        from .query_runtime import _select_event_type
        done, err = 0, None
        try:
            for k in range(K):
                ingress = self.pipeline.batch_of(dev, k)
                fwds: dict = {}
                for i, node in enumerate(nodes):
                    inp = ingress if node.parent < 0 else fwds[node.parent]
                    inp = self._prepare(node, inp)
                    key = id(node.qr)
                    if node.kind == "join":
                        states[key], out, dropped = node.step(states[key],
                                                              inp, now)
                        if dropped is not None:
                            drops[i] = (dropped if drops[i] is None
                                        else drops[i] + dropped)
                    else:
                        states[key], out = node.step(states[key], inp, now)
                    if node.children:
                        fwds[i] = _select_event_type(out, node.etype)
                    elif flags[i]:
                        _stack_row(stacks, i, k, K,
                                   _select_event_type(out, node.etype))
                done = k + 1
        except kernels.KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — the app's own step error
            err = e
            for _, _, valid in stacks.values():
                valid[done:] = False  # the failing iteration's partial rows
        finally:
            for n in nodes:  # every state back before any replay
                n.qr.state = states[id(n.qr)]
        return stacks, drops, done, err

    def _readback(self, ts, cols, valid) -> _PackedReadback:
        """K12b pack of one emitting slot and its one copy to the host."""
        buf, layout = superstep_pack(ts, valid, cols)
        if not buf.is_cuda:
            return _PackedReadback(buf, layout, None)
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _PackedReadback(host, layout, event)

    # ---------------------------------------------------------------- replay

    def _replay(self, readbacks: dict, drops: list, now: int,
                scan_ns: int, done: int) -> None:
        """Per-iteration host fan-out of the first `done` iterations in the
        nesting order of as many per-batch deliveries: statistics, terminal
        publishes, per-query maintenance, join drop accounting."""
        stats = self.ctx.statistics
        decoder = self.ctx.decoder
        share = scan_ns // max(done * len(self.nodes), 1)
        sid = self.j.definition.id

        def deliver(i: int, k: int) -> None:
            oj = self.nodes[i].out_junction
            shared = readbacks[i]
            host_only = (isinstance(oj, StreamJunction) and not oj.taps
                         and all(isinstance(r, _HostReceiver)
                                 for r in oj.receivers))
            if host_only:
                if oj._staged_rows or oj._tap_queue:
                    oj.flush()
                stats.track_batch(oj.definition.id)
                rb = _SliceReadback(shared, k)
                for r in oj.receivers:
                    if decoder is not None:
                        decoder.submit(r, rb, now)
                    else:
                        r.on_host(rb.result(), now)
                return
            # device receivers: a batch rebuilt from slice k, padded to
            # the junction's lane bucket (or the slot's width when a step
            # emits wider than the junction's batch)
            sl = shared.slice(k)
            c = sl.count
            W = shared.layout.W
            pcap = oj._pad_cap(c) if isinstance(oj, StreamJunction) else W
            if pcap < c:
                pcap = W
            ts = np.zeros(pcap, dtype=np.int64)
            if c:
                ts[:c] = sl.ts
                ts[c:] = sl.ts[-1]  # monotone pad
            cols = {}
            for name, v in sl.cols.items():
                col = np.zeros(pcap, dtype=v.dtype)
                col[:c] = v
                cols[name] = col
            oj.publish_batch(EventBatch.from_numpy(ts, cols, c,
                                                   self.ctx.device), now)

        def replay_node(i: int, k: int) -> None:
            node = self.nodes[i]
            if self._emit_flags[i]:
                deliver(i, k)
            if node.children:
                stats.track_batch(node.out_junction.definition.id)
                for c in node.children:
                    replay_node(c, k)
            stats.track_latency(node.name, share)
            if node.kind == "query":
                node.qr._post_step_maintenance()
                return
            # join: the superstep summed its drops, so the total lands once
            # (k = 0) and the warning cadence advances per k
            qr = node.qr
            if k == 0 and drops[i] is not None:
                qr._dropped_dev = (drops[i] if qr._dropped_dev is None
                                   else qr._dropped_dev + drops[i])
            qr._drop_checks += 1
            from .join_runtime import _DROP_CHECK_EVERY
            if (not qr._drop_warned and qr._dropped_dev is not None
                    and qr._drop_checks % _DROP_CHECK_EVERY == 0):
                n = int(qr._dropped_dev)
                if n > 0:
                    warnings.warn(
                        f"join {qr.name!r}: {n} matched pairs exceeded the "
                        "per-step pair block or the per-probe candidate "
                        "walk and were dropped — raise "
                        "config.join_pair_cap_factor / "
                        "config.join_max_matches", stacklevel=2)
                    qr._drop_warned = True

        for k in range(done):
            stats.track_batch(sid)
            for r in self.roots:
                replay_node(r, k)


def _stack_row(stacks: dict, i: int, k: int, K: int,
               out: EventBatch) -> None:
    """Copy iteration k's published output of node i into its [K, W]
    stacks (a step may update its output's tensors in place at the next
    iteration). A wider output than the stacks so far widens them; lanes
    past an iteration's width are invalid."""
    w = out.capacity
    st = stacks.get(i)
    if st is None or st[0].shape[1] < w:
        dev = out.ts.device
        ts = torch.zeros((K, w), dtype=torch.int64, device=dev)
        valid = torch.zeros((K, w), dtype=torch.bool, device=dev)
        cols = {n: torch.zeros((K, w), dtype=c.dtype, device=dev)
                for n, c in out.cols.items()}
        if st is not None:
            old = st[0].shape[1]
            ts[:, :old] = st[0]
            valid[:, :old] = st[2]
            for n in cols:
                cols[n][:, :old] = st[1][n]
        st = stacks[i] = (ts, cols, valid)
    ts, cols, valid = st
    ts[k, :w] = out.ts
    valid[k, :w] = out.valid
    if w < valid.shape[1]:
        valid[k, w:] = False
    for n, c in out.cols.items():
        cols[n][k, :w] = c


def build_runner(pipeline, k: int):
    """Feeder entry point: (runner, None) or (None, decline reason)."""
    try:
        return SuperstepRunner(pipeline, k), None
    except _Decline as d:
        return None, d.reason
