"""Output rate limiters (counterpart of siddhi_tpu/ops/ratelimit.py;
reference: core/query/output/ratelimit/ — `output [first|last|all] every N
events / T sec` and `output snapshot every T`).

A limiter is a `(state, out_batch, now) -> (state, emit_batch)` transform
after the selector. Its state is tensors on the query's device and `now`
is compared there, so a step reads nothing back.

- events-N first / last : a mask on each CURRENT lane's output ordinal (a
                          running count: K5b's ungrouped scan)
- events-N all, time-T all / last : CURRENT lanes are appended to a C-slot
                          ring (K13c append) and released at group / bucket
                          boundaries by a gather (K13c gather)
- time-T first          : the first lane of each newer bucket (K7 stable
                          argsort of the buckets)
- snapshot              : the latest row (one masked max); on a FIFO window
                          without aggregates the window's projected rows in
                          a ring (K13c), on a non-FIFO window the window's
                          own contents, grouped the last row of each group
                          (K13b)

Only CURRENT lanes are rate-limited; EXPIRED lanes pass with their CURRENT
counterparts (the reference sends whole chunks per emission).

K13c (csrc/k13c_limiter_ring.cu) moves the ring's rows; beside each
wrapper is its plain PyTorch version, which CPU tensors run. A CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import dtypes
from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from ..query_api.execution import OutputRate, OutputRateType
from .groupby import running_count
from .search import stable_radix_argsort
from .selector import GROUP_SLOT_COL
from .windows_extra import frequent_last_lane

_NEVER = 2**62  # the bucket key of lanes that are not newer


def _i64(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int64, device=device)


def _current(out: EventBatch) -> torch.Tensor:
    return out.valid & (out.types == int(EventType.CURRENT))


# --------------------------------------------------------------------------- #
# K13c: the ring append and the ring gather
# --------------------------------------------------------------------------- #


def ring_append_plain(ring: dict, src: dict, sel: torch.Tensor,
                      appended: torch.Tensor):
    """Plain K13c append, the JAX form: the selected lanes, ranked in lane
    order, set slot (appended % C + rank) % C of every ring column (the
    others drop into a spare row). Returns (new ring, the count added as
    an int64 0-d tensor)."""
    C = next(iter(ring.values())).shape[0]
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    slot = torch.where(sel, torch.remainder(torch.remainder(appended, C)
                                            + rank, C), C)
    new = {}
    for k, r in ring.items():
        ext = torch.cat([r, r.new_zeros(1)])
        ext[slot] = src[k]
        new[k] = ext[:-1]
    return new, sel.sum(dtype=torch.int64)


def _col_chunks(n: int):
    step = kernels.library("k13c_limiter_ring").k13c_max_cols()
    return [slice(c, c + step) for c in range(0, n, step)]


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _sizes(ts):
    return (ctypes.c_int * len(ts))(*[t.element_size() for t in ts])


def ring_append_cuda(ring: dict, src: dict, sel: torch.Tensor,
                     appended: torch.Tensor, *, counter: str):
    """K13c append on the card: the ring's columns are written in place.
    Returns (the ring, the count added as an int64 0-d device tensor)."""
    names = list(ring)
    dsts = [ring[k] for k in names]
    srcs = [src[k].contiguous() for k in names]
    kernels.require_cuda("ring_append", sel, appended, *dsts, *srcs)
    B = sel.shape[0]
    if (sel.dtype != torch.bool or sel.dim() != 1
            or appended.dtype != torch.int64 or appended.dim() != 0
            or not dsts
            or any(s.shape != (B,) for s in srcs)
            or any(d.dim() != 1 or d.shape != dsts[0].shape
                   or d.dtype != s.dtype for d, s in zip(dsts, srcs))):
        raise ValueError("ring_append: bool sel [B], int64 0-d appended, "
                         "batch columns [B] and ring columns [C] of one "
                         "dtype")
    C = dsts[0].shape[0]
    n = torch.zeros((), dtype=torch.int64, device=sel.device)
    if B == 0:
        return ring, n
    lib = "k13c_limiter_ring"
    block = kernels.library(lib).k13c_block_size()
    scratch = torch.empty(-(-B // block), dtype=torch.int32,
                          device=sel.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    rc = kernels.bind(lib, "k13c_rank", [P, I, P, P, P])(
        sel.data_ptr(), B, scratch.data_ptr(), n.data_ptr(),
        kernels.stream())
    kernels.check(lib, "ring_append (rank)", rc)
    kernels.LAUNCHES[counter] += 2
    scatter = kernels.bind(lib, "k13c_scatter_cols",
                           [P, I, P, P, ctypes.c_longlong, P, P, P, I, P])
    for part in _col_chunks(len(names)):
        rc = scatter(sel.data_ptr(), B, scratch.data_ptr(),
                     appended.data_ptr(), C, _ptrs(srcs[part]),
                     _ptrs(dsts[part]), _sizes(srcs[part]),
                     len(srcs[part]), kernels.stream())
        kernels.check(lib, "ring_append (scatter)", rc)
        kernels.LAUNCHES[counter] += 1
    return ring, n


def ring_append(ring: dict, src: dict, sel, appended, *, counter: str):
    """Append the `sel` lanes of `src` to the ring after its `appended`
    rows (K13c). `counter` names the launch counter of the calling site."""
    if sel.is_cuda:
        return ring_append_cuda(ring, src, sel, appended, counter=counter)
    return ring_append_plain(ring, src, sel, appended)


def ring_gather_plain(ring: dict, lo: torch.Tensor, n: torch.Tensor,
                      ring_valid: Optional[torch.Tensor] = None):
    """Plain K13c gather: lane i of the block is ring slot (lo % C + i) % C
    of every column, valid where i < n (and the ring's valid flag).
    Returns (columns [C], valid [C])."""
    C = next(iter(ring.values())).shape[0]
    i = torch.arange(C, dtype=torch.int64, device=lo.device)
    slot = torch.remainder(torch.remainder(lo, C) + i, C)
    valid = i < n
    if ring_valid is not None:
        valid = valid & ring_valid.index_select(0, slot)
    return {k: r.index_select(0, slot) for k, r in ring.items()}, valid


def ring_gather_cuda(ring: dict, lo: torch.Tensor, n: torch.Tensor,
                     ring_valid: Optional[torch.Tensor] = None, *,
                     counter: str):
    """K13c gather on the card: every column in one launch (per up to
    k13c_max_cols() columns); `lo` and `n` stay on the device."""
    names = list(ring)
    srcs = [ring[k] for k in names]
    extra = [ring_valid] if ring_valid is not None else []
    kernels.require_cuda("ring_gather", lo, n, *srcs, *extra)
    if (not srcs or lo.dtype != torch.int64 or n.dtype != torch.int64
            or lo.dim() != 0 or n.dim() != 0
            or any(s.dim() != 1 or s.shape != srcs[0].shape for s in srcs)
            or (ring_valid is not None
                and (ring_valid.dtype != torch.bool
                     or ring_valid.shape != srcs[0].shape))):
        raise ValueError("ring_gather: ring columns [C] (and a bool valid "
                         "[C]), int64 0-d lo and n")
    C = srcs[0].shape[0]
    outs = [torch.empty_like(s) for s in srcs]
    valid = torch.empty(C, dtype=torch.bool, device=lo.device)
    lib = "k13c_limiter_ring"
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    gather = kernels.bind(lib, "k13c_gather_cols",
                          [P, P, P, I, P, P, P, L, I, P, P])
    for j, part in enumerate(_col_chunks(len(names))):
        rc = gather(_ptrs(srcs[part]), _ptrs(outs[part]), _sizes(srcs[part]),
                    len(srcs[part]),
                    ring_valid.data_ptr() if ring_valid is not None else None,
                    lo.data_ptr(), n.data_ptr(), C, C,
                    valid.data_ptr() if j == 0 else None, kernels.stream())
        kernels.check(lib, "ring_gather", rc)
        kernels.LAUNCHES[counter] += 1
    return dict(zip(names, outs)), valid


def ring_gather(ring: dict, lo, n, ring_valid=None, *, counter: str):
    """The C rows of the ring from slot lo % C on, valid for the first n
    (K13c). `counter` names the launch counter of the calling site."""
    if lo.is_cuda:
        return ring_gather_cuda(ring, lo, n, ring_valid, counter=counter)
    return ring_gather_plain(ring, lo, n, ring_valid)


# --------------------------------------------------------------------------- #
# limiters
# --------------------------------------------------------------------------- #


class CounterState(NamedTuple):
    count: torch.Tensor  # int64 0-d


class BufferState(NamedTuple):
    ring: EventBatch  # [C] buffered lanes
    appended: torch.Tensor  # int64
    flushed: torch.Tensor  # int64
    bucket: torch.Tensor  # int64 current time bucket (time mode)


class RateLimiterOp:
    has_time_semantics = False

    def init_state(self, device):
        raise NotImplementedError

    def step(self, state, out: EventBatch, now):
        raise NotImplementedError


class PassThroughLimiter(RateLimiterOp):
    def init_state(self, device):
        return ()

    def step(self, state, out, now):
        return state, out


class EventOrdinalLimiter(RateLimiterOp):
    """first/last every N events: a mask on the output ordinal, a running
    count of the CURRENT lanes (K5b)."""

    def __init__(self, n: int, which: str):
        self.n = n
        self.which = which

    def init_state(self, device) -> CounterState:
        return CounterState(_i64(0, device))

    def step(self, state: CounterState, out: EventBatch, now):
        live = _current(out)
        counts, total = running_count(live, base=state.count,
                                      dtype=torch.int64,
                                      counter="K5b ordinal")
        ordinal = counts - 1  # count before the lane + its rank
        if self.which == "first":
            keep = live & (torch.remainder(ordinal, self.n) == 0)
        else:
            keep = live & (torch.remainder(ordinal + 1, self.n) == 0)
        return CounterState(total), out.where_valid(keep)


class BufferedLimiter(RateLimiterOp):
    """all-every-N-events and the time-driven variants: buffer CURRENT
    lanes in a ring (K13c append) and release them at group / bucket
    boundaries (K13c gather)."""

    def __init__(self, layout: dict, out_width: int, *,
                 n_events: Optional[int] = None,
                 time_ms: Optional[int] = None,
                 which: str = "all"):
        self.layout = layout
        self.B = out_width
        self.n_events = n_events
        self.time_ms = time_ms
        self.which = which
        self.has_time_semantics = time_ms is not None
        self.C = max(2 * out_width, (n_events or 1) * 2, 1024)

    def init_state(self, device) -> BufferState:
        C = self.C
        ring = EventBatch(
            ts=torch.zeros(C, dtype=dtypes.TS_DTYPE, device=device),
            cols={k: torch.zeros(C, dtype=dt, device=device)
                  for k, dt in self.layout.items()},
            valid=torch.zeros(C, dtype=torch.bool, device=device),
            types=torch.zeros(C, dtype=torch.int8, device=device))
        z = _i64(0, device)
        return BufferState(ring, z, z.clone(), z.clone())

    @staticmethod
    def _fields(b: EventBatch) -> dict:
        return {"__ts__": b.ts, **b.cols, "__valid__": b.valid,
                "__types__": b.types}

    def step(self, state: BufferState, out: EventBatch, now):
        C = self.C
        live = _current(out)
        ring, out_fields = self._fields(state.ring), self._fields(out)
        ring, n_new = ring_append(ring, {k: out_fields[k] for k in ring},
                                  live, state.appended,
                                  counter="K13c append")
        appended = state.appended + n_new

        if self.time_ms is not None:
            cur_bucket = int(now) // self.time_ms
            closing = state.bucket < cur_bucket
            flush_to = torch.where(closing, appended, state.flushed)
            if self.which == "last":
                # only the latest buffered lane when the bucket closes
                emit_from = torch.maximum(state.flushed, flush_to - 1)
            else:
                emit_from = state.flushed
            new_bucket = torch.clamp(state.bucket, min=cur_bucket)
        else:
            N = self.n_events
            flush_to = torch.div(appended, N, rounding_mode="floor") * N
            emit_from = state.flushed
            new_bucket = state.bucket

        # the ring keeps only the newest C appended lanes: a group or bucket
        # that collected more is cut to them (the JAX overflow clamp)
        emit_from = torch.clamp(torch.maximum(emit_from, appended - C),
                                min=0)
        n_emit = torch.clamp(flush_to - emit_from, min=0)
        rows, valid = ring_gather(
            {k: v for k, v in ring.items() if k != "__valid__"},
            emit_from, n_emit, ring["__valid__"], counter="K13c gather")
        emitted = EventBatch(
            ts=rows.pop("__ts__"), types=rows.pop("__types__"), cols=rows,
            valid=valid)
        new_ring = EventBatch(ts=ring["__ts__"], types=ring["__types__"],
                              valid=ring["__valid__"],
                              cols={k: ring[k] for k in self.layout})
        return BufferState(new_ring, appended, flush_to, new_bucket), emitted


class TimeFirstLimiter(RateLimiterOp):
    """first every T: the first output lane of each newer bucket passes
    at once (a stable argsort of the buckets: K7)."""

    has_time_semantics = False  # emission is arrival-driven

    def __init__(self, time_ms: int):
        self.T = time_ms

    def init_state(self, device) -> CounterState:
        return CounterState(_i64(-1, device))  # last emitted bucket

    def step(self, state: CounterState, out: EventBatch, now):
        live = _current(out)
        bucket = torch.div(out.ts, self.T, rounding_mode="floor")
        newer = live & (bucket > state.count)
        key = torch.where(newer, bucket, _NEVER)
        order = stable_radix_argsort(key, counter="K7 time-first").long()
        sk = key[order]
        first = torch.ones_like(newer)
        first[1:] = sk[1:] != sk[:-1]
        keep = torch.empty_like(newer)
        keep[order] = first & (sk != _NEVER)
        top = torch.where(keep, bucket, -1).max()
        return (CounterState(torch.maximum(state.count, top)),
                out.where_valid(keep))


class SnapshotState(NamedTuple):
    last_cols: dict  # [1] retained last output row
    has: torch.Tensor  # bool
    bucket: torch.Tensor  # int64 last observed time bucket


def _bucket_after(state_bucket, bucket: int):
    """The JAX `where(first, bucket, maximum(state.bucket, bucket))`."""
    return torch.where(state_bucket < 0, bucket,
                       torch.clamp(state_bucket, min=bucket))


class SnapshotLimiter(RateLimiterOp):
    """`output snapshot every <t>`: periodically re-emits the latest output
    row (reference: snapshot/ SnapshotOutputRateLimiter). Emission rides
    the watermark like every timer here."""

    has_time_semantics = True

    def __init__(self, layout: dict, time_ms: int):
        self.layout = layout
        self.T = time_ms

    def init_state(self, device) -> SnapshotState:
        return SnapshotState(
            last_cols={k: torch.zeros(1, dtype=dt, device=device)
                       for k, dt in self.layout.items()},
            has=torch.zeros((), dtype=torch.bool, device=device),
            bucket=_i64(-1, device))

    def step(self, state: SnapshotState, out: EventBatch, now):
        B = out.capacity
        dev = out.ts.device
        live = _current(out)
        last_i = torch.where(live, torch.arange(B, device=dev), -1).max()
        any_live = last_i >= 0
        g = torch.clamp(last_i, 0, B - 1).reshape(1)
        new_cols = {k: torch.where(any_live, out.cols[k].index_select(0, g),
                                   v)
                    for k, v in state.last_cols.items()}
        now = int(now)
        bucket = now // self.T
        # fire on a boundary crossing with the PRE-batch retained row
        fire = state.has & (state.bucket >= 0) & (state.bucket < bucket)
        emit = EventBatch(
            ts=torch.full((1,), now, dtype=torch.int64, device=dev),
            cols=state.last_cols, valid=fire.reshape(1),
            types=torch.zeros(1, dtype=torch.int8, device=dev))
        # the bucket advances on every crossing (idle heartbeats included)
        return SnapshotState(new_cols, state.has | any_live,
                             _bucket_after(state.bucket, bucket)), emit


class WindowedSnapshotState(NamedTuple):
    cols: dict  # {name: [Cap]} projected rows currently in the window
    appended: torch.Tensor  # int64 projected CURRENT rows ever
    expired: torch.Tensor  # int64 projected EXPIRED rows ever
    bucket: torch.Tensor  # int64 last observed time bucket
    overflow: torch.Tensor  # int64 live rows overwritten past capacity


class WindowedSnapshotLimiter(RateLimiterOp):
    """`output snapshot every <t>` on a non-aggregated FIFO-window query:
    each tick re-emits every event in the window (reference:
    snapshot/WindowedPerSnapshotOutputRateLimiter.java). A FIFO ring of the
    projected rows: CURRENT lanes append (K13c append), EXPIRED lanes pop
    the front, a tick gathers the window as of its boundary (K13c
    gather)."""

    has_time_semantics = True

    def __init__(self, layout: dict, time_ms: int, capacity: int):
        self.layout = layout
        self.T = time_ms
        self.Cap = capacity
        self.chunk_width = capacity

    def init_state(self, device) -> WindowedSnapshotState:
        z = _i64(0, device)
        return WindowedSnapshotState(
            cols={k: torch.zeros(self.Cap, dtype=dt, device=device)
                  for k, dt in self.layout.items()},
            appended=z, expired=z.clone(), bucket=_i64(-1, device),
            overflow=z.clone())

    def step(self, state: WindowedSnapshotState, out: EventBatch, now):
        Cap = self.Cap
        dev = out.ts.device
        cur = _current(out)
        exp = out.valid & (out.types == int(EventType.EXPIRED))
        new_cols, n_cur = ring_append(
            state.cols, {k: out.cols[k] for k in state.cols}, cur,
            state.appended, counter="K13c snapshot append")
        n_exp = exp.sum(dtype=torch.int64)
        appended1 = state.appended + n_cur
        expired1 = state.expired + n_exp
        over0 = torch.clamp(state.appended - state.expired - Cap, min=0)
        over1 = torch.clamp(appended1 - expired1 - Cap, min=0)

        # the snapshot shows the window AS OF the newest crossed boundary:
        # this chunk's adds / removes stamped at or before it apply
        now = int(now)
        bucket = now // self.T
        fire = (state.bucket >= 0) & (state.bucket < bucket)
        at_boundary = out.ts <= bucket * self.T
        n_exp_pre = (exp & at_boundary).sum(dtype=torch.int64)
        n_cur_pre = (cur & at_boundary).sum(dtype=torch.int64)
        lo = state.expired + n_exp_pre
        winlen = state.appended + n_cur_pre - lo
        cols, valid = ring_gather(new_cols, lo,
                                  torch.where(fire, winlen, 0),
                                  counter="K13c snapshot gather")
        emit = EventBatch(
            ts=torch.full((Cap,), now, dtype=torch.int64, device=dev),
            cols=cols, valid=valid,
            types=torch.zeros(Cap, dtype=torch.int8, device=dev))
        return WindowedSnapshotState(
            cols=new_cols, appended=appended1, expired=expired1,
            bucket=_bucket_after(state.bucket, bucket),
            overflow=state.overflow + torch.clamp(over1 - over0, min=0),
        ), emit


class ContentsSnapshotState(NamedTuple):
    bucket: torch.Tensor  # int64 last observed time bucket


class ContentsSnapshotLimiter(RateLimiterOp):
    """`output snapshot every <t>` on a non-aggregated query over a non-FIFO
    window (sort/session/frequent/cron/hopping/expression): per-arrival
    output is suppressed; each tick re-emits the projection of the window's
    live contents, as of the watermark that crossed the boundary."""

    has_time_semantics = True
    #: the query step calls step_contents with the projected window
    #: contents instead of step()
    needs_window_contents = True

    def __init__(self, time_ms: int):
        self.T = time_ms

    def init_state(self, device) -> ContentsSnapshotState:
        return ContentsSnapshotState(bucket=_i64(-1, device))

    def step(self, state, out, now):
        raise SiddhiAppCreationError(
            "ContentsSnapshotLimiter needs window contents")

    def step_contents(self, state: ContentsSnapshotState,
                      contents: EventBatch, now):
        """`contents.ts` carries each live row's arrival instant: rows that
        arrived past the fired boundary are left out of its snapshot."""
        now = int(now)
        bucket = now // self.T
        fire = (state.bucket >= 0) & (state.bucket < bucket)
        emit = dataclasses.replace(
            contents, ts=torch.full_like(contents.ts, now),
            valid=contents.valid & fire & (contents.ts <= bucket * self.T))
        return ContentsSnapshotState(_bucket_after(state.bucket, bucket)), \
            emit


class GroupedSnapshotState(NamedTuple):
    rows: dict  # [G] retained last row per group, per column
    present: torch.Tensor  # bool[G]
    bucket: torch.Tensor  # int64 last observed time bucket
    overflow: torch.Tensor  # int32 lanes whose group slot exceeded G


class GroupedSnapshotLimiter(RateLimiterOp):
    """`output snapshot every <t> ... group by k`: periodically re-emits the
    latest output row of every group (reference:
    snapshot/GroupByPerSnapshotOutputRateLimiter.java). The selector rides
    each lane's group slot on GROUP_SLOT_COL; the last live lane of each
    slot is kept (K13b's order-free atomicMax). Groups beyond
    config.snapshot_group_capacity are dropped and counted."""

    has_time_semantics = True

    def __init__(self, layout: dict, time_ms: int, n_groups: int,
                 group_capacity: int):
        self.layout = layout
        self.T = time_ms
        # the selector's overflow sentinel slot is group_capacity: bounding
        # G by it keeps phantom sentinel rows out of snapshots
        self.G = min(n_groups, group_capacity)

    def init_state(self, device) -> GroupedSnapshotState:
        G = self.G
        return GroupedSnapshotState(
            rows={k: torch.zeros(G, dtype=dt, device=device)
                  for k, dt in self.layout.items()},
            present=torch.zeros(G, dtype=torch.bool, device=device),
            bucket=_i64(-1, device),
            overflow=torch.zeros((), dtype=torch.int32, device=device))

    def step(self, state: GroupedSnapshotState, out: EventBatch, now):
        G = self.G
        dev = out.ts.device
        slots = out.cols[GROUP_SLOT_COL]
        cur = _current(out)
        live = cur & (slots < G) & (slots >= 0)
        now = int(now)
        bucket = now // self.T
        # fire with the PRE-batch retained rows
        fire = (state.bucket >= 0) & (state.bucket < bucket)
        emit = EventBatch(
            ts=torch.full((G,), now, dtype=torch.int64, device=dev),
            cols=dict(state.rows), valid=state.present & fire,
            types=torch.zeros(G, dtype=torch.int8, device=dev))
        # retain the LAST live lane of each slot; `present` rides as the
        # row's last column (True from every live lane)
        dest = torch.where(live, slots, G).to(torch.int32)
        rows, present = frequent_last_lane(
            dest, {k: out.cols[k] for k in state.rows},
            torch.ones_like(live), state.rows, state.present, G,
            counter="K13b grouped snapshot")
        return GroupedSnapshotState(
            rows=rows, present=present,
            bucket=_bucket_after(state.bucket, bucket),
            overflow=state.overflow + (cur & (slots >= G)).sum(
                dtype=torch.int32)), emit


def make_rate_limiter(rate: Optional[OutputRate], layout: dict,
                      out_width: int, grouped: bool = False,
                      group_capacity: int = 1 << 20,
                      fifo_window: bool = False,
                      has_aggregates: bool = False,
                      window_capacity: int = 0,
                      contents_window: bool = False) -> RateLimiterOp:
    if rate is None:
        return PassThroughLimiter()
    if rate.type == OutputRateType.SNAPSHOT:
        if rate.time_ms is None:
            raise SiddhiAppCreationError(
                "`output snapshot every ...` needs a time period")
        if fifo_window and not has_aggregates:
            # the full window contents each tick; Cap = the window's own
            # capacity when known, never below the per-step chunk width
            # (the append slot math wraps at most once)
            cap = max(window_capacity
                      or dtypes.config.snapshot_window_capacity, out_width)
            return WindowedSnapshotLimiter(layout, rate.time_ms, cap)
        if contents_window and not has_aggregates:
            return ContentsSnapshotLimiter(rate.time_ms)
        if grouped:
            return GroupedSnapshotLimiter(
                layout, rate.time_ms, dtypes.config.snapshot_group_capacity,
                group_capacity)
        return SnapshotLimiter(layout, rate.time_ms)
    if rate.event_count is not None:
        n = rate.event_count
        kind = rate.type.value  # all | first | last
        if kind in ("first", "last"):
            return EventOrdinalLimiter(n, kind)
        return BufferedLimiter(layout, out_width, n_events=n)
    t = rate.time_ms
    kind = rate.type.value
    if kind == "first":
        return TimeFirstLimiter(t)
    return BufferedLimiter(layout, out_width, time_ms=t, which=kind)
