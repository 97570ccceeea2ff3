"""Additional window operators (counterpart of
siddhi_tpu/ops/windows_extra.py): cron, hopping, frequent, lossyFrequent
and the keyed session window.

Reference: core/query/processor/stream/window/ — CronWindowProcessor.java
(quartz-driven tumble), HoppingWindowProcessor.java (emit every hop the
events of the last windowTime), FrequentWindowProcessor.java (Misra-Gries
counters, evicted keys emit EXPIRED), LossyFrequentWindowProcessor.java
(lossy counting with support/error bounds), SessionWindowProcessor.java
with a session key.

Batched divergences, as in the JAX package: counter updates happen at
micro-batch granularity, and several boundary crossings inside one batch
collapse into the latest one.

Kernels: the frequent windows' int64 key sorts are K7
(csrc/k7_radix_sort.cu, `k7_argsort_i64`), the free-slot order K1, and the
last arriving lane of each slot — a scatter-max over conflicting writes —
K13b (csrc/k13b_frequent.cu). The keyed session's two stable argsorts
(arrivals grouped by key slot; the oldest-first top-E of the ring's closed
rows) are K7. The cron and hopping windows are elementwise work on a ring.
"""

from __future__ import annotations

import bisect
import ctypes
from datetime import datetime, timedelta, timezone
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import dtypes
from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from ..query_api.definition import AttributeType
from .groupby import _scatter_drop, _segment_starts_index, hash_columns
from .search import (searchsorted32, stable_partition_order,
                     stable_radix_argsort)
from .windows import (BIG, WindowOp, _empty_like_cols, _ring_live_mask,
                      _scatter_append, compact)


def _types(kind: EventType, n: int, device) -> torch.Tensor:
    return torch.full((n,), int(kind), dtype=torch.int8, device=device)


# --------------------------------------------------------------------------- #
# cron
# --------------------------------------------------------------------------- #


class CronState(NamedTuple):
    """The JAX CronState's fields; rings are [C + 1] (spare row last)."""

    ring_cols: dict
    ring_ts: torch.Tensor
    appended: torch.Tensor  # int64 total arrivals
    flushed: torch.Tensor  # int64 arrivals already emitted
    prev_start: torch.Tensor  # int64 start of the previous flush
    next_fire: torch.Tensor  # int64 epoch ms of the next fire, -1 unset


def _gather_overall(ring_cols, ring_ts, comp_cols, comp_ts, appended0,
                    o_idx):
    """Events by overall arrival index (the JAX `_gather_overall`): from
    the ring below `appended0`, from the compacted batch above it."""
    C = ring_ts.shape[0] - 1
    B = comp_ts.shape[0]
    from_batch = o_idx >= appended0
    ring_slot = torch.remainder(torch.clamp(o_idx, min=0), C)
    batch_slot = torch.clamp(o_idx - appended0, 0, B - 1)
    cols = {k: torch.where(from_batch, comp_cols[k][batch_slot],
                           ring_cols[k][ring_slot]) for k in ring_cols}
    ts = torch.where(from_batch, comp_ts[batch_slot], ring_ts[ring_slot])
    return cols, ts


class CronFireTable:
    """The JAX step's next-fire answers, kept on the device.

    The JAX window asks the host `schedule.next_fire_ms(t)` inside its step
    (a pure_callback): for the lazy first schedule at t = (smallest valid
    timestamp - 1), which only the device knows, and after a fire at t =
    now. That answer is a step function of t: it reads t's local wall time
    L(t) and changes only where L(t) equals a fire's wall time (twice in a
    repeated fall-back hour, where the answer is the first occurrence and
    may lie before t) or where L jumps (a DST change). The host lists those
    instants from the latest fire at or before the clock on, with the
    answer at each, and uploads both (pinned, non-blocking: no host sync);
    each lookup is then exact:
      - after a fire: on the host, by bisection;
      - the lazy first schedule: a searchsorted on the device. An instant
        before the first listed fire takes the answer just before it: a
        fire at or before the clock, so both fire at once and the fired
        state does not keep the value (or, with no earlier fire, the first
        fire itself).
    A clock outside the listed range rebuilds the table around it."""

    F = 256  # fires a table spans (at most SPAN_S seconds of them)
    SPAN_S = 400 * 86400
    LOOKBACK_S = 1 << 30  # how far back the latest fire is looked for
    PROBE_S = 6 * 3600  # DST changes are found between probes this close

    def __init__(self, schedule):
        self.schedule = schedule
        self.at: list = []  # instants where the answer changes (ms)
        self.answer: list = []  # next_fire_ms at each of them
        self.device: Optional[torch.Tensor] = None  # [2, n]: at, answer

    @staticmethod
    def _offset(t: int):
        """Local wall time minus UTC at second t."""
        return (datetime.fromtimestamp(t)
                - datetime.fromtimestamp(t, timezone.utc).replace(tzinfo=None))

    def _changes(self, lo: int, hi: int) -> list:
        """The seconds in (lo, hi] where the UTC offset changes."""
        out = []
        grid = list(range(lo, hi, self.PROBE_S)) + [hi]
        for a, b in zip(grid, grid[1:]):
            if self._offset(a) == self._offset(b):
                continue
            while b - a > 1:  # first second with b's offset
                m = (a + b) // 2
                if self._offset(m) == self._offset(a):
                    a = m
                else:
                    b = m
            out.append(b)
        return out

    def _latest_local_fire(self, now_s: int):
        wall = datetime.fromtimestamp(now_s)
        d = 1
        while d <= self.LOOKBACK_S:
            f = self.schedule.next_fire_local(wall - timedelta(seconds=d))
            if f is not None and f <= wall:
                while (g := self.schedule.next_fire_local(
                        f + timedelta(seconds=1))) is not None and g <= wall:
                    f = g
                return f
            d *= 2
        return self.schedule.next_fire_local(wall)  # no fire before

    def _build(self, now: int) -> None:
        def stamp(w: datetime, fold: int) -> int:
            return int(w.replace(fold=fold).timestamp()) * 1000

        walls = []
        w = self._latest_local_fire(now // 1000)
        while w is not None and len(walls) < self.F:
            walls.append(w)
            if stamp(w, 0) - stamp(walls[0], 0) > self.SPAN_S * 1000:
                break
            w = self.schedule.next_fire_local(w + timedelta(seconds=1))
        at = {stamp(w, f) for w in walls for f in (0, 1)} | {now}
        lo, hi = min(at), max(at)
        if hi <= now:  # no listed fire after the clock
            hi = now + 1
            at.add(hi)
        at.update(s * 1000 for s in self._changes(lo // 1000, hi // 1000))
        at = sorted(a for a in at if lo <= a <= hi)
        # a sentinel first row answers for instants before the first fire
        self.at = [-2**62] + at
        self.answer = [self._next(at[0] - 1)] + [self._next(a) for a in at]

    def _next(self, t: int) -> int:
        nxt = self.schedule.next_fire_ms(int(t))
        return nxt if nxt is not None else 2**62

    def table(self, now: int, device) -> torch.Tensor:
        """[2, n] int64 on `device`: the instants and the answer at each."""
        if (self.device is None or self.device.device != device
                or not self.at[1] <= now < self.at[-1]):
            self._build(now)
            t = torch.tensor([self.at, self.answer], dtype=torch.int64)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            self.device = t
        return self.device

    def next_after(self, now: int) -> int:
        """`next_fire_ms(now)` (call `table(now, ...)` first)."""
        return self.answer[bisect.bisect_right(self.at, now) - 1]

    @staticmethod
    def first_schedule(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """`next_fire_ms(t)` for a device scalar t (no host sync)."""
        i = searchsorted32(table[0], t.reshape(1), side="right").long() - 1
        return table[1][i][0]


class CronWindow(WindowOp):
    """cron('0 0/5 * * * ?'): tumble on cron fire times. The next-fire
    instant lives in the state; crossing it flushes the buffer (currents
    of the buffer, expired copies of the previous flush)."""

    needs_heartbeat = True

    def __init__(self, layout: dict, batch_cap: int, expr: str,
                 expired_on: bool = True):
        from ..core.trigger import CronSchedule
        self.layout = layout
        self.B = batch_cap
        self.expired_on = expired_on
        self.schedule = CronSchedule(expr)
        self.table = CronFireTable(self.schedule)
        self.C = max(dtypes.config.default_window_capacity, 4 * batch_cap)
        self.chunk_width = 2 * self.C + 1

    def init_state(self, device) -> CronState:
        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        return CronState(
            ring_cols=_empty_like_cols(self.layout, self.C + 1, device),
            ring_ts=torch.zeros(self.C + 1, dtype=dtypes.TS_DTYPE,
                                device=device),
            appended=i64(0), flushed=i64(0), prev_start=i64(0),
            next_fire=i64(-1))

    def step(self, state: CronState, batch: EventBatch, now):
        C, B = self.C, self.B
        dev = batch.ts.device
        now = int(now)
        table = self.table.table(now, dev)
        comp_cols, comp_ts, n_valid, _ = compact(batch)
        appended1 = state.appended + n_valid
        _scatter_append(state.ring_cols, state.ring_ts, comp_cols, comp_ts,
                        state.appended, n_valid)
        ring_cols, ring_ts = state.ring_cols, state.ring_ts

        # lazy first schedule: from the earliest unprocessed event, so a
        # boundary between it and the first watermark still fires
        lane = torch.arange(B, dtype=torch.int64, device=dev)
        min_ts = torch.where(lane < n_valid, comp_ts, BIG).min()
        base = torch.where(n_valid > 0, torch.clamp(min_ts, max=now), now)
        first = self.table.first_schedule(table, base - 1)
        next_fire = torch.where(state.next_fire < 0, first, state.next_fire)
        fire = next_fire <= now

        # currents: overall [flushed, appended1); expired: [prev_start,
        # flushed); only the most recent C arrivals survive between fires
        o = torch.arange(C, dtype=torch.int64, device=dev)
        o_cur = state.flushed + o
        cur_valid = fire & (o_cur < appended1) & (appended1 - o_cur <= C)
        cur_cols, cur_ts = _gather_overall(ring_cols, ring_ts, comp_cols,
                                           comp_ts, appended1, o_cur)
        o_exp = state.prev_start + o
        exp_valid = (fire & self.expired_on & (o_exp < state.flushed)
                     & (state.flushed - o_exp <= C))
        exp_cols, exp_ts = _gather_overall(ring_cols, ring_ts, comp_cols,
                                           comp_ts, appended1, o_exp)
        chunk = EventBatch(
            ts=torch.cat([exp_ts, torch.full((1,), now, dtype=torch.int64,
                                             device=dev), cur_ts]),
            cols={k: torch.cat([exp_cols[k], v.new_zeros(1), cur_cols[k]])
                  for k, v in ring_cols.items()},
            valid=torch.cat([exp_valid,
                             (fire & (state.flushed > state.prev_start))[None],
                             cur_valid]),
            types=torch.cat([_types(EventType.EXPIRED, C, dev),
                             _types(EventType.RESET, 1, dev),
                             _types(EventType.CURRENT, C, dev)]))
        new_state = state._replace(
            appended=appended1,
            flushed=torch.where(fire, appended1, state.flushed),
            prev_start=torch.where(fire, state.flushed, state.prev_start),
            next_fire=torch.where(fire, self.table.next_after(now),
                                  next_fire))
        return new_state, chunk

    def contents(self, state: CronState, now):
        live = _ring_live_mask(self.C, state.flushed, state.appended)
        return ({k: v[:self.C] for k, v in state.ring_cols.items()},
                state.ring_ts[:self.C], live)


# --------------------------------------------------------------------------- #
# hopping
# --------------------------------------------------------------------------- #


class HopState(NamedTuple):
    """The JAX HopState's fields; rings are [C + 1] (spare row last)."""

    ring_cols: dict
    ring_ts: torch.Tensor
    appended: torch.Tensor  # int64 total arrivals
    last_hop: torch.Tensor  # int64 index of the last emitted hop boundary


class HoppingWindow(WindowOp):
    """hopping(windowTime, hopTime): every hopTime emit the events of the
    last windowTime (overlapping when window > hop). Several hop boundaries
    crossed inside one micro-batch collapse into the latest one's
    emission (the JAX package's batched divergence)."""

    needs_heartbeat = True

    def __init__(self, layout: dict, batch_cap: int, window_ms: int,
                 hop_ms: int):
        if hop_ms <= 0 or window_ms <= 0:
            raise SiddhiAppCreationError(
                "hopping needs positive window and hop")
        self.layout = layout
        self.B = batch_cap
        self.W = window_ms
        self.H = hop_ms
        self.C = max(dtypes.config.default_window_capacity, 2 * batch_cap)
        self.chunk_width = self.C + 1  # RESET + window contents

    def init_state(self, device) -> HopState:
        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        return HopState(
            ring_cols=_empty_like_cols(self.layout, self.C + 1, device),
            ring_ts=torch.zeros(self.C + 1, dtype=dtypes.TS_DTYPE,
                                device=device),
            appended=i64(0), last_hop=i64(0))

    def _in_window(self, ring_ts, appended, boundary: int):
        live = _ring_live_mask(self.C, torch.clamp(appended - self.C, min=0),
                               appended)
        ts = ring_ts[:self.C]
        return live & (ts > boundary - self.W) & (ts <= boundary)

    def step(self, state: HopState, batch: EventBatch, now):
        C = self.C
        dev = batch.ts.device
        now = int(now)
        comp_cols, comp_ts, n_valid, _ = compact(batch)
        appended1 = state.appended + n_valid
        _scatter_append(state.ring_cols, state.ring_ts, comp_cols, comp_ts,
                        state.appended, n_valid)

        hop_idx = now // self.H
        fire = hop_idx > state.last_hop
        in_window = self._in_window(state.ring_ts, appended1,
                                    hop_idx * self.H)
        chunk = EventBatch(
            ts=torch.cat([torch.full((1,), now, dtype=torch.int64,
                                     device=dev), state.ring_ts[:C]]),
            cols={k: torch.cat([v.new_zeros(1), v[:C]])
                  for k, v in state.ring_cols.items()},
            valid=torch.cat([fire[None], fire & in_window]),
            types=torch.cat([_types(EventType.RESET, 1, dev),
                             _types(EventType.CURRENT, C, dev)]))
        new_state = state._replace(
            appended=appended1,
            last_hop=torch.where(fire, hop_idx, state.last_hop))
        return new_state, chunk

    def contents(self, state: HopState, now):
        # the (boundary - W, boundary] interval step() last emitted
        in_window = self._in_window(state.ring_ts, state.appended,
                                    state.last_hop * self.H)
        return ({k: v[:self.C] for k, v in state.ring_cols.items()},
                state.ring_ts[:self.C], in_window)


# --------------------------------------------------------------------------- #
# frequent / lossyFrequent
# --------------------------------------------------------------------------- #


class FrequentState(NamedTuple):
    slot_keys: torch.Tensor  # int64[N], PAD when empty
    slot_counts: torch.Tensor  # int64[N]
    slot_cols: dict  # latest event per slot [N]
    slot_ts: torch.Tensor  # int64[N]
    total: torch.Tensor  # int64 total arrivals (lossyFrequent)


_PAD = torch.iinfo(torch.int64).max


def frequent_last_lane_plain(slot, comp_cols: dict, comp_ts, slot_cols: dict,
                             slot_ts, N: int):
    """Plain K13b, the JAX form: a scatter-max of the lane index into N + 1
    slots (N takes the untracked lanes), then each slot's row from its last
    lane where one arrived. Returns (cols [N], ts [N])."""
    B = slot.shape[0]
    dev = slot.device
    last = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    last.scatter_reduce_(0, slot.long(),
                         torch.arange(B, dtype=torch.int32, device=dev),
                         reduce="amax")
    last = last[:N]
    has_new = last >= 0
    g = torch.clamp(last, 0, B - 1).long()
    return ({k: torch.where(has_new, comp_cols[k][g], slot_cols[k])
             for k in slot_cols},
            torch.where(has_new, comp_ts[g], slot_ts))


def frequent_last_lane_cuda(slot, comp_cols: dict, comp_ts, slot_cols: dict,
                            slot_ts, N: int, *, counter: str = "K13b"):
    """K13b on the card: the atomicMax scatter, then the row gather (one
    launch per up to k13b_max_cols() columns, ts included)."""
    names = list(slot_cols)
    srcs = [comp_cols[k].contiguous() for k in names] + [comp_ts.contiguous()]
    olds = [slot_cols[k].contiguous() for k in names] + [slot_ts.contiguous()]
    kernels.require_cuda("frequent_last_lane", slot, *srcs, *olds)
    B = slot.shape[0]
    if (slot.dtype != torch.int32 or any(s.shape != (B,) for s in srcs)
            or any(o.shape != (N,) or o.dtype != s.dtype
                   for o, s in zip(olds, srcs))):
        raise ValueError("frequent_last_lane: int32 slots [B], batch "
                         "columns [B] and slot columns [N] of one dtype")
    dev = slot.device
    dsts = [torch.empty_like(o) for o in olds]
    last = torch.empty(N + 1, dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = "k13b_frequent"
    rc = kernels.bind(lib, "k13b_last_lane", [P, I, I, P, P])(
        slot.data_ptr(), B, N, last.data_ptr(), kernels.stream())
    kernels.check(lib, "frequent_last_lane", rc)
    kernels.LAUNCHES[counter] += 2 if B else 1
    gather = kernels.bind(lib, "k13b_gather_rows", [P, I, P, P, P, P, I, P])
    step = kernels.library(lib).k13b_max_cols()
    for c0 in range(0, len(srcs), step):
        part = slice(c0, c0 + step)

        def ptrs(ts):
            return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

        sizes = [s.element_size() for s in srcs[part]]
        rc = gather(last.data_ptr(), N, ptrs(srcs[part]), ptrs(olds[part]),
                    ptrs(dsts[part]), (ctypes.c_int * len(sizes))(*sizes),
                    len(sizes), kernels.stream())
        kernels.check(lib, "frequent_last_lane (gather)", rc)
        kernels.LAUNCHES[counter] += 1
    return dict(zip(names, dsts[:-1])), dsts[-1]


def frequent_last_lane(slot, comp_cols: dict, comp_ts, slot_cols: dict,
                       slot_ts, N: int, *, counter: str = "K13b"):
    """The remembered latest event of each slot after this batch (K13b).
    `counter` names the launch counter of the calling site."""
    if slot.is_cuda:
        return frequent_last_lane_cuda(slot, comp_cols, comp_ts, slot_cols,
                                       slot_ts, N, counter=counter)
    return frequent_last_lane_plain(slot, comp_cols, comp_ts, slot_cols,
                                    slot_ts, N)


def last_lane_per_slot_plain(slot: torch.Tensor, N: int) -> torch.Tensor:
    """Plain K13b without the row gather: the last lane of each of N + 1
    slots (N takes the lanes that count for no slot), -1 where none.
    int32[N + 1]."""
    last = torch.full((N + 1,), -1, dtype=torch.int32, device=slot.device)
    last.scatter_reduce_(0, slot.long(),
                         torch.arange(slot.shape[0], dtype=torch.int32,
                                      device=slot.device), reduce="amax")
    return last


def last_lane_per_slot(slot: torch.Tensor, N: int, *,
                       counter: str) -> torch.Tensor:
    """The last lane of each slot (K13b's init and atomicMax scatter).
    `slot` holds values in [0, N]; `counter` names the calling site."""
    if not slot.is_cuda:
        return last_lane_per_slot_plain(slot, N)
    slot = slot.to(torch.int32).contiguous()
    kernels.require_cuda("last_lane_per_slot", slot)
    B = slot.shape[0]
    last = torch.empty(N + 1, dtype=torch.int32, device=slot.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    rc = kernels.bind("k13b_frequent", "k13b_last_lane", [P, I, I, P, P])(
        slot.data_ptr(), B, N, last.data_ptr(), kernels.stream())
    kernels.check("k13b_frequent", "last_lane_per_slot", rc)
    kernels.LAUNCHES[counter] += 2 if B else 1
    return last


def _match(table_keys, query_keys):
    """Index of each query key in table_keys, or len(table) when absent
    (the table's stable order is K7's int64 argsort)."""
    N = table_keys.shape[0]
    order = stable_radix_argsort(table_keys, counter="K7 frequent match")
    order = order.long()
    sorted_keys = table_keys[order].contiguous()
    pos = searchsorted32(sorted_keys, query_keys.contiguous())
    pos_c = torch.clamp(pos, 0, N - 1).long()
    found = sorted_keys[pos_c] == query_keys
    return torch.where(found, order[pos_c], N).to(torch.int32)


class FrequentWindow(WindowOp):
    """frequent(N[, attrs...]): keep events whose attribute combination is
    one of the N most frequent — Misra-Gries counters. Evicted keys emit
    their remembered latest event as EXPIRED. Batched divergence: counter
    decrements apply per micro-batch, so admit/evict interleavings inside
    one batch collapse."""

    def __init__(self, layout: dict, batch_cap: int, n_slots: int,
                 key_attrs: Optional[list] = None, support: float = 0.0,
                 error: float = 0.0, lossy: bool = False):
        self.layout = layout
        self.B = batch_cap
        self.N = n_slots
        self.key_attrs = key_attrs or list(layout.keys())
        for a in self.key_attrs:
            if a not in layout:
                raise SiddhiAppCreationError(f"frequent: no attribute {a!r}")
        self.support = support
        self.error = error
        self.lossy = lossy
        self.chunk_width = batch_cap + n_slots  # currents + evict-expireds

    def init_state(self, device) -> FrequentState:
        N = self.N
        return FrequentState(
            slot_keys=torch.full((N,), _PAD, dtype=torch.int64,
                                 device=device),
            slot_counts=torch.zeros(N, dtype=torch.int64, device=device),
            slot_cols=_empty_like_cols(self.layout, N, device),
            slot_ts=torch.zeros(N, dtype=dtypes.TS_DTYPE, device=device),
            total=torch.tensor(0, dtype=torch.int64, device=device))

    _SCALE = 1_000_000  # fixed point for the support/error thresholds

    def step(self, state: FrequentState, batch: EventBatch, now):
        N, B = self.N, self.B
        dev = batch.ts.device
        comp_cols, comp_ts, n_valid, _ = compact(batch)
        lane = torch.arange(B, dtype=torch.int32, device=dev)
        lane_live = lane < n_valid
        keys = hash_columns([comp_cols[a] for a in self.key_attrs])
        keys = torch.where(keys == _PAD, _PAD - 1, keys)

        # batch-unique keys: runs of the sorted keys, with their counts
        sk = torch.where(lane_live, keys, _PAD)
        s = sk[stable_radix_argsort(sk, counter="K7 frequent key").long()]
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           s[1:] != s[:-1]])
        n_runs = first.sum(dtype=torch.int32)
        run_start = torch.where(lane < n_runs, stable_partition_order(first),
                                B)
        run_end = torch.cat([run_start[1:],
                             torch.full((1,), B, dtype=torch.int32,
                                        device=dev)])
        head = s[torch.clamp(run_start, max=B - 1).long()]
        run_count = torch.where(head != _PAD, run_end - run_start,
                                0).to(torch.int64)
        run_key = torch.where(run_count > 0, head, _PAD)
        uniq_live = run_count > 0

        # match the batch-unique keys against the tracked slots
        slot_of = _match(state.slot_keys, run_key)  # [B] slot or N
        tracked = slot_of < N

        # 1) tracked keys: counts += batch count (one run per slot)
        counts1 = torch.cat([state.slot_counts,
                             state.slot_counts.new_zeros(1)])
        counts1.scatter_add_(
            0, torch.where(tracked & uniq_live, slot_of, N).long(),
            run_count)
        counts1 = counts1[:N]

        # 2) untracked keys fill free slots (j-th new key -> j-th free slot)
        free = state.slot_keys == _PAD
        free_order = stable_partition_order(free)  # free slots first (K1)
        new_need = uniq_live & ~tracked
        new_rank = torch.cumsum(new_need.to(torch.int32), 0,
                                dtype=torch.int32) - 1
        placed = new_need & (new_rank < free.sum(dtype=torch.int32))
        place_slot = torch.where(
            placed, free_order[torch.clamp(new_rank, 0, N - 1).long()],
            N).long()
        keys1 = _scatter_drop(state.slot_keys, place_slot, run_key)
        counts2 = _scatter_drop(counts1, place_slot, run_count)

        # 3) Misra-Gries decrement: arrivals that found no slot decrement
        # every counter
        unplaced = torch.where(new_need & ~placed, run_count, 0).sum()
        occupied = keys1 != _PAD
        counts3 = torch.where(occupied,
                              torch.clamp(counts2 - unplaced, min=0), 0)
        evicted = occupied & (counts3 == 0)
        keys2 = torch.where(evicted, _PAD, keys1)

        total1 = state.total + n_valid
        if self.lossy:
            # lossy-counting prune below the error floor, fixed point
            err = int(self.error * self._SCALE)
            lossy_evict = (keys2 != _PAD) & (
                counts3 * self._SCALE < err * total1)
            evicted = evicted | lossy_evict
            keys2 = torch.where(lossy_evict, _PAD, keys2)

        # the remembered latest event per tracked slot (K13b)
        lane_slot_of = _match(keys2, keys)  # per original lane
        lane_tracked = lane_live & (lane_slot_of < N)
        cols1, ts1 = frequent_last_lane(
            torch.where(lane_tracked, lane_slot_of, N), comp_cols, comp_ts,
            state.slot_cols, state.slot_ts, N)

        # CURRENT lanes whose key is tracked after the update (lossy adds
        # the support threshold); EXPIRED = the evicted slots' remembered
        # events, only for slots occupied before this batch
        evicted_emit = evicted & (state.slot_keys != _PAD)
        cur_valid = lane_tracked
        if self.lossy:
            thr = int((self.support - self.error) * self._SCALE)
            lane_count = counts3[torch.clamp(lane_slot_of, 0, N - 1).long()]
            cur_valid = cur_valid & (lane_count * self._SCALE
                                     >= thr * total1)
        chunk = EventBatch(
            ts=torch.cat([comp_ts, state.slot_ts]),
            cols={k: torch.cat([comp_cols[k], state.slot_cols[k]])
                  for k in self.layout},
            valid=torch.cat([cur_valid, evicted_emit]),
            types=torch.cat([_types(EventType.CURRENT, B, dev),
                             _types(EventType.EXPIRED, N, dev)]))
        new_state = FrequentState(
            slot_keys=keys2, slot_counts=counts3, slot_cols=cols1,
            slot_ts=ts1, total=total1)
        return new_state, chunk

    def contents(self, state: FrequentState, now):
        return state.slot_cols, state.slot_ts, state.slot_keys != _PAD


# --------------------------------------------------------------------------- #
# keyed session window
# --------------------------------------------------------------------------- #


class KeyedSessionState(NamedTuple):
    """The JAX KeyedSessionState's fields; rings are [C + 1] (spare row
    last), the per-key tables [K]."""

    ring_cols: dict
    ring_ts: torch.Tensor  # int64
    ring_key: torch.Tensor  # int32 key slot per row
    ring_sess: torch.Tensor  # int32 session id per row (per key)
    ring_emitted: torch.Tensor  # bool: expired emission already happened
    appended: torch.Tensor  # int64 total arrivals
    last_ts: torch.Tensor  # int64[K] newest event ts per key
    sess: torch.Tensor  # int32[K] current open session id per key
    has: torch.Tensor  # bool[K] key has an open session
    dropped: torch.Tensor  # int64 lifetime events dropped (key >= capacity)


class KeyedSessionWindow(WindowOp):
    """session(gap, key): one independent session per key value. Key slots
    are the key attribute's values (dictionary codes for strings); per-key
    last-ts/session tables replace the scalar session state, ring rows
    carry (key, session, emitted) tags, and a session closing (in-batch
    gap or watermark) expires exactly its rows.

    The JAX package's documented divergences hold here too: the expired
    lanes of sessions closed within a batch emit BEFORE that batch's
    CURRENT lanes, oldest first, at most E a step (the rest the next
    step); key values past config.session_key_capacity are dropped and
    counted; the ring overwrites un-emitted rows past C."""

    needs_heartbeat = True

    def __init__(self, layout: dict, batch_cap: int, gap_ms: int,
                 key_attr: str, capacity: Optional[int] = None):
        if gap_ms <= 0:
            raise SiddhiAppCreationError("session gap must be positive")
        if key_attr not in layout:
            raise SiddhiAppCreationError(
                f"session key {key_attr!r} is not a stream attribute")
        attr_types = getattr(layout, "attr_types", None)
        if attr_types is None:
            raise SiddhiAppCreationError(
                "keyed sessions need attribute type information "
                "(ops/windows.py make_layout) to validate the key attribute")
        if attr_types.get(key_attr) not in (AttributeType.STRING,
                                            AttributeType.INT,
                                            AttributeType.LONG):
            raise SiddhiAppCreationError(
                "session keys must be string (dictionary codes) or "
                "small non-negative int attributes")
        self.layout = dict(layout)
        self.B = batch_cap
        self.gap = gap_ms
        self.key_attr = key_attr
        self.K = dtypes.config.session_key_capacity
        self.C = capacity or max(dtypes.config.default_window_capacity // 4,
                                 2 * batch_cap)
        # the emission block cannot exceed the ring
        self.E = min(max(batch_cap, 1024), self.C)
        self.chunk_width = self.B + self.E

    def init_state(self, device) -> KeyedSessionState:
        C, K = self.C, self.K
        return KeyedSessionState(
            ring_cols=_empty_like_cols(self.layout, C + 1, device),
            ring_ts=torch.zeros(C + 1, dtype=dtypes.TS_DTYPE, device=device),
            ring_key=torch.zeros(C + 1, dtype=torch.int32, device=device),
            ring_sess=torch.zeros(C + 1, dtype=torch.int32, device=device),
            # empty slots count as done
            ring_emitted=torch.ones(C + 1, dtype=torch.bool, device=device),
            appended=torch.tensor(0, dtype=torch.int64, device=device),
            last_ts=torch.zeros(K, dtype=dtypes.TS_DTYPE, device=device),
            sess=torch.zeros(K, dtype=torch.int32, device=device),
            has=torch.zeros(K, dtype=torch.bool, device=device),
            dropped=torch.tensor(0, dtype=torch.int64, device=device))

    def step(self, state: KeyedSessionState, batch: EventBatch, now):
        B, C, E, K = self.B, self.C, self.E, self.K
        dev = batch.ts.device
        comp_cols, comp_ts, n_valid, _ = compact(batch)
        p32 = torch.arange(B, dtype=torch.int32, device=dev)
        is_arr = p32 < n_valid
        key = comp_cols[self.key_attr].to(torch.int32)
        ok = is_arr & (key >= 0) & (key < K)
        key_c = torch.clamp(key, 0, K - 1)

        # per-arrival session ids: arrivals grouped by key (the stable sort
        # keeps arrival order inside each key run)
        skey = torch.where(ok, key_c, K)
        order = stable_radix_argsort(skey, K, counter="K7 keyed group").long()
        o_key = skey[order]
        o_ts = comp_ts[order]
        o_ok = ok[order]
        seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               o_key[1:] != o_key[:-1]])
        prev_ts = torch.cat([o_ts.new_zeros(1), o_ts[:-1]])
        slot_k = torch.clamp(o_key, 0, K - 1).long()
        # break before this arrival: vs the key's stored last ts at the
        # segment start, vs the in-batch predecessor inside a segment
        brk = torch.where(seg_start,
                          state.has[slot_k] & (o_ts - state.last_ts[slot_k]
                                               > self.gap),
                          o_ts - prev_ts > self.gap) & o_ok
        # per-key cumulative breaks: the segmented inclusive sum as a
        # cumsum less the cumsum before the segment start (integers: exact)
        cs = torch.cumsum(brk.to(torch.int32), 0, dtype=torch.int32)
        start = _segment_starts_index(seg_start)
        incr = cs - cs[start] + brk.to(torch.int32)[start]
        o_sess = state.sess[slot_k] + incr
        arr_sess = torch.empty(B, dtype=torch.int32, device=dev)
        arr_sess[order] = o_sess  # back to arrival order

        # per-key tables after this batch
        seg_end = torch.cat([seg_start[1:],
                             torch.ones(1, dtype=torch.bool, device=dev)])
        wkey = torch.where(o_ok & seg_end, o_key, K).long()
        new_last = _scatter_drop(state.last_ts, wkey, o_ts)
        new_sess = _scatter_drop(state.sess, wkey, o_sess)
        new_has = _scatter_drop(state.has, wkey,
                                torch.ones(B, dtype=torch.bool, device=dev))
        # watermark closure: keys whose open session went quiet bump their
        # session id (their rows expire below) and reset
        wm_close = new_has & (now - new_last > self.gap)
        new_sess = torch.where(wm_close, new_sess + 1, new_sess)
        new_has = new_has & ~wm_close

        # ring append, in place: ok lanes packed, so dropped-key arrivals
        # leave no holes; other lanes write the spare row C
        rank = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32) - 1
        slot = torch.where(
            ok, torch.remainder(torch.remainder(state.appended, C)
                                .to(torch.int32) + rank, C), C).long()
        for k in self.layout:
            state.ring_cols[k].index_put_((slot,), comp_cols[k])
        state.ring_ts.index_put_((slot,), comp_ts)
        state.ring_key.index_put_((slot,), key_c)
        state.ring_sess.index_put_((slot,), arr_sess)
        state.ring_emitted.index_put_((slot,),
                                      torch.zeros_like(ok))
        appended1 = state.appended + ok.sum(dtype=torch.int64)

        # expired: un-emitted rows whose session is no longer open, oldest
        # first (top-E by age; the rest emit next step)
        live = _ring_live_mask(C, torch.clamp(appended1 - C, min=0),
                               appended1)
        ring_key = state.ring_key[:C]
        closed = (live & ~state.ring_emitted[:C]
                  & (state.ring_sess[:C] < new_sess[ring_key.long()]))
        base1 = torch.remainder(appended1, C).to(torch.int32)
        rel_age = torch.remainder(
            torch.arange(C, dtype=torch.int32, device=dev) - base1, C)
        ekey = torch.where(closed, rel_age, C)
        eorder = stable_radix_argsort(ekey, C, E,
                                      counter="K7 keyed top-E").long()
        esel = closed[eorder]
        state.ring_emitted.index_put_(
            (torch.where(esel, eorder, C),), torch.ones_like(esel))

        chunk = EventBatch(
            ts=torch.cat([state.ring_ts[eorder], comp_ts]),
            cols={k: torch.cat([state.ring_cols[k][eorder], comp_cols[k]])
                  for k in self.layout},
            valid=torch.cat([esel, ok]),
            types=torch.cat([
                torch.full((E,), int(EventType.EXPIRED), dtype=torch.int8,
                           device=dev),
                torch.full((B,), int(EventType.CURRENT), dtype=torch.int8,
                           device=dev)]))
        new_state = state._replace(
            appended=appended1, last_ts=new_last, sess=new_sess, has=new_has,
            dropped=state.dropped + (is_arr & ~ok).sum(dtype=torch.int64))
        return new_state, chunk

    def contents(self, state: KeyedSessionState, now):
        C = self.C
        live = _ring_live_mask(C, torch.clamp(state.appended - C, min=0),
                               state.appended)
        ring_key = state.ring_key[:C].long()
        open_rows = live & ~state.ring_emitted[:C] & (
            state.ring_sess[:C] >= state.sess[ring_key])
        return ({k: v[:C] for k, v in state.ring_cols.items()},
                state.ring_ts[:C], open_rows)
