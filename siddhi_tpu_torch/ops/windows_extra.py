"""The keyed session window (counterpart of KeyedSessionWindow in
siddhi_tpu/ops/windows_extra.py). The cron, hopping, frequent and
lossyFrequent windows of that module are not yet ported.

Its two stable argsorts (arrivals grouped by key slot; the oldest-first
top-E of the ring's closed rows) are kernel K7 (csrc/k7_radix_sort.cu).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import dtypes
from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from ..query_api.definition import AttributeType
from .groupby import _scatter_drop, _segment_starts_index
from .search import stable_radix_argsort
from .windows import WindowOp, _empty_like_cols, _ring_live_mask, compact


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
