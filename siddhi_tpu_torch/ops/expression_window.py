"""The expression window on monotone conditions (counterpart of
siddhi_tpu/ops/expression_window.py).

`expression(condition)` keeps, after each arrival, the largest suffix of
the window for which the condition holds. For conditions that are monotone
by construction — ones that only dropping old events can make true,
whatever the data — each arrival's expiry frontier is a closed form or a
binary search:

  count() REL N                  -> frontier = pos + 1 - N
  eventTimestamp(last) - eventTimestamp(first) REL C -> searchsorted on ts
  AND of the above               -> max of frontiers

REL is < or <=. Anything else (sum() and attribute spans are monotone only
by the data) is refused at plan time; the window factory then takes the
exact sequential walk (ops/expression_general.py).

The searches are K6 (`searchsorted32`), the running max of
the frontiers K5b's ungrouped max scan, the emission-order sort K7 on the
packed chunk (`_sort_chunk_packed`), and the ring passes K2b.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import dtypes
from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from ..query_api.expression import (And, AttributeFunction, Compare,
                                    CompareOp, Constant, Expression,
                                    MathExpression, MathOp, Variable)
from .groupby import GroupState, ungrouped_scan
from .search import searchsorted32
from .windows import (KIND_CURRENT, SlidingState, WindowOp, _append_packed,
                      _fetch_rel_packed, _layout_words, _ring_live_mask,
                      _sort_chunk_packed, _unpack_rows, compact_packed)


class _Conjunct(NamedTuple):
    kind: str  # 'count' | 'ts_span'
    limit: float  # effective inclusive limit (REL folded in)
    strict: bool  # True for '<'


def _is_ts_span(e: Expression) -> bool:
    """eventTimestamp(last) - eventTimestamp(first)."""
    if isinstance(e, MathExpression) and e.op == MathOp.SUBTRACT:
        l, r = e.left, e.right
        if (isinstance(l, AttributeFunction)
                and isinstance(r, AttributeFunction)
                and l.name == "eventTimestamp" and r.name == "eventTimestamp"
                and l.parameters and r.parameters
                and isinstance(l.parameters[0], Variable)
                and isinstance(r.parameters[0], Variable)
                and l.parameters[0].attribute == "last"
                and r.parameters[0].attribute == "first"):
            return True
    return False


def plan_expression(expr: Expression) -> list[_Conjunct]:
    """Decompose a window condition into conjuncts monotone by construction
    or refuse."""
    if isinstance(expr, And):
        return plan_expression(expr.left) + plan_expression(expr.right)
    if not isinstance(expr, Compare):
        raise SiddhiAppCreationError(
            f"expression window conditions must be AND-ed comparisons; "
            f"got {type(expr).__name__} — see ops/expression_window.py for "
            "the supported monotone forms")
    left, op, right = expr.left, expr.op, expr.right
    if isinstance(left, Constant) and not isinstance(right, Constant):
        # `10 > count()` == `count() < 10`
        flip = {CompareOp.GREATER_THAN: CompareOp.LESS_THAN,
                CompareOp.GREATER_THAN_EQUAL: CompareOp.LESS_THAN_EQUAL}
        if op not in flip:
            raise SiddhiAppCreationError(
                "expression window conditions must bound a window metric "
                "from above (< / <=): only shrinking the window can restore "
                "them (monotone-suffix evaluation)")
        left, op, right = right, flip[op], left
    if op not in (CompareOp.LESS_THAN, CompareOp.LESS_THAN_EQUAL):
        raise SiddhiAppCreationError(
            "expression window conditions must bound a window metric from "
            "above (< / <=): only shrinking the window can restore them "
            "(monotone-suffix evaluation)")
    if not isinstance(right, Constant):
        raise SiddhiAppCreationError(
            "expression window bounds must be constants")
    limit = float(right.value)
    strict = op == CompareOp.LESS_THAN

    if (isinstance(left, AttributeFunction) and left.name == "count"
            and not left.parameters):
        return [_Conjunct("count", limit, strict)]
    if _is_ts_span(left):
        return [_Conjunct("ts_span", limit, strict)]
    raise SiddhiAppCreationError(
        "unsupported expression window term; forms monotone by "
        "construction: count(), eventTimestamp(last) - "
        "eventTimestamp(first)")


def arrival_sequence(ring_vals, comp_vals, base, winlen0, n_valid32, C: int,
                     B: int, fill):
    """Arrival-order values: position r holds the event at overall index
    base + r — window rows [0, winlen0) from the ring, this batch's
    arrivals at [winlen0, winlen0 + n_valid) — and `fill` elsewhere (a
    destination past C + B is dropped, as the JAX scatter drops it).
    Length C + B, the ring's dtype."""
    dev = ring_vals.device
    i = torch.arange(C, dtype=torch.int64, device=dev)
    arr = ring_vals[:C][torch.remainder(base + i, C)]
    arr = arr.masked_fill(i >= winlen0, fill)
    seq = torch.cat([arr, torch.full((B + 1,), fill, dtype=arr.dtype,
                                     device=dev)])
    p = torch.arange(B, dtype=torch.int32, device=dev)
    dest = torch.where(p < n_valid32, winlen0 + p, C + B)
    dest = torch.where(dest < C + B, dest, C + B).long()
    seq.index_put_((dest,), comp_vals.to(arr.dtype))
    return seq[:C + B]


def running_max(s: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of int32 frontiers (the JAX
    associative_scan(jnp.maximum)): K5b's ungrouped max scan over one
    fresh cell."""
    dev = s.device
    cell = GroupState(
        values=torch.full((1,), torch.iinfo(torch.int32).min,
                          dtype=torch.int32, device=dev),
        epoch=torch.zeros(1, dtype=torch.int32, device=dev))
    n = s.shape[0]
    _, out = ungrouped_scan(
        cell, s.contiguous(), torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev), "max")
    return out


class ExpressionWindow(WindowOp):
    """Sliding expression window: after each arrival the retained window is
    the largest suffix satisfying every conjunct. Expiry is arrival-driven
    (the reference also re-evaluates only on events for these forms)."""

    def __init__(self, layout: dict, batch_cap: int, condition: str):
        from ..compiler import parse_expression
        self.layout = layout
        self.B = batch_cap
        self.conjuncts = plan_expression(parse_expression(condition))
        self.C = max(dtypes.config.default_window_capacity, batch_cap)
        # count() bounds are known statically: the ring is sized so the
        # retained window never wraps past capacity; time spans (and the
        # general window's conditions) rely on the step's overflow counter
        for conj in self.conjuncts:
            if conj.kind == "count":
                self.C = max(self.C, int(conj.limit) + batch_cap)
        self.E = max(batch_cap, 1024)
        self.C = max(self.C, self.E)
        self.chunk_width = self.B + self.E
        self.W = _layout_words(layout)

    def init_state(self, device) -> SlidingState:
        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        return SlidingState(
            ring=torch.zeros((self.W, self.C), dtype=torch.int32,
                             device=device),
            appended=i64(0), expired=i64(0), wm=i64(-(2**62)),
            overflow=i64(0))

    def _frontiers(self, ring_cols, ring_ts, comp_cols, comp_ts, expired,
                   winlen0, n_valid32, q):
        """Per-arrival expiry frontier: the count bound's closed form, a
        binary search over the arrival timestamps for a time span
        (GeneralExpressionWindow overrides this with the exact sequential
        walk)."""
        B, C = self.B, self.C
        dev = q.device
        s = torch.zeros(B, dtype=torch.int32, device=dev)
        for conj in self.conjuncts:
            side = "right" if conj.strict else "left"
            if conj.kind == "count":
                n = int(conj.limit) - (1 if conj.strict else 0)
                if n < 1:
                    raise SiddhiAppCreationError(
                        "expression window count bound admits no events")
                f = q + 1 - n
            else:  # ts_span over the arrival timestamps (non-decreasing)
                seq = arrival_sequence(ring_ts, comp_ts, expired, winlen0,
                                       n_valid32, C, B,
                                       torch.iinfo(torch.int64).max)
                lastv = seq[torch.clamp(q, 0, C + B - 1).long()]
                # seq[s] >= lastv - limit (strict: >), the limit converted
                # to the sequence's dtype first, as jnp.asarray does
                limit = torch.tensor(conj.limit,
                                     dtype=torch.float64).to(seq.dtype)
                target = lastv - limit.item()
                f = searchsorted32(seq, target, side=side)
            s = torch.maximum(s, f.to(torch.int32))
        return s

    def step(self, state: SlidingState, batch: EventBatch, now):
        B, E, C = self.B, self.E, self.C
        dev = batch.ts.device
        comp_mat, n_valid32 = compact_packed(batch, self.layout)
        n_valid = n_valid32.to(torch.int64)
        comp_cols, comp_ts = _unpack_rows(comp_mat, self.layout)
        winlen0 = (state.appended - state.expired).to(torch.int32)

        # per-arrival expiry frontier s_j (relative to state.expired): the
        # smallest window start keeping every conjunct true after j
        p = torch.arange(B, dtype=torch.int32, device=dev)
        q = winlen0 + p
        ring_cols, ring_ts = _unpack_rows(state.ring, self.layout)
        s = self._frontiers(ring_cols, ring_ts, comp_cols, comp_ts,
                            state.expired, winlen0, n_valid32, q)
        # frontiers are cumulative: a later arrival never re-admits events
        # an earlier one expired
        s = running_max(s)
        s = torch.minimum(torch.clamp(s, min=0), q + 1)
        cur_valid = p < n_valid32
        s_end = torch.where(cur_valid, s, 0).max()
        # only E expiry lanes emit a step: the rest catch up next step
        s_end = torch.clamp(s_end, max=E)
        # invalid lanes take the final frontier so the trigger search scans
        # a sorted array
        s_sorted = torch.where(cur_valid, torch.minimum(s, s_end), s_end)

        appended1 = state.appended + n_valid

        # expiry candidates
        pe = torch.arange(E, dtype=torch.int32, device=dev)
        cand_exists = pe < (appended1 - state.expired).to(torch.int32)
        cand_mat = _fetch_rel_packed(state.ring, comp_mat, state.expired,
                                     state.appended, E)
        expires = cand_exists & (pe < s_end)
        # the FIRST arrival whose frontier passes the candidate; the
        # reference pops AFTER processing that arrival, so expired lanes
        # sort just after it (slot 3, past CURRENT's 2)
        trig = searchsorted32(s_sorted.contiguous(), pe + 1, side="left")
        emit_ts = torch.full((E,), int(now), dtype=torch.int64, device=dev)

        all_hi = torch.cat([torch.clamp(trig, 0, B) * 4 + 3,
                            p * 4 + KIND_CURRENT])
        all_mat = torch.cat([cand_mat, comp_mat], dim=1)
        all_emit = torch.cat([emit_ts, comp_ts])
        all_valid = torch.cat([expires, cur_valid])
        all_types = torch.cat([
            torch.full((E,), int(EventType.EXPIRED), dtype=torch.int8,
                       device=dev),
            torch.full((B,), int(EventType.CURRENT), dtype=torch.int8,
                       device=dev)])
        chunk = _sort_chunk_packed(all_hi, all_mat, all_emit,
                                   all_valid, all_types, self.layout,
                                   self.chunk_width, 4 * B + 4)

        # the append comes after the reads of the ring (in place on the card)
        ring = _append_packed(state.ring, comp_mat, state.appended,
                              n_valid32)
        # time spans and general conditions have no static bound: count
        # live rows the ring wrap overwrote
        expired1 = state.expired + s_end.to(torch.int64)
        over0 = torch.clamp(state.appended - state.expired - C, min=0)
        over1 = torch.clamp(appended1 - expired1 - C, min=0)
        new_state = SlidingState(
            ring=ring, appended=appended1, expired=expired1, wm=state.wm,
            overflow=state.overflow + torch.clamp(over1 - over0, min=0))
        return new_state, chunk

    def contents(self, state: SlidingState, now):
        ring_cols, ring_ts = _unpack_rows(state.ring, self.layout)
        live = _ring_live_mask(self.C, state.expired, state.appended)
        return ring_cols, ring_ts, live
