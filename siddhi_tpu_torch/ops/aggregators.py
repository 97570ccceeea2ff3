"""Attribute aggregators as grouped-scan components (counterpart of
siddhi_tpu/ops/aggregators.py; this slice ports sum, count, avg and the
exact distinctCount).

An aggregator is a set of per-key accumulator components driven by signed
per-lane deltas (CURRENT adds, EXPIRED subtracts, RESET bumps the epoch) and
a `finalize` that combines the per-lane component values — or, for a custom
aggregator (distinctCount), its own device state and scan
(`init_custom` / `custom_scan`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core import dtypes
from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind
from ..query_api.definition import AttributeType
from .groupby import (
    _KEY_PAD,
    GroupState,
    grouped_scan,
    hash_columns,
    init_group_state,
    init_key_table,
    key_lookup_or_insert,
    ungrouped_scan,
)

_T = AttributeType


@dataclass(frozen=True)
class Component:
    """One per-key sum accumulator: delta(values [L] or None, sign [L])."""

    dtype: torch.dtype
    delta: Callable


@dataclass(frozen=True)
class AggregatorSpec:
    components: tuple
    finalize: Callable  # list of per-lane component tensors -> [L] values
    return_type: AttributeType
    #: custom aggregators: (group_capacity, device, grouped) -> state
    init_custom: Optional[Callable] = None
    #: (state, slots, arg_vals, sign, lane_valid, resets, epoch, grouped)
    #: -> (state, per-lane values)
    custom_scan: Optional[Callable] = None


class AggregatorFactory:
    """SPI: make(arg_types) -> AggregatorSpec."""

    def __init__(self, make: Callable):
        self.make = make


def _sum_return_type(t: AttributeType) -> AttributeType:
    # int/long -> LONG, float/double -> DOUBLE (reference sum executor)
    return _T.LONG if t in (_T.INT, _T.LONG) else _T.DOUBLE


def _make_sum(arg_types):
    t = arg_types[0]
    if not dtypes.is_numeric(t):
        raise SiddhiAppCreationError(f"sum() over non-numeric {t}")
    rt = _sum_return_type(t)
    dt = dtypes.device_dtype(rt)
    comp = Component(dt, lambda v, sign: v.to(dt) * sign.to(dt))
    return AggregatorSpec((comp,), lambda cs: cs[0], rt)


def _make_count(arg_types):
    dt = dtypes.device_dtype(_T.LONG)
    comp = Component(dt, lambda v, sign: sign.to(dt))
    return AggregatorSpec((comp,), lambda cs: cs[0], _T.LONG)


def _make_avg(arg_types):
    t = arg_types[0]
    if not dtypes.is_numeric(t):
        raise SiddhiAppCreationError(f"avg() over non-numeric {t}")
    dt = dtypes.device_dtype(_T.DOUBLE)
    s = Component(dt, lambda v, sign: v.to(dt) * sign.to(dt))
    c = Component(dt, lambda v, sign: sign.to(dt))

    def fin(cs):
        total, n = cs
        nz = n != 0
        return torch.where(nz, total / torch.where(nz, n, 1),
                           torch.zeros_like(total))

    return AggregatorSpec((s, c), fin, _T.DOUBLE)


def _make_distinct_count(arg_types):
    """distinctCount(attr): exact distinct values per group with removal
    (the reference keeps a value -> count map per group key).

    One device hash table over (group, value) pairs shared by all groups
    plus a per-group distinct counter; two chained scans per batch: (1) the
    per-pair signed counts — a CURRENT lane whose post-update pair count is
    1 is a 0 -> 1 transition (+1 distinct), an EXPIRED lane reaching 0 a
    1 -> 0 transition (-1); (2) those deltas scanned per group give each
    lane's running distinct count.

    Fast path: an ungrouped distinctCount over a STRING attribute needs no
    hash table: string codes are dense ids into the interning table and
    index the pair-count table directly (codes >= capacity are dropped; the
    runtime monitors the interning size against the capacity)."""
    dt = dtypes.device_dtype(_T.LONG)
    code_arg = bool(arg_types) and arg_types[0] == _T.STRING

    def init_custom(group_capacity: int, device, grouped: bool = True):
        P = group_capacity  # (group, value) pair capacity
        if code_arg and not grouped:
            return (init_group_state(P, dt, device),
                    init_group_state(1, dt, device))
        return (init_key_table(P, device), init_group_state(P, dt, device),
                init_group_state(group_capacity, dt, device))

    def transitions(sign, pair_post):
        return torch.where(sign > 0, (pair_post == 1).to(dt),
                           -(pair_post == 0).to(dt))

    def custom_scan(state, slots, arg_vals, sign, lane_valid, resets, epoch,
                    grouped: bool = True):
        deltas = sign.to(dt)
        if code_arg and not grouped:
            pair_counts, distinct = state
            P = pair_counts.values.shape[0]
            code = arg_vals[0].to(torch.int32)
            ok = lane_valid & (code >= 0) & (code < P)
            pair_counts, pair_post = grouped_scan(
                pair_counts, code, deltas, ok, resets, epoch, op="sum")
            distinct, out = ungrouped_scan(
                distinct, transitions(sign, pair_post), ok, resets, epoch,
                op="sum")
            return (pair_counts, distinct), out
        kt, pair_counts, distinct = state
        pk = hash_columns([slots.to(torch.int64), arg_vals[0]])
        kt, pair_slots, kres = key_lookup_or_insert(kt, pk, lane_valid)
        # unresolved lanes (pair table exhausted: monitored truncation) drop
        # out instead of corrupting pair slot 0
        lane_valid = lane_valid & kres
        pair_counts, pair_post = grouped_scan(
            pair_counts, pair_slots, deltas, lane_valid, resets, epoch,
            op="sum")
        dd = transitions(sign, pair_post)
        if grouped:
            distinct, out = grouped_scan(distinct, slots, dd, lane_valid,
                                         resets, epoch, op="sum")
        else:
            distinct, out = ungrouped_scan(distinct, dd, lane_valid, resets,
                                           epoch, op="sum")
        return (kt, pair_counts, distinct), out

    return AggregatorSpec((), lambda cs: cs[0], _T.LONG,
                          init_custom=init_custom, custom_scan=custom_scan)


#: live pairs re-inserted per key-table call of a compaction
_COMPACTION_CHUNK = 65536


def compact_distinct_state(state, current_epoch: int):
    """Evict dead pairs from a distinctCount hash-path state tuple.

    The pair table only grows inside a step (a pair whose count drops to
    zero keeps its slot), so lifetime-unique pairs eventually fill it. This
    host-triggered rebuild re-inserts only the live pairs (count != 0 at the
    current epoch) into a fresh table through K4, in chunks, on the state's
    device, reclaiming every dead slot. Called by the runtime's capacity
    monitor, never from inside a step."""
    kt, pair_counts, distinct = state
    K = kt.keys.shape[0] // 2
    dev = kt.keys.device
    ids = kt.ids.long()
    live = ((kt.keys != _KEY_PAD) & (pair_counts.values[ids] != 0)
            & (pair_counts.epoch[ids] == current_epoch))
    live_keys = kt.keys[live]
    live_vals = pair_counts.values[ids[live]]
    fresh = init_key_table(K, dev)
    new_vals = torch.zeros(K, dtype=pair_counts.values.dtype, device=dev)
    CH = _COMPACTION_CHUNK
    lane = torch.arange(CH, device=dev)
    for i in range(0, live_keys.shape[0], CH):
        chunk = live_keys[i:i + CH]
        m = chunk.shape[0]
        keys = torch.zeros(CH, dtype=torch.int64, device=dev)
        keys[:m] = chunk
        fresh, new_ids, ok = key_lookup_or_insert(fresh, keys, lane < m)
        ok = ok[:m]
        new_vals[new_ids[:m][ok].long()] = live_vals[i:i + CH][ok]
    rebuilt = GroupState(
        values=new_vals,
        epoch=torch.full((K,), current_epoch, dtype=pair_counts.epoch.dtype,
                         device=dev))
    return (fresh, rebuilt, distinct)


def _not_yet_ported(name: str):
    def make(arg_types):
        raise SiddhiAppCreationError(
            f"aggregator {name}() is not yet ported to siddhi_tpu_torch")
    return make


def register_all() -> None:
    def reg(name, make, namespace=""):
        GLOBAL.register(ExtensionKind.AGGREGATOR, namespace, name,
                        AggregatorFactory(make))

    reg("sum", _make_sum)
    reg("count", _make_count)
    reg("avg", _make_avg)
    reg("distinctCount", _make_distinct_count)
    for name in ("min", "max", "minForever", "maxForever", "stdDev", "and",
                 "or", "unionSet"):
        reg(name, _not_yet_ported(name))
    reg("distinctCount", _not_yet_ported("hll:distinctCount"), "hll")


register_all()
