"""Attribute aggregators as grouped-scan components (counterpart of
siddhi_tpu/ops/aggregators.py).

An aggregator is a set of per-key accumulator components driven by signed
per-lane deltas (CURRENT adds, EXPIRED subtracts, RESET bumps the epoch) and
a `finalize` that combines the per-lane component values — or, for a custom
aggregator (distinctCount, hll:distinctCount), its own device state and
scan (`init_custom` / `custom_scan`). avg = sum / count, stdDev = (sum,
sumsq, count), and/or = counts of false/true; min/max and
minForever/maxForever are monotone components, and min/max over a sliding
window become range queries (ops/extrema.py, K8) instead. unionSet never
reaches its factory as a top-level output: the selector rewrites
`sizeOfSet(unionSet(...))` and a raw `select unionSet(x) as s` to
distinctCount; inside a larger expression it is refused.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from .. import kernels
from ..core import dtypes
from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind
from ..query_api.definition import AttributeType
from .groupby import (
    _KEY_PAD,
    GroupState,
    _lshr,
    _wrap64,
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
    """One per-key accumulator: delta(values [L] or None, sign [L])."""

    dtype: torch.dtype
    delta: Callable
    op: str = "sum"
    #: monotone components ignore EXPIRED lanes instead of undoing them
    ignore_removal: bool = False
    #: survives RESET (minForever/maxForever)
    ignore_reset: bool = False

    @property
    def fused(self) -> bool:
        """A plain sum: scanned with the others in one K5 call."""
        return (self.op == "sum" and not self.ignore_removal
                and not self.ignore_reset)


@dataclass(frozen=True)
class AggregatorSpec:
    components: tuple
    finalize: Callable  # list of per-lane component tensors -> [L] values
    return_type: AttributeType
    #: needs removal support (sliding windows); min/max set False
    supports_removal: bool = True
    #: custom aggregators: (group_capacity, device, grouped) -> state
    init_custom: Optional[Callable] = None
    #: (state, slots, arg_vals, sign, lane_valid, resets, epoch, grouped)
    #: -> (state, per-lane values)
    custom_scan: Optional[Callable] = None
    #: 'min'/'max' on true extrema: over a sliding window the planner swaps
    #: the monotone scan (which cannot undo a removal) for range queries
    extrema_op: Optional[str] = None


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


def _make_minmax(op: str):
    def make(arg_types):
        t = arg_types[0]
        if not dtypes.is_numeric(t):
            raise SiddhiAppCreationError(f"{op}() over non-numeric {t}")
        dt = dtypes.device_dtype(t)
        comp = Component(dt, lambda v, sign: v.to(dt), op=op,
                         ignore_removal=True)
        return AggregatorSpec((comp,), lambda cs: cs[0], t,
                              supports_removal=False, extrema_op=op)

    return make


def _make_minmax_forever(op: str):
    def make(arg_types):
        t = arg_types[0]
        dt = dtypes.device_dtype(t)
        comp = Component(dt, lambda v, sign: v.to(dt), op=op,
                         ignore_removal=True, ignore_reset=True)
        return AggregatorSpec((comp,), lambda cs: cs[0], t)

    return make


def _make_stddev(arg_types):
    t = arg_types[0]
    if not dtypes.is_numeric(t):
        raise SiddhiAppCreationError(f"stdDev() over non-numeric {t}")
    dt = dtypes.device_dtype(_T.DOUBLE)
    s = Component(dt, lambda v, sign: v.to(dt) * sign.to(dt))
    s2 = Component(dt, lambda v, sign: (v.to(dt) ** 2) * sign.to(dt))
    c = Component(dt, lambda v, sign: sign.to(dt))

    def fin(cs):
        total, sumsq, n = cs
        nz = n != 0
        safe_n = torch.where(nz, n, 1)
        mean = total / safe_n
        var = sumsq / safe_n - mean * mean
        # population standard deviation, as the reference computes it
        return torch.where(nz, torch.sqrt(torch.clamp(var, min=0.0)),
                           torch.zeros_like(var))

    return AggregatorSpec((s, s2, c), fin, _T.DOUBLE)


def _make_bool_and(arg_types):
    # and(bool): true while the window holds no false value (count falses)
    dt = dtypes.device_dtype(_T.LONG)
    c = Component(dt, lambda v, sign: torch.where(~v, sign.to(dt), 0))
    return AggregatorSpec((c,), lambda cs: cs[0] == 0, _T.BOOL)


def _make_bool_or(arg_types):
    dt = dtypes.device_dtype(_T.LONG)
    c = Component(dt, lambda v, sign: torch.where(v, sign.to(dt), 0))
    return AggregatorSpec((c,), lambda cs: cs[0] > 0, _T.BOOL)


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


# --------------------------------------------------------------------------- #
# K9 HLL: hll:distinctCount
# --------------------------------------------------------------------------- #


class HLLState(NamedTuple):
    """hll:distinctCount sketch state; `dropped` counts lanes whose group
    slot was past config.hll_group_capacity (monitored overflow)."""

    regs: torch.Tensor  # int32[G * M] registers
    dropped: torch.Tensor  # int64 lifetime lanes with no sketch


_FMIX1 = _wrap64(0xFF51AFD7ED558CCD)
_FMIX2 = _wrap64(0xC4CEB9FE1A85EC53)


def _hll_rank(h: torch.Tensor, M: int):
    """murmur3 fmix64 of K3's hash (int64 bit patterns, wrapping multiply),
    then register j = h & (M - 1) and rank = clz of the low 32 bits of
    h >> log2(M), plus one (33 for a zero word)."""
    h = h ^ _lshr(h, 33)
    h = h * _FMIX1
    h = h ^ _lshr(h, 33)
    h = h * _FMIX2
    h = h ^ _lshr(h, 33)
    j = h & (M - 1)
    w = _lshr(h, M.bit_length() - 1) & 0xFFFFFFFF
    # bit length of w from the float64 exponent (exact below 2^53)
    rho = 33 - torch.frexp(w.double())[1]
    return j, rho.to(torch.int32)


def _hll_alpha_mm(M: int) -> float:
    return 0.7213 / (1.0 + 1.079 / M) * M * M


def hll_estimate_plain(regs: torch.Tensor, M: int) -> torch.Tensor:
    """Per-group estimate in float32 (the JAX `_estimate`): harmonic mean
    with linear counting, rounded half to even. int64[G]."""
    R = regs.reshape(-1, M).to(torch.float32)
    inv = torch.exp2(-R).sum(dim=1)
    E = torch.tensor(_hll_alpha_mm(M), dtype=torch.float32) / inv
    zeros = (R == 0).sum(dim=1)
    lin = M * torch.log(M / torch.clamp(zeros, min=1).to(torch.float32))
    E = torch.where((E <= 2.5 * M) & (zeros > 0), lin, E)
    return torch.round(E).to(torch.int64)


def hll_registers_plain(regs, dropped, slots, h, sign, lane_valid, resets,
                        M: int):
    """Plain K9 register update (the JAX custom_scan's scatter-max halves):
    returns (regs_a, regs_b, dropped', before_first lanes, reset present,
    in_cap lanes). regs_a: the incoming registers plus the lanes before the
    first reset; regs_b: the state after the chunk."""
    G = regs.shape[0] // M
    j, rho = _hll_rank(h, M)
    in_cap = (slots >= 0) & (slots < G)
    adds = lane_valid & (sign > 0)
    idx = torch.where(adds & in_cap, slots.to(torch.int64) * M + j, G * M)
    n_drop = (adds & ~in_cap).sum(dtype=torch.int64)
    n_resets = resets.sum(dtype=torch.int32)
    rk = torch.cumsum(resets.to(torch.int32), 0, dtype=torch.int32)
    before_first = rk == 0
    after_last = rk == n_resets
    has_reset = n_resets > 0

    def scatter_max(table, sel):
        # the spare row G * M takes the lanes JAX's mode="drop" ignores
        ext = torch.cat([table, table.new_zeros(1)])
        ext.scatter_reduce_(0, torch.where(sel, idx, G * M), rho, "amax")
        return ext[:-1]

    regs_a = scatter_max(regs, before_first)
    fresh = torch.where(has_reset, torch.zeros_like(regs), regs)
    regs_b = scatter_max(fresh, after_last)
    return (regs_a, regs_b, dropped + n_drop, before_first, has_reset,
            in_cap)


def hll_scan_plain(regs, dropped, slots, h, sign, lane_valid, resets,
                   M: int):
    """Plain PyTorch K9 HLL: (regs', dropped', per-lane post-batch
    estimates; 0 past the group capacity)."""
    regs_a, regs_b, dropped, before_first, has_reset, in_cap = \
        hll_registers_plain(regs, dropped, slots, h, sign, lane_valid,
                            resets, M)
    G = regs.shape[0] // M
    sl = slots.clamp(0, G - 1).long()
    est_a = hll_estimate_plain(regs_a, M)[sl]
    est_b = hll_estimate_plain(regs_b, M)[sl]
    out = torch.where(before_first & has_reset, est_a, est_b)
    return regs_b, dropped, torch.where(in_cap, out, torch.zeros_like(out))


class HllPending(NamedTuple):
    """What `hll_update_cuda` leaves on the device for the estimate."""

    touched: torch.Tensor  # uint8[G] groups some lane reads
    bounds: torch.Tensor  # int32[2] first and last reset lane
    est_a: torch.Tensor  # int64[G] estimates before the first reset


def _hll_check(regs, dropped, slots, h, sign, lane_valid, resets, M):
    kernels.require_cuda("hll:distinctCount", regs, dropped, slots, h, sign,
                         lane_valid, resets)
    n = slots.shape[0]
    if (regs.dtype != torch.int32 or regs.shape[0] % M
            or dropped.dtype != torch.int64 or dropped.dim() != 0
            or slots.dtype != torch.int32 or sign.dtype != torch.int32
            or h.dtype != torch.int64 or h.shape != (n,)
            or sign.shape != (n,) or lane_valid.shape != (n,)
            or resets.shape != (n,) or lane_valid.dtype != torch.bool
            or resets.dtype != torch.bool):
        raise ValueError("hll:distinctCount: int32 registers [G * M], int64 "
                         "dropped, int32 slots/sign, int64 hashes and bool "
                         "valid/resets [L]")


def hll_update_cuda(regs, dropped, slots, h, sign, lane_valid, resets,
                    M: int) -> HllPending:
    """K9 HLL register update on the card; regs and dropped in place."""
    _hll_check(regs, dropped, slots, h, sign, lane_valid, resets, M)
    G = regs.shape[0] // M
    dev = regs.device
    pending = HllPending(
        touched=torch.zeros(G, dtype=torch.uint8, device=dev),
        bounds=torch.empty(2, dtype=torch.int32, device=dev),
        est_a=torch.empty(G, dtype=torch.int64, device=dev))
    P = ctypes.c_void_p
    I = ctypes.c_int
    fn = kernels.bind("k9_hll", "k9_hll_update",
                      [P] * 5 + [I] * 4 + [ctypes.c_float] + [P] * 6)
    rc = fn(h.data_ptr(), slots.data_ptr(), sign.data_ptr(),
            lane_valid.data_ptr(), resets.data_ptr(), slots.shape[0], G, M,
            M.bit_length() - 1, _hll_alpha_mm(M), regs.data_ptr(),
            pending.touched.data_ptr(), pending.bounds.data_ptr(),
            pending.est_a.data_ptr(), dropped.data_ptr(), kernels.stream())
    kernels.check("k9_hll", "hll:distinctCount (update)", rc)
    kernels.LAUNCHES["K9 HLL"] += 4
    return pending


def hll_estimate_cuda(regs, slots, pending: HllPending, M: int):
    """K9 HLL estimate on the card: the groups the chunk reads, gathered
    per lane."""
    G = regs.shape[0] // M
    n = slots.shape[0]
    est_b = torch.empty(G, dtype=torch.int64, device=regs.device)
    out = torch.empty(n, dtype=torch.int64, device=regs.device)
    P = ctypes.c_void_p
    I = ctypes.c_int
    fn = kernels.bind("k9_hll", "k9_hll_estimate",
                      [P] * 6 + [I] * 3 + [ctypes.c_float, P, P])
    rc = fn(slots.data_ptr(), regs.data_ptr(), pending.touched.data_ptr(),
            pending.bounds.data_ptr(), pending.est_a.data_ptr(),
            est_b.data_ptr(), n, G, M, _hll_alpha_mm(M), out.data_ptr(),
            kernels.stream())
    kernels.check("k9_hll", "hll:distinctCount (estimate)", rc)
    kernels.LAUNCHES["K9 HLL estimate"] += 2
    return out


def hll_scan(regs, dropped, slots, h, sign, lane_valid, resets, M: int):
    """One chunk through the sketch (K9 HLL): (regs', dropped', per-lane
    estimates). On the card regs and dropped update in place."""
    if regs.is_cuda:
        pending = hll_update_cuda(regs, dropped, slots, h, sign, lane_valid,
                                  resets, M)
        return regs, dropped, hll_estimate_cuda(regs, slots, pending, M)
    return hll_scan_plain(regs, dropped, slots, h, sign, lane_valid, resets,
                          M)


def _make_hll_distinct_count(arg_types):
    """hll:distinctCount(attr): approximate distinct count through a
    HyperLogLog sketch of config.hll_registers registers per group (std
    error ~1.04/sqrt(m): 1024 -> ~3.3%). CURRENT lanes max-update one
    register each; removals are ignored (a sketch cannot forget: use the
    exact distinctCount where sliding removal matters); RESET clears the
    registers. Every lane reports the post-batch estimate of its group."""
    dt = dtypes.device_dtype(_T.LONG)
    M = int(dtypes.config.hll_registers)
    if M != 1 << (M.bit_length() - 1):
        raise SiddhiAppCreationError("hll_registers must be a power of two")

    def init_custom(group_capacity: int, device, grouped: bool = True):
        G = (min(group_capacity, dtypes.config.hll_group_capacity)
             if grouped else 1)
        return HLLState(
            regs=torch.zeros(G * M, dtype=torch.int32, device=device),
            dropped=torch.zeros((), dtype=dt, device=device))

    def custom_scan(state, slots, arg_vals, sign, lane_valid, resets, epoch,
                    grouped: bool = True):
        h = hash_columns([arg_vals[0]])
        regs, dropped, out = hll_scan(state.regs, state.dropped, slots, h,
                                      sign, lane_valid, resets, M)
        return HLLState(regs, dropped), out

    return AggregatorSpec((), lambda cs: cs[0], _T.LONG,
                          init_custom=init_custom, custom_scan=custom_scan)


def _make_union_set(arg_types):
    """unionSet(set): reached only inside a larger expression, where the
    set would stay host-opaque."""
    raise SiddhiAppCreationError(
        "unionSet() inside a larger expression is not supported on this "
        "engine (raw `select unionSet(x) as s` IS — the set materializes "
        "host-side at the callback boundary); "
        "use sizeOfSet(unionSet(...)), which compiles to an exact distinct "
        "count on device")


def register_all() -> None:
    def reg(name, make, namespace=""):
        GLOBAL.register(ExtensionKind.AGGREGATOR, namespace, name,
                        AggregatorFactory(make))

    reg("sum", _make_sum)
    reg("count", _make_count)
    reg("avg", _make_avg)
    reg("min", _make_minmax("min"))
    reg("max", _make_minmax("max"))
    reg("minForever", _make_minmax_forever("min"))
    reg("maxForever", _make_minmax_forever("max"))
    reg("stdDev", _make_stddev)
    reg("and", _make_bool_and)
    reg("or", _make_bool_or)
    reg("distinctCount", _make_distinct_count)
    reg("unionSet", _make_union_set)
    reg("distinctCount", _make_hll_distinct_count, "hll")


register_all()
