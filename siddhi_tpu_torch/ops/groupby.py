"""Group-by on device (counterpart of siddhi_tpu/ops/groupby.py).

Five kernels live here, each beside its plain PyTorch version:

- K3 `hash_columns`: 64-bit mix of the key columns (csrc/k3_hash.cu);
- K3b `hash_columns32`: 32-bit mix of the key columns for join probes,
  with the join's sentinel remap and validity mask fused
  (csrc/k3_hash.cu);
- K4 `key_lookup_or_insert`: open-addressing key table, keys -> dense ids
  (csrc/k4_keytable.cu);
- K5 `grouped_scan_fused` / `ungrouped_scan_fused`: N sum components over
  one plan (sort by slot, or lanes in order without GROUP BY), segmented
  scan with carry-in, state scatter (csrc/k5_grouped_scan.cu);
- K5b `grouped_scan` / `ungrouped_scan`: one component under sum, min or
  max with its own epoch table, on the K5 plan and scan entry points
  (csrc/k5_grouped_scan.cu).

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; it never falls back from one to the other. Semantics
follow the JAX functions bit for bit (float sums within the numeric-parity
tolerance), except that K4 places keys the JAX table drops
(`_PROBE_DEPTH`). Where the JAX code returns new arrays, the CUDA paths update
the state tensors in place — the counterpart of JAX's buffer
donation — and return them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import kernels
from .search import stable_argsort_bounded

_KEY_PAD = (1 << 63) - 1  # INT64_MAX marks an empty slot
#: probe window per key. The JAX key table probes 16 slots with short odd
#: strides, so windows overlap in runs and fill up long before the table
#: does: it leaves new keys unplaced from about 57% of its id capacity K on
#: (tools/probe_depth_load.py). 32 slots give the same slots, ids and table
#: state wherever a 16-slot window had room, and place no key short of
#: about 87% of K; the capacity monitor compacts at 85% (ROADMAP.md,
#: Queue 3).
_PROBE_DEPTH = 32
_INSERT_ROUNDS = 6
_MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# K3: hash_columns
# --------------------------------------------------------------------------- #


def _key_words(cols: list) -> torch.Tensor:
    """[k, L] int64 words, one row per key column, exactly as the JAX
    function widens them: float32 -> int32 bits sign-extended, float64 ->
    int64 bits, integers and bools widened to int64."""
    words = []
    for c in cols:
        if c.dtype == torch.float32:
            w = c.contiguous().view(torch.int32).to(torch.int64)
        elif c.dtype == torch.float64:
            w = c.contiguous().view(torch.int64)
        else:
            w = c.to(torch.int64)
        words.append(w)
    return torch.stack(words).contiguous()


def _lshr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's >> is arithmetic
    and uint64 has no >> on the CPU)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _wrap64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def hash_columns_plain(cols: list) -> torch.Tensor:
    """Plain PyTorch K3 over int64 bit patterns (wrapping multiply)."""
    words = _key_words(cols)
    h = torch.full((words.shape[1],), _wrap64(0xCBF29CE484222325),
                   dtype=torch.int64, device=words.device)
    prime = 0x100000001B3
    for x in words:
        h = (h ^ x) * prime
        h = h ^ _lshr(h, 29)
    return h


def hash_columns_cuda(cols: list) -> torch.Tensor:
    words = _key_words(cols)
    kernels.require_cuda("hash_columns", words)
    k, n = words.shape
    out = torch.empty(n, dtype=torch.int64, device=words.device)
    fn = kernels.bind("k3_hash", "k3_hash_columns",
                      [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(words.data_ptr(), k, n, out.data_ptr(), kernels.stream())
    kernels.check("k3_hash", "hash_columns", rc)
    kernels.LAUNCHES["K3"] += 1
    return out


def hash_columns(cols: list) -> torch.Tensor:
    """Combine key columns into one int64 key (K3)."""
    if cols[0].is_cuda:
        return hash_columns_cuda(cols)
    return hash_columns_plain(cols)


# --------------------------------------------------------------------------- #
# K3b: hash_columns32. u32 values are stored as int32 bit patterns, as the
# packed ring stores its words: torch.uint32 lacks most ops on the CPU.
# --------------------------------------------------------------------------- #

#: the join's invalid-row hash (u32 0xFFFFFFFF) and the value a real key
#: hashing to it is moved to (0xFFFFFFFE), as int32 bits
BIGKEY32 = -1
BIGKEY32_REMAP = -2
_FNV32 = 0x811C9DC5
_PRIME32 = 0x01000193
#: K3b word kinds, as the kernel reads them: 4-byte, 8-byte, bool
_K3B_4, _K3B_8, _K3B_BOOL = 0, 1, 2


def _k3b_kind(dt: torch.dtype) -> int:
    if dt == torch.bool:
        return _K3B_BOOL
    if dt.itemsize in (4, 8):
        return _K3B_8 if dt.itemsize == 8 else _K3B_4
    raise ValueError(f"hash_columns32: no word layout for {dt}")


def _words32(c: torch.Tensor) -> list:
    """The u32 words of one column as the JAX function takes them, as int64
    values in [0, 2^32): floats by their bits, 8-byte values low word
    first, bools and 4-byte values as one int32 word."""
    kind = _k3b_kind(c.dtype)
    if kind == _K3B_BOOL:
        return [c.to(torch.int64)]
    if kind == _K3B_8:
        w = c.contiguous().view(torch.int32).view(*c.shape, 2)
        return [w[..., 0].to(torch.int64) & _MASK32,
                w[..., 1].to(torch.int64) & _MASK32]
    return [c.contiguous().view(torch.int32).to(torch.int64) & _MASK32]


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def hash_columns32_plain(cols: list, remap: bool = False,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch K3b in int64 masked to 32 bits (a logical shift):
    h = (h ^ x) * 0x01000193; h ^= h >> 15 per word from 0x811C9DC5.
    `remap` moves a hash of 0xFFFFFFFF to 0xFFFFFFFE; `valid` (after the
    remap) sets invalid lanes to 0xFFFFFFFF. int32 bit patterns out."""
    cols = torch.broadcast_tensors(*cols)
    h = torch.full(cols[0].shape, _FNV32, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        for x in _words32(c):
            h = ((h ^ x) * _PRIME32) & _MASK32
            h = h ^ (h >> 15)
    h = to_u32_bits(h)
    if remap:
        h = torch.where(h == BIGKEY32, BIGKEY32_REMAP, h)
    if valid is not None:
        h = torch.where(valid, h, BIGKEY32)
    return h


def hash_columns32_cuda(cols: list, remap: bool = False,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K3b on the card: one thread per lane, the column pointers and kinds
    in the parameter block (at most k3b_max_cols() a launch; a wider key
    carries the running hash from one launch to the next)."""
    cols = [c.contiguous() for c in torch.broadcast_tensors(*cols)]
    extra = [valid.contiguous()] if valid is not None else []
    kernels.require_cuda("hash_columns32", *cols, *extra)
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != cols[0].shape):
        raise ValueError("hash_columns32: valid must be bool of the lanes' "
                         "shape")
    n = cols[0].numel()
    out = torch.empty(cols[0].shape, dtype=torch.int32,
                      device=cols[0].device)
    kinds = [_k3b_kind(c.dtype) for c in cols]
    P = ctypes.c_void_p
    fn = kernels.bind("k3_hash", "k3b_hash_columns32",
                      [P, P, ctypes.c_int, ctypes.c_longlong, P, P,
                       ctypes.c_int, P, P])
    step = kernels.library("k3_hash").k3b_max_cols()
    for c0 in range(0, len(cols), step):
        c1 = min(c0 + step, len(cols))
        last = c1 == len(cols)
        rc = fn((P * (c1 - c0))(*[c.data_ptr() for c in cols[c0:c1]]),
                (ctypes.c_int * (c1 - c0))(*kinds[c0:c1]), c1 - c0, n,
                out.data_ptr() if c0 else None,
                valid.data_ptr() if (last and valid is not None) else None,
                int(last and remap), out.data_ptr(), kernels.stream())
        kernels.check("k3_hash", "hash_columns32", rc)
        kernels.LAUNCHES["K3b"] += 1
    return out


def hash_columns32(cols: list, remap: bool = False,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """32-bit mix of key columns (K3b), int32 bit patterns of the u32
    hash. Collisions only cost re-verified candidates: joins re-check the
    exact condition."""
    if cols[0].is_cuda:
        return hash_columns32_cuda(cols, remap, valid)
    return hash_columns32_plain(cols, remap, valid)


# --------------------------------------------------------------------------- #
# K4: key table
# --------------------------------------------------------------------------- #


class KeyTable(NamedTuple):
    """Open-addressing device dictionary (see the JAX KeyTable): H = 2K
    int64 slots (INT64_MAX marks an empty slot), the dense id stored at each
    slot, the number of live keys and the lifetime unresolved lanes."""

    keys: torch.Tensor  # int64[H]
    ids: torch.Tensor  # int32[H]
    count: torch.Tensor  # int32 scalar
    misses: torch.Tensor  # int32 scalar


def init_key_table(capacity: int, device) -> KeyTable:
    H = 2 * capacity
    return KeyTable(
        keys=torch.full((H,), _KEY_PAD, dtype=torch.int64, device=device),
        ids=torch.zeros(H, dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        misses=torch.zeros((), dtype=torch.int32, device=device),
    )


def _probe_windows(keys: torch.Tensor, H: int) -> torch.Tensor:
    """[L, D] int64 probe slots of each key (u32 math in masked int64)."""
    lo = keys & _MASK32
    hi = _lshr(keys, 32)
    h32 = ((lo ^ hi) * 0x9E3779B9) & _MASK32
    base = h32 % H
    stride = 1 + 2 * (_lshr(h32, 16) & 7)
    off = torch.arange(_PROBE_DEPTH, dtype=torch.int64, device=keys.device)
    return (base[:, None] + off * stride[:, None]) % H


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none), like jnp.argmax."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def key_lookup_or_insert_plain(table: KeyTable, keys: torch.Tensor,
                               valid: torch.Tensor):
    """Plain PyTorch K4: the JAX algorithm step for step. Returns
    (new_table, ids int32[L], resolved bool[L])."""
    L = keys.shape[0]
    H = table.keys.shape[0]
    K = H // 2
    dev = keys.device
    keys = keys.to(torch.int64)
    keys = torch.where(keys == _KEY_PAD, _KEY_PAD - 1, keys)
    pslots = _probe_windows(keys, H)

    def probe(tbl, need, slot_of, wslot, won):
        pk = tbl[pslots]
        match = pk == keys[:, None]
        has_match = match.any(-1)
        mslot = torch.gather(pslots, 1, _first_true(match)[:, None])[:, 0]
        hit = need & has_match
        slot_of = torch.where(hit, mslot, slot_of)
        won = won | (hit & (mslot == wslot))
        need = need & ~has_match
        empty = pk == _KEY_PAD
        has_empty = empty.any(-1)
        eslot = torch.gather(pslots, 1, _first_true(empty)[:, None])[:, 0]
        return need, slot_of, won, has_empty, eslot

    tbl = table.keys.clone()
    id_arr = table.ids.clone()
    count = table.count.clone()
    slot_of = torch.zeros(L, dtype=torch.int64, device=dev)
    won = torch.zeros(L, dtype=torch.bool, device=dev)
    wslot = torch.full((L,), -1, dtype=torch.int64, device=dev)
    need, slot_of, won, has_empty, eslot = probe(tbl, valid, slot_of, wslot,
                                                 won)
    # the claim waves run unconditionally: lanes that need nothing are no-ops
    # (the JAX lax.cond skips them only as an optimisation)
    for _ in range(_INSERT_ROUNDS - 1):
        claim = need & has_empty
        cand = torch.where(claim, eslot, H)
        ext = torch.cat([tbl, tbl.new_full((1,), _KEY_PAD)])
        ext.scatter_reduce_(0, cand, keys, reduce="amin", include_self=True)
        tbl = ext[:H]
        wslot = torch.where(claim, eslot, -1)
        need, slot_of, won, has_empty, eslot = probe(tbl, need, slot_of,
                                                     wslot, won)
    ws = torch.where(won, slot_of, H)
    sw = torch.sort(ws).values
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      sw[1:] != sw[:-1]]) & (sw < H)
    rank = torch.cumsum(uniq.to(torch.int32), 0, dtype=torch.int32) - 1
    new_id = count + rank
    over = uniq & (new_id >= K)
    keep = uniq & (new_id < K)
    tbl = torch.cat([tbl, tbl.new_full((1,), _KEY_PAD)])
    tbl[torch.where(over, sw, H)] = _KEY_PAD
    tbl = tbl[:H]
    ids_ext = torch.cat([id_arr, id_arr.new_zeros(1)])
    ids_ext[torch.where(keep, sw, H)] = new_id
    id_arr = ids_ext[:H]
    n_new = keep.sum(dtype=torch.int32)
    count = torch.clamp(count + n_new, max=K).to(torch.int32)
    final_ok = tbl[slot_of] == keys
    resolved = valid & ~need & final_ok
    ids = torch.where(resolved, id_arr[slot_of], 0).to(torch.int32)
    misses = (table.misses + (valid & ~resolved).sum(dtype=torch.int32)).to(
        torch.int32)
    return KeyTable(tbl, id_arr, count, misses), ids, resolved


def key_lookup_or_insert_cuda(table: KeyTable, keys: torch.Tensor,
                              valid: torch.Tensor):
    """K4 on the card; updates `table`'s tensors in place."""
    if (keys.dtype != torch.int64 or valid.dtype != torch.bool
            or keys.dim() != 1 or valid.shape != keys.shape):
        raise ValueError("key_lookup_or_insert: keys int64[L], valid bool[L]")
    if table.keys.dtype != torch.int64 or table.ids.dtype != torch.int32:
        raise ValueError("key_lookup_or_insert: malformed key table")
    kernels.require_cuda("key_lookup_or_insert", table.keys, table.ids,
                         table.count, table.misses, keys, valid)
    L = keys.shape[0]
    H = table.keys.shape[0]
    K = H // 2
    dev = keys.device
    if L == 0:
        return (table, torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    need = valid.to(torch.uint8)
    slot_of = torch.zeros(L, dtype=torch.int32, device=dev)
    won = torch.zeros(L, dtype=torch.uint8, device=dev)
    wslot = torch.empty(L, dtype=torch.int32, device=dev)
    has_empty = torch.zeros(L, dtype=torch.uint8, device=dev)
    eslot = torch.zeros(L, dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    probe = kernels.bind("k4_keytable", "k4_probe_and_claim",
                         [P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          P, P, P, P, P, P, P])
    waves = _INSERT_ROUNDS - 1
    rc = probe(table.keys.data_ptr(), keys.data_ptr(), H, L, waves,
               need.data_ptr(), slot_of.data_ptr(), won.data_ptr(),
               wslot.data_ptr(), has_empty.data_ptr(), eslot.data_ptr(),
               kernels.stream())
    kernels.check("k4_keytable", "key_lookup_or_insert (probe/claim)", rc)
    kernels.LAUNCHES["K4"] += 1 + 2 * waves
    # dense ids for the batch's new entries: unique won slots ranked in slot
    # order
    ws = torch.where(won.bool(), slot_of, H)
    sw = torch.sort(ws).values
    uniq = torch.empty(L, dtype=torch.bool, device=dev)
    uniq[:1] = sw[:1] < H
    uniq[1:] = (sw[1:] != sw[:-1]) & (sw[1:] < H)
    rank = torch.cumsum(uniq, 0, dtype=torch.int32) - 1
    n_new = torch.zeros(1, dtype=torch.int32, device=dev)
    out_ids = torch.empty(L, dtype=torch.int32, device=dev)
    resolved = torch.empty(L, dtype=torch.bool, device=dev)
    commit = kernels.bind("k4_keytable", "k4_commit_and_resolve",
                          [P] * 9 + [ctypes.c_int, ctypes.c_int] + [P] * 6)
    rc = commit(table.keys.data_ptr(), table.ids.data_ptr(),
                sw.data_ptr(), uniq.data_ptr(), rank.data_ptr(),
                keys.data_ptr(), valid.data_ptr(), need.data_ptr(),
                slot_of.data_ptr(), L, K, table.count.data_ptr(),
                table.misses.data_ptr(), n_new.data_ptr(),
                out_ids.data_ptr(), resolved.data_ptr(), kernels.stream())
    kernels.check("k4_keytable", "key_lookup_or_insert (commit/resolve)", rc)
    kernels.LAUNCHES["K4"] += 2
    return table, out_ids, resolved


def key_lookup_or_insert(table: KeyTable, keys: torch.Tensor,
                         valid: torch.Tensor):
    """Resolve each lane's key to a dense id, inserting unseen keys (K4).
    Returns (table, ids int32[L], resolved bool[L]); unresolved lanes
    (id space or probe window exhausted) get id 0 and count in misses."""
    if keys.is_cuda:
        return key_lookup_or_insert_cuda(table, keys, valid)
    return key_lookup_or_insert_plain(table, keys, valid)


# --------------------------------------------------------------------------- #
# K5 / K5b: segmented scans with carry-in
# --------------------------------------------------------------------------- #


class GroupState(NamedTuple):
    """Per-key accumulator table of a component scanned on its own
    (`grouped_scan` / `ungrouped_scan`): values [K] and the epoch of each
    slot's last write; a value whose epoch is stale reads as the op's
    identity."""

    values: torch.Tensor
    epoch: torch.Tensor  # int32[K]


def init_group_state(capacity: int, dtype, device) -> GroupState:
    return GroupState(
        values=torch.zeros(capacity, dtype=dtype, device=device),
        epoch=torch.zeros(capacity, dtype=torch.int32, device=device))


def _op_sum(dtype):
    return torch.add, 0


def _op_min(dtype):
    return torch.minimum, (float("inf") if dtype.is_floating_point
                           else torch.iinfo(dtype).max)


def _op_max(dtype):
    return torch.maximum, (float("-inf") if dtype.is_floating_point
                           else torch.iinfo(dtype).min)


#: op -> (combine, identity) for a dtype
_OPS = {"sum": _op_sum, "min": _op_min, "max": _op_max}


def _segmented_scan(vals: torch.Tensor, seg_start: torch.Tensor,
                    combine) -> torch.Tensor:
    """Inclusive scan under `combine` restarting at each segment start, as
    log2(L) shifted-combine passes (the same conditional operator as the
    JAX associative_scan)."""
    s, f = vals, seg_start
    L = vals.shape[0]
    off = 1
    while off < L:
        s = torch.cat([s[:off], torch.where(f[off:], s[off:],
                                            combine(s[:-off], s[off:]))])
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        off *= 2
    return s


def _segment_starts_index(seg_start: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(seg_start.shape[0], device=seg_start.device)
    return torch.cummax(torch.where(seg_start, idx, 0), 0).values


def _lane_epochs(resets: torch.Tensor, current_epoch: torch.Tensor):
    return current_epoch + torch.cumsum(resets, 0, dtype=torch.int32)


def _shift(x: torch.Tensor, fill: int, forward: bool) -> torch.Tensor:
    pad = x.new_full((1,), fill)
    return torch.cat([pad, x[:-1]]) if forward else torch.cat([x[1:], pad])


def _scatter_drop(table: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """table.at[idx].set(vals, mode="drop") for idx in [0, K]: index K
    lands in a spare row that is cut off."""
    ext = torch.cat([table, table.new_zeros(1)])
    ext[idx] = vals
    return ext[:-1]


class _SegmentPlan(NamedTuple):
    """Per-batch segment structure shared by every component scanned over
    the same (slots, valid, resets). `order` is None for the ungrouped plan:
    its lanes are already in scan order."""

    order: Optional[torch.Tensor]
    s_slots: torch.Tensor
    s_epochs: torch.Tensor
    seg_start: torch.Tensor
    safe_slots: torch.Tensor
    epoch_ok_slots: torch.Tensor  # s_slots < K
    write_slot: torch.Tensor
    start_idx: torch.Tensor


def _segment_plan(slots, valid, resets, current_epoch, K) -> _SegmentPlan:
    slots_v = torch.where(valid, slots, K).to(torch.int32)
    lane_epoch = _lane_epochs(resets, current_epoch)
    order = stable_argsort_bounded(slots_v)
    s_slots = slots_v[order]
    s_epochs = lane_epoch[order]
    seg_start = ((s_slots != _shift(s_slots, -1, True))
                 | (s_epochs != _shift(s_epochs, -1, True)))
    ok = s_slots < K
    is_slot_end = s_slots != _shift(s_slots, -1, False)
    return _SegmentPlan(
        order=order, s_slots=s_slots, s_epochs=s_epochs, seg_start=seg_start,
        safe_slots=torch.clamp(s_slots, max=K - 1).long(),
        epoch_ok_slots=ok,
        write_slot=torch.where(ok & is_slot_end, s_slots, K).long(),
        start_idx=_segment_starts_index(seg_start))


def _ungrouped_plan(resets, current_epoch) -> _SegmentPlan:
    """The plan of one slot (K = 1) in arrival order: a segment starts at
    lane 0 and at each lane-epoch change; the last lane writes the cell."""
    lane_epoch = _lane_epochs(resets, current_epoch)
    L = lane_epoch.shape[0]
    dev = lane_epoch.device
    seg_start = lane_epoch != _shift(lane_epoch, -1, True)
    lane = torch.arange(L, device=dev)
    return _SegmentPlan(
        order=None, s_slots=torch.zeros(L, dtype=torch.int32, device=dev),
        s_epochs=lane_epoch, seg_start=seg_start,
        safe_slots=torch.zeros(L, dtype=torch.int64, device=dev),
        epoch_ok_slots=torch.ones(L, dtype=torch.bool, device=dev),
        write_slot=torch.where(lane == L - 1, 0, 1),
        start_idx=_segment_starts_index(seg_start))


def _unsort(s_out: torch.Tensor, order: Optional[torch.Tensor]):
    if order is None:
        return s_out
    out = torch.empty_like(s_out)
    out[order] = s_out
    return out


def _scan_component(values, epoch_table, deltas, valid, plan: _SegmentPlan,
                    op: str):
    """One component's segmented scan + carry + state write over a plan.
    Returns (new_values, sorted-order outputs)."""
    combine, identity = _OPS[op](deltas.dtype)
    s_deltas = torch.where(valid, deltas, identity)
    if plan.order is not None:
        s_deltas = s_deltas[plan.order]
    within = _segmented_scan(s_deltas, plan.seg_start, combine)
    stored_vals = values[plan.safe_slots]
    stored_epoch = epoch_table[plan.safe_slots]
    carry = torch.where(plan.epoch_ok_slots & (stored_epoch == plan.s_epochs),
                        stored_vals, identity)
    s_out = combine(carry[plan.start_idx], within)
    new_values = _scatter_drop(values, plan.write_slot,
                               s_out.to(values.dtype))
    return new_values, s_out


def _scan_plain(plan: _SegmentPlan, values_list, epoch_table, deltas_list,
                valid, op: str):
    """Every component against one epoch table over one plan (plain K5 and
    K5b). Returns (new_values_list, new_epoch_table, lane-order outputs)."""
    new_values, outs = [], []
    for values, deltas in zip(values_list, deltas_list):
        v, s_out = _scan_component(values, epoch_table, deltas, valid, plan,
                                   op)
        new_values.append(v)
        outs.append(_unsort(s_out, plan.order))
    new_epoch = _scatter_drop(epoch_table, plan.write_slot,
                              plan.s_epochs.to(epoch_table.dtype))
    return new_values, new_epoch, outs


def grouped_scan_fused_plain(values_list, shared_epoch, slots, deltas_list,
                             valid, resets, current_epoch):
    """Plain PyTorch K5 (the JAX `_segment_plan` + `grouped_scan_fused`).
    Returns (new_values_list, new_shared_epoch, per-lane outputs)."""
    plan = _segment_plan(slots, valid, resets, current_epoch,
                         shared_epoch.shape[0])
    return _scan_plain(plan, values_list, shared_epoch, deltas_list, valid,
                       "sum")


def ungrouped_scan_fused_plain(values_list, shared_epoch, deltas_list, valid,
                               resets, current_epoch):
    """Plain PyTorch K5 without GROUP BY (the JAX `ungrouped_scan_fused`)."""
    return _scan_plain(_ungrouped_plan(resets, current_epoch), values_list,
                       shared_epoch, deltas_list, valid, "sum")


def grouped_scan_plain(state: GroupState, slots, deltas, valid, resets,
                       current_epoch, op: str = "sum"):
    """Plain PyTorch K5b (the JAX `grouped_scan`): the one-component case."""
    plan = _segment_plan(slots, valid, resets, current_epoch,
                         state.values.shape[0])
    (v,), e, (out,) = _scan_plain(plan, [state.values], state.epoch,
                                  [deltas], valid, op)
    return GroupState(v, e), out


def ungrouped_scan_plain(state: GroupState, deltas, valid, resets,
                         current_epoch, op: str = "sum"):
    """Plain PyTorch K5b without GROUP BY (the JAX `ungrouped_scan`): lanes
    in arrival order, segments at reset boundaries, one state cell."""
    (v,), e, (out,) = _scan_plain(_ungrouped_plan(resets, current_epoch),
                                  [state.values], state.epoch, [deltas],
                                  valid, op)
    return GroupState(v, e), out


_K5_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}
_K5_OPS = {"sum": 0, "min": 1, "max": 2}


class _CudaPlan(NamedTuple):
    order: Optional[torch.Tensor]  # int64[n]; None: lanes in order
    s_slot: torch.Tensor
    s_epoch: torch.Tensor
    seg_start: torch.Tensor
    write_slot: torch.Tensor
    epoch_live: torch.Tensor


def _plan_buffers(n: int, dev):
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    return (torch.empty(n, **i32), torch.empty(n, **i32),
            torch.empty(n, **u8), torch.empty(n, **i32), torch.empty(n, **u8))


def _k5_plan_cuda(slots, valid, resets, current_epoch, epoch_table,
                  family: str) -> _CudaPlan:
    """torch.sort of the sentinel-masked slots, then the plan kernel."""
    K = epoch_table.shape[0]
    n = slots.shape[0]
    slots_v = torch.where(valid, slots, K).to(torch.int32)
    lane_epoch = _lane_epochs(resets, current_epoch).to(torch.int32)
    order = torch.sort(slots_v, stable=True).indices
    bufs = _plan_buffers(n, slots.device)
    P = ctypes.c_void_p
    plan = kernels.bind("k5_grouped_scan", "k5_segment_plan",
                        [P] * 4 + [ctypes.c_int, ctypes.c_int] + [P] * 6)
    rc = plan(slots_v.data_ptr(), lane_epoch.data_ptr(), order.data_ptr(),
              epoch_table.data_ptr(), K, n, *[b.data_ptr() for b in bufs],
              kernels.stream())
    kernels.check("k5_grouped_scan", f"{family} (plan)", rc)
    kernels.LAUNCHES[family] += 1
    return _CudaPlan(order, *bufs)


def _k5_ungrouped_plan_cuda(resets, current_epoch, epoch_cell,
                            family: str) -> _CudaPlan:
    n = resets.shape[0]
    lane_epoch = _lane_epochs(resets, current_epoch).to(torch.int32)
    bufs = _plan_buffers(n, resets.device)
    P = ctypes.c_void_p
    plan = kernels.bind("k5_grouped_scan", "k5_ungrouped_segment_plan",
                        [P, P, ctypes.c_int] + [P] * 6)
    rc = plan(lane_epoch.data_ptr(), epoch_cell.data_ptr(), n,
              *[b.data_ptr() for b in bufs], kernels.stream())
    kernels.check("k5_grouped_scan", f"{family} (plan)", rc)
    kernels.LAUNCHES[family] += 1
    return _CudaPlan(None, *bufs)


def _k5_scan_cuda(plan: _CudaPlan, op: str, values, deltas, valid,
                  epoch_table, family: str) -> torch.Tensor:
    """One component over a plan: values (and epoch_table, unless None)
    updated in place; returns the per-lane outputs in lane order."""
    n = deltas.shape[0]
    K = values.shape[0]
    out = torch.empty_like(deltas)
    block = kernels.library("k5_grouped_scan").k5_block_size()
    nb = -(-n // block)
    scratch = torch.empty((2 * n + 2 * nb) * deltas.element_size()
                          + 4 * nb + n, dtype=torch.uint8,
                          device=deltas.device)
    P = ctypes.c_void_p
    scan = kernels.bind("k5_grouped_scan", "k5_scan_component",
                        [ctypes.c_int, ctypes.c_int] + [P] * 12
                        + [ctypes.c_int, ctypes.c_int, P])
    rc = scan(_K5_OPS[op], _K5_DTYPES[deltas.dtype], deltas.data_ptr(),
              valid.data_ptr(),
              plan.order.data_ptr() if plan.order is not None else None,
              plan.s_slot.data_ptr(), plan.seg_start.data_ptr(),
              plan.epoch_live.data_ptr(), plan.write_slot.data_ptr(),
              plan.s_epoch.data_ptr(), values.data_ptr(),
              epoch_table.data_ptr() if epoch_table is not None else None,
              out.data_ptr(), scratch.data_ptr(), K, n, kernels.stream())
    kernels.check("k5_grouped_scan", f"{family} (scan)", rc)
    kernels.LAUNCHES[family] += 3
    return out


def _scan_cuda(plan: _CudaPlan, op: str, values_list, epoch_table,
               deltas_list, valid, family: str) -> list:
    """Every component over one plan; the last one writes the epochs (the
    plan read them before any write). Returns the lane-order outputs."""
    last = len(values_list) - 1
    return [_k5_scan_cuda(plan, op, v, d, valid,
                          epoch_table if c == last else None, family)
            for c, (v, d) in enumerate(zip(values_list, deltas_list))]


def _check_component(what, values, deltas, n):
    if values.dtype != deltas.dtype or values.dtype not in _K5_DTYPES:
        raise ValueError(f"{what}: values and deltas share one of "
                         "float32/float64/int64, got "
                         f"{values.dtype}/{deltas.dtype}")
    if values.dim() != 1 or deltas.shape != (n,):
        raise ValueError(f"{what}: values [K], deltas [L]")


def _check_lanes(what, n, valid, resets, current_epoch, slots=None):
    if (valid.shape != (n,) or resets.shape != (n,)
            or current_epoch.dim() != 0
            or (slots is not None and slots.dtype != torch.int32)):
        raise ValueError(f"{what}: int32 slots and valid/resets [L], "
                         "scalar epoch")


def _check_state(what, values_list, epoch_table, deltas_list, n,
                 cell: bool) -> None:
    if epoch_table.dtype != torch.int32:
        raise ValueError(f"{what}: int32 epoch table")
    if len(values_list) != len(deltas_list) or not values_list:
        raise ValueError(f"{what}: one deltas [L] per values [K]")
    for v, d in zip(values_list, deltas_list):
        _check_component(what, v, d, n)
        if v.shape != epoch_table.shape or (cell and v.shape != (1,)):
            raise ValueError(f"{what}: values shaped like the epoch table"
                             + (" [1]" if cell else ""))


def grouped_scan_fused_cuda(values_list, shared_epoch, slots, deltas_list,
                            valid, resets, current_epoch):
    """K5 on the card: torch sort by slot, then the plan kernel and three
    scan launches per component. Updates values and the epoch table in
    place."""
    kernels.require_cuda("grouped_scan_fused", shared_epoch, slots, valid,
                         resets, current_epoch, *values_list, *deltas_list)
    n = slots.shape[0]
    _check_lanes("grouped_scan_fused", n, valid, resets, current_epoch, slots)
    _check_state("grouped_scan_fused", values_list, shared_epoch, deltas_list,
                 n, cell=False)
    if n == 0:
        return (list(values_list), shared_epoch,
                [torch.empty_like(d) for d in deltas_list])
    plan = _k5_plan_cuda(slots, valid, resets, current_epoch, shared_epoch,
                         "K5")
    outs = _scan_cuda(plan, "sum", values_list, shared_epoch, deltas_list,
                      valid, "K5")
    return list(values_list), shared_epoch, outs


def ungrouped_scan_fused_cuda(values_list, shared_epoch, deltas_list, valid,
                              resets, current_epoch):
    """K5 without GROUP BY on the card: the ungrouped plan over lanes in
    order (no sort), then three scan launches per component. Updates the
    state cells in place."""
    kernels.require_cuda("ungrouped_scan_fused", shared_epoch, valid, resets,
                         current_epoch, *values_list, *deltas_list)
    n = valid.shape[0]
    _check_lanes("ungrouped_scan_fused", n, valid, resets, current_epoch)
    _check_state("ungrouped_scan_fused", values_list, shared_epoch,
                 deltas_list, n, cell=True)
    if n == 0:
        return (list(values_list), shared_epoch,
                [torch.empty_like(d) for d in deltas_list])
    plan = _k5_ungrouped_plan_cuda(resets, current_epoch, shared_epoch,
                                   "K5 ungrouped")
    outs = _scan_cuda(plan, "sum", values_list, shared_epoch, deltas_list,
                      valid, "K5 ungrouped")
    return list(values_list), shared_epoch, outs


def grouped_scan_cuda(state: GroupState, slots, deltas, valid, resets,
                      current_epoch, op: str = "sum"):
    """K5b on the card: the K5 sort and plan against this component's own
    epoch table, then one op-templated scan. Updates the state in place."""
    kernels.require_cuda("grouped_scan", state.values, state.epoch, slots,
                         deltas, valid, resets, current_epoch)
    n = slots.shape[0]
    _check_lanes("grouped_scan", n, valid, resets, current_epoch, slots)
    _check_state("grouped_scan", [state.values], state.epoch, [deltas], n,
                 cell=False)
    if n == 0:
        return state, torch.empty_like(deltas)
    plan = _k5_plan_cuda(slots, valid, resets, current_epoch, state.epoch,
                         "K5b grouped")
    (out,) = _scan_cuda(plan, op, [state.values], state.epoch, [deltas],
                        valid, "K5b grouped")
    return state, out


def ungrouped_scan_cuda(state: GroupState, deltas, valid, resets,
                        current_epoch, op: str = "sum"):
    """K5b without GROUP BY on the card: the ungrouped plan, then the
    op-templated scan. Updates the state cell in place."""
    kernels.require_cuda("ungrouped_scan", state.values, state.epoch, deltas,
                         valid, resets, current_epoch)
    n = deltas.shape[0]
    _check_lanes("ungrouped_scan", n, valid, resets, current_epoch)
    _check_state("ungrouped_scan", [state.values], state.epoch, [deltas], n,
                 cell=True)
    if n == 0:
        return state, torch.empty_like(deltas)
    plan = _k5_ungrouped_plan_cuda(resets, current_epoch, state.epoch,
                                   "K5b ungrouped")
    (out,) = _scan_cuda(plan, op, [state.values], state.epoch, [deltas],
                        valid, "K5b ungrouped")
    return state, out


def grouped_scan_fused(values_list, shared_epoch, slots, deltas_list, valid,
                       resets, current_epoch):
    """N sum-op components sharing (slots, valid, resets): one sort, one
    segment plan, one epoch table (K5). Returns (new_values_list,
    new_shared_epoch, per-lane post-update values in lane order)."""
    if slots.is_cuda:
        return grouped_scan_fused_cuda(values_list, shared_epoch, slots,
                                       deltas_list, valid, resets,
                                       current_epoch)
    return grouped_scan_fused_plain(values_list, shared_epoch, slots,
                                    deltas_list, valid, resets, current_epoch)


def grouped_scan(state: GroupState, slots, deltas, valid, resets,
                 current_epoch, op: str = "sum"):
    """One component per key under `op` (sum/min/max) with its own epoch
    table (K5b). Returns (new_state, per-lane post-update values)."""
    if slots.is_cuda:
        return grouped_scan_cuda(state, slots, deltas, valid, resets,
                                 current_epoch, op)
    return grouped_scan_plain(state, slots, deltas, valid, resets,
                              current_epoch, op)


def ungrouped_scan(state: GroupState, deltas, valid, resets, current_epoch,
                   op: str = "sum"):
    """`grouped_scan` for one group: no sort, segments at resets (K5b)."""
    if deltas.is_cuda:
        return ungrouped_scan_cuda(state, deltas, valid, resets,
                                   current_epoch, op)
    return ungrouped_scan_plain(state, deltas, valid, resets, current_epoch,
                                op)


def ungrouped_scan_fused(values_list, shared_epoch, deltas_list, valid,
                         resets, current_epoch):
    """`grouped_scan_fused` without GROUP BY: one slot, reset segmentation
    only, scalar state cells (K5, no sort)."""
    if valid.is_cuda:
        return ungrouped_scan_fused_cuda(values_list, shared_epoch,
                                         deltas_list, valid, resets,
                                         current_epoch)
    return ungrouped_scan_fused_plain(values_list, shared_epoch, deltas_list,
                                      valid, resets, current_epoch)
