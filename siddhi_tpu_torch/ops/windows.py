"""Window operators as `(state, batch) -> (state, chunk)` tensor functions
(counterpart of siddhi_tpu/ops/windows.py; this slice ports lengthBatch, the
sliding windows — length, time, timeLength, delay, externalTime — on the
packed ring, and the pass-through window).

A step consumes a fixed-capacity micro-batch and emits a typed chunk
(CURRENT / EXPIRED / RESET lanes) in the reference's emission order. Window
contents live in a ring addressed by 64-bit arrival indices; per-lane index
math is int32 relative to int64 scalars, as in the JAX code. The lengthBatch
rings carry one extra row past capacity that takes the writes the JAX
scatters drop (`mode="drop"`); it is never read. Ring tensors are updated in
place.

The sliding windows keep one packed ring: every row is W 32-bit words in a
word-major [W, C] matrix (columns in layout order, 8-byte values low word
first, the timestamp last), so each word row is contiguous and loads
coalesce. Its four memory passes are kernel K2b (csrc/k2b_packed_ring.cu):
pack-compact, ring fetch, ring append and the chunk gather. The words are
stored as torch.int32 holding the bits of JAX's uint32 words: torch.uint32
lacks most indexing and `where` ops on the CPU and on CUDA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import dtypes
from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from .search import searchsorted32, stable_partition_order

# emission-key kinds: expired lanes sort before reset before current at the
# same trigger position
KIND_EXPIRED = 0
KIND_RESET = 1
KIND_CURRENT = 2

BIG = 2**62


def compact(batch: EventBatch):
    """Stable-partition valid CURRENT lanes to the front (K1).
    Returns (cols, ts, n_valid int32 scalar, order)."""
    live = batch.valid & (batch.types == int(EventType.CURRENT))
    order = stable_partition_order(live).long()
    cols = {k: v[order] for k, v in batch.cols.items()}
    return cols, batch.ts[order], live.sum(dtype=torch.int32), order


def _gather_rel(ring_cols, ring_ts, comp_cols, comp_ts, appended0, base, offs):
    """Fetch events by overall arrival index base + offs: from the ring for
    pre-batch events, from the compacted batch for this batch's arrivals.
    Per-lane math is int32; `base` and `appended0` are int64 scalars."""
    C = ring_ts.shape[0] - 1
    B = comp_ts.shape[0]
    rel0 = (appended0 - base).to(torch.int32)
    from_batch = offs >= rel0
    batch_slot = torch.clamp(offs - rel0, 0, B - 1).long()
    # floored modulo: a negative base (no previous flush) wraps correctly
    ring_base = torch.remainder(base, C).to(torch.int32)
    ring_slot = torch.remainder(ring_base + offs, C).long()
    cols = {k: torch.where(from_batch, comp_cols[k][batch_slot],
                           ring_cols[k][ring_slot]) for k in ring_cols}
    ts = torch.where(from_batch, comp_ts[batch_slot], ring_ts[ring_slot])
    return cols, ts


def _scatter_append(ring_cols, ring_ts, comp_cols, comp_ts, appended0,
                    n_valid) -> None:
    """Write the batch's valid events into the ring at slot (appended0+p)%C,
    in place. With more than C arrivals only the last C survive; masked
    lanes write the spare row C."""
    C = ring_ts.shape[0] - 1
    B = comp_ts.shape[0]
    p = torch.arange(B, dtype=torch.int32, device=comp_ts.device)
    keep = (p < n_valid) & (p >= n_valid - C)
    base = torch.remainder(appended0, C).to(torch.int32)
    slot = torch.where(keep, torch.remainder(base + p, C), C).long()
    for k in ring_cols:
        ring_cols[k].index_put_((slot,), comp_cols[k])
    ring_ts.index_put_((slot,), comp_ts)


def _emit_key(comp_pos, kind, within, B):
    """Emission key pair: hi = (completion batch position, kind), lo =
    within-flush sequence, both int32."""
    hi = torch.clamp(comp_pos, -1, B).to(torch.int32) * 4 + kind
    return hi, within.to(torch.int32)


def _merge_order(keys, valids):
    """Global emission permutation for lane groups whose valid lanes carry
    nondecreasing (hi, lo) keys: per-group stable partition (K1) plus
    cross-group searchsorted rank sums, reproducing the stable
    concatenation order on ties. Valid lanes first, in key order; invalid
    lanes after, in concatenation order."""
    G = len(keys)
    lens = [k[0].shape[0] for k in keys]
    total = sum(lens)
    offsets = [sum(lens[:g]) for g in range(G)]
    dev = keys[0][0].device

    ck, orders, nvs = [], [], []
    for (hi, lo), v in zip(keys, valids):
        og = stable_partition_order(v.contiguous()).long()
        nv = v.sum(dtype=torch.int32)
        k = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
        k = k[og]
        k = torch.where(torch.arange(k.shape[0], device=dev) < nv, k, BIG)
        ck.append(k)
        orders.append(og)
        nvs.append(nv)
    total_valid = sum(nvs)

    order_all = torch.zeros(total, dtype=torch.int32, device=dev)
    inv_base = total_valid
    for g in range(G):
        iota = torch.arange(lens[g], dtype=torch.int32, device=dev)
        rank = iota
        for h in range(G):
            if h == g:
                continue
            side = "right" if h < g else "left"
            rank = rank + searchsorted32(ck[h], ck[g], side=side)
        is_val = iota < nvs[g]
        rank = torch.where(is_val, rank, inv_base + (iota - nvs[g]))
        inv_base = inv_base + (lens[g] - nvs[g])
        order_all[rank.long()] = (offsets[g] + orders[g]).to(torch.int32)
    return order_all


def _merge_sorted_chunks(keys, colss, tss, valids, types, width):
    order = _merge_order(keys, valids)[:width].long()
    all_cols = {k: torch.cat([c[k] for c in colss]) for k in colss[0]}
    return EventBatch(
        ts=torch.cat(tss)[order],
        cols={n: v[order] for n, v in all_cols.items()},
        valid=torch.cat(valids)[order],
        types=torch.cat(types)[order],
    )


def _empty_like_cols(layout: dict, n: int, device) -> dict:
    return {k: torch.zeros(n, dtype=dt, device=device)
            for k, dt in layout.items()}


class TypedLayout(dict):
    """Column layout (name -> device dtype) carrying the AttributeTypes
    behind it, for window factories that must tell STRING codes from raw
    ints (both int32 on device). Build with `make_layout`."""

    attr_types: dict


def make_layout(attr_types: dict) -> TypedLayout:
    """attr_types: name -> AttributeType (OBJECT already excluded)."""
    lo = TypedLayout({n: dtypes.device_dtype(t)
                      for n, t in attr_types.items()})
    lo.attr_types = dict(attr_types)
    return lo


# --------------------------------------------------------------------------- #
# K2b: the packed ring. Rows are [W, L] int32 words: every column in layout
# order (bool and 4-byte types one word, 8-byte types two, low word first),
# then the int64 timestamp as two words.
# --------------------------------------------------------------------------- #

#: word kind of a column for the K2b kernels: 4-byte, 8-byte, bool
_KIND_4, _KIND_8, _KIND_BOOL = 0, 1, 2


def _word_kind(dt: torch.dtype) -> int:
    if dt == torch.bool:
        return _KIND_BOOL
    if dt.itemsize == 8:
        return _KIND_8
    if dt.itemsize == 4:
        return _KIND_4
    raise ValueError(f"packed ring: no word layout for {dt}")


def _layout_words(layout: dict) -> int:
    """Words per packed row: the columns in layout order, then 2 ts words."""
    return sum(2 if _word_kind(dt) == _KIND_8 else 1
               for dt in layout.values()) + 2


def _words_to(lo: torch.Tensor, hi: torch.Tensor, dt) -> torch.Tensor:
    """Two word rows (low, high) as one 8-byte column."""
    return torch.stack([lo, hi], dim=-1).view(dt).squeeze(-1)


def _pack_rows(cols: dict, ts: torch.Tensor, layout: dict) -> torch.Tensor:
    """Columns + ts as a [W, L] int32 word matrix."""
    words = []
    for name in layout:
        a = cols[name]
        kind = _word_kind(a.dtype)
        if kind == _KIND_BOOL:
            words.append(a.to(torch.int32))
        elif kind == _KIND_8:
            w = a.contiguous().view(torch.int32).view(-1, 2)
            words += [w[:, 0], w[:, 1]]
        else:
            words.append(a.contiguous().view(torch.int32))
    w = ts.to(torch.int64).contiguous().view(torch.int32).view(-1, 2)
    words += [w[:, 0], w[:, 1]]
    return torch.stack(words)


def _unpack_rows(mat: torch.Tensor, layout: dict):
    """[W, L] words -> (cols, ts)."""
    cols = {}
    i = 0
    for name, dt in layout.items():
        kind = _word_kind(dt)
        if kind == _KIND_BOOL:
            cols[name] = mat[i] != 0
            i += 1
        elif kind == _KIND_8:
            cols[name] = _words_to(mat[i], mat[i + 1], dt)
            i += 2
        else:
            cols[name] = mat[i].view(dt)
            i += 1
    return cols, _words_to(mat[i], mat[i + 1], torch.int64)


def _packed_ts(mat: torch.Tensor) -> torch.Tensor:
    """The ts payload (last two words) of packed rows, as int64."""
    return _words_to(mat[-2], mat[-1], torch.int64)


def pack_compact_plain(cols: dict, ts: torch.Tensor, layout: dict,
                       order: torch.Tensor) -> torch.Tensor:
    """Plain K2b pack-compact: `_pack_rows`, then the gather by K1's order."""
    return _pack_rows(cols, ts, layout)[:, order.long()]


def _k2b(fn: str, argtypes: list):
    return kernels.bind("k2b_packed_ring", fn, argtypes)


def _c_array(ctype, values):
    return (ctype * len(values))(*values)


def _col_chunks(kinds: list):
    """(first column, end column, first word row) of each K2b launch: the
    kernels take at most k2b_max_cols() columns a launch."""
    step = kernels.library("k2b_packed_ring").k2b_max_cols()
    word = 0
    for c0 in range(0, len(kinds), step):
        c1 = min(c0 + step, len(kinds))
        yield c0, c1, word
        word += sum(2 if k == _KIND_8 else 1 for k in kinds[c0:c1])


def pack_compact_cuda(cols: dict, ts: torch.Tensor, layout: dict,
                      order: torch.Tensor) -> torch.Tensor:
    """K2b pack-compact on the card: writes the [W, B] words straight in
    K1's order from the typed columns, one launch per chunk of columns."""
    srcs = [cols[n].contiguous() for n in layout] + [ts.contiguous()]
    order = order.to(torch.int32).contiguous()
    kernels.require_cuda("pack_compact", order, *srcs)
    if ts.dtype != torch.int64 or order.shape != ts.shape:
        raise ValueError("pack_compact: int64 ts [B] and an int32 order [B]")
    B = ts.shape[0]
    kinds = [_word_kind(s.dtype) for s in srcs]
    W = _layout_words(layout)
    out = torch.empty((W, B), dtype=torch.int32, device=ts.device)
    P = ctypes.c_void_p
    fn = _k2b("k2b_pack_compact", [P, P, ctypes.c_int, ctypes.c_int, P,
                                   ctypes.c_int, P, P])
    for c0, c1, word0 in _col_chunks(kinds):
        rc = fn(_c_array(P, [s.data_ptr() for s in srcs[c0:c1]]),
                _c_array(ctypes.c_int, kinds[c0:c1]), c1 - c0, word0,
                order.data_ptr(), B, out.data_ptr(), kernels.stream())
        kernels.check("k2b_packed_ring", "pack_compact", rc)
        kernels.LAUNCHES["K2b pack"] += 1
    return out


def pack_compact(cols: dict, ts: torch.Tensor, layout: dict,
                 order: torch.Tensor) -> torch.Tensor:
    if ts.is_cuda:
        return pack_compact_cuda(cols, ts, layout, order)
    return pack_compact_plain(cols, ts, layout, order)


def compact_packed(batch: EventBatch, layout: dict):
    """compact() producing one packed matrix: (mat [W, B], n_valid int32).
    Lanes >= n_valid hold other lanes' words."""
    live = batch.valid & (batch.types == int(EventType.CURRENT))
    order = stable_partition_order(live)
    return (pack_compact(batch.cols, batch.ts, layout, order),
            live.sum(dtype=torch.int32))


def _append_packed_plain(ring, comp_mat, appended0, n_valid32):
    """Plain K2b ring append: the first n_valid columns of comp_mat at ring
    column (appended0 + p) % C (B <= C: at most one wrap); the rest of the
    ring unchanged. Returns a new ring."""
    W, C = ring.shape
    B = comp_mat.shape[1]
    p = torch.arange(B, dtype=torch.int64, device=ring.device)
    dest = torch.where(p < n_valid32, torch.remainder(appended0 + p, C), C)
    ext = torch.cat([ring, ring.new_zeros((W, 1))], dim=1)
    ext[:, dest] = comp_mat
    return ext[:, :C]


def _append_packed_cuda(ring, comp_mat, appended0, n_valid32):
    """K2b ring append on the card, in place."""
    kernels.require_cuda("append_packed", ring, comp_mat, appended0,
                         n_valid32)
    W, C = ring.shape
    B = comp_mat.shape[1]
    if (comp_mat.shape[0] != W or B > C or appended0.dtype != torch.int64
            or n_valid32.dtype != torch.int32):
        raise ValueError("append_packed: ring [W, C], batch [W, B <= C], "
                         "int64 appended0, int32 n_valid")
    P = ctypes.c_void_p
    fn = _k2b("k2b_append", [P, ctypes.c_int, P, ctypes.c_int, ctypes.c_int,
                             P, P, P])
    rc = fn(ring.data_ptr(), C, comp_mat.data_ptr(), B, W,
            appended0.data_ptr(), n_valid32.data_ptr(), kernels.stream())
    kernels.check("k2b_packed_ring", "append_packed", rc)
    kernels.LAUNCHES["K2b append"] += 1
    return ring


def _append_packed(ring, comp_mat, appended0, n_valid32):
    if ring.is_cuda:
        return _append_packed_cuda(ring, comp_mat, appended0, n_valid32)
    return _append_packed_plain(ring, comp_mat, appended0, n_valid32)


def _fetch_rel_packed_plain(ring, comp_mat, base_idx, appended0, E: int):
    """Plain K2b ring fetch: rows at overall indices base_idx + [0, E),
    from the ring for pre-batch rows and from the compacted batch for this
    batch's arrivals; batch lanes past the batch read zeros, as the JAX
    function's padding gives them."""
    W, C = ring.shape
    B = comp_mat.shape[1]
    dev = ring.device
    offs = torch.arange(E, dtype=torch.int32, device=dev)
    cand = ring[:, torch.remainder(base_idx + offs, C)]
    rel0 = (appended0 - base_idx).to(torch.int32)
    start = torch.clamp(E - rel0, 0, E)
    p = start + offs - E
    bat = torch.where((p >= 0) & (p < B),
                      comp_mat[:, torch.clamp(p, 0, B - 1).long()], 0)
    return torch.where(offs >= rel0, bat, cand)


def _fetch_rel_packed_cuda(ring, comp_mat, base_idx, appended0, E: int):
    kernels.require_cuda("fetch_rel_packed", ring, comp_mat, base_idx,
                         appended0)
    W, C = ring.shape
    B = comp_mat.shape[1]
    if (comp_mat.shape[0] != W or E > C or base_idx.dtype != torch.int64
            or appended0.dtype != torch.int64):
        raise ValueError("fetch_rel_packed: ring [W, C >= E], batch [W, B], "
                         "int64 scalars")
    out = torch.empty((W, E), dtype=torch.int32, device=ring.device)
    P = ctypes.c_void_p
    fn = _k2b("k2b_fetch", [P, ctypes.c_int, P] + [ctypes.c_int] * 3
              + [P, P, P, P])
    rc = fn(ring.data_ptr(), C, comp_mat.data_ptr(), B, W, E,
            base_idx.data_ptr(), appended0.data_ptr(), out.data_ptr(),
            kernels.stream())
    kernels.check("k2b_packed_ring", "fetch_rel_packed", rc)
    kernels.LAUNCHES["K2b fetch"] += 1
    return out


def _fetch_rel_packed(ring, comp_mat, base_idx, appended0, E: int):
    if ring.is_cuda:
        return _fetch_rel_packed_cuda(ring, comp_mat, base_idx, appended0, E)
    return _fetch_rel_packed_plain(ring, comp_mat, base_idx, appended0, E)


def _gather_chunk_packed_plain(order, payload_mat, emit_ts, valid, types,
                               layout: dict) -> EventBatch:
    """Plain K2b chunk gather: payload + emit ts + (valid, type) meta ride
    one [W + 3, L] matrix through one permutation gather."""
    ets = emit_ts.to(torch.int64).contiguous().view(torch.int32).view(-1, 2)
    meta = valid.to(torch.int32) | (types.to(torch.int32) << 1)
    W = payload_mat.shape[0]
    full = torch.cat([payload_mat, ets.T, meta[None, :]])[:, order.long()]
    cols, _stored_ts = _unpack_rows(full[:W], layout)
    m = full[W + 2]
    return EventBatch(ts=_words_to(full[W], full[W + 1], torch.int64),
                      cols=cols, valid=(m & 1) != 0,
                      types=(m >> 1).to(torch.int8))


def _gather_chunk_packed_cuda(order, payload_mat, emit_ts, valid, types,
                              layout: dict) -> EventBatch:
    order = order.to(torch.int32).contiguous()
    kernels.require_cuda("gather_chunk_packed", order, payload_mat, emit_ts,
                         valid, types)
    W, L = payload_mat.shape
    if (W != _layout_words(layout) or emit_ts.shape != (L,)
            or valid.shape != (L,) or types.shape != (L,)
            or emit_ts.dtype != torch.int64 or valid.dtype != torch.bool
            or types.dtype != torch.int8):
        raise ValueError("gather_chunk_packed: payload [W, L], int64 emit "
                         "ts, bool valid and int8 types [L]")
    width = order.shape[0]
    dev = payload_mat.device
    cols = {n: torch.empty(width, dtype=dt, device=dev)
            for n, dt in layout.items()}
    ts = torch.empty(width, dtype=torch.int64, device=dev)
    valid_out = torch.empty(width, dtype=torch.bool, device=dev)
    types_out = torch.empty(width, dtype=torch.int8, device=dev)
    outs = list(cols.values())
    kinds = [_word_kind(dt) for dt in layout.values()]
    P = ctypes.c_void_p
    fn = _k2b("k2b_gather", [P, P] + [ctypes.c_int] * 3 + [P, ctypes.c_int,
                                                           P, ctypes.c_int]
              + [P] * 7)
    # a layout of no columns still takes one launch, for ts/valid/type
    chunks = list(_col_chunks(kinds)) or [(0, 0, 0)]
    for i, (c0, c1, word0) in enumerate(chunks):
        rc = fn(_c_array(P, [c.data_ptr() for c in outs[c0:c1]]),
                _c_array(ctypes.c_int, kinds[c0:c1]), c1 - c0, word0,
                int(i == 0), order.data_ptr(), width, payload_mat.data_ptr(),
                L, emit_ts.data_ptr(), valid.data_ptr(), types.data_ptr(),
                ts.data_ptr(), valid_out.data_ptr(), types_out.data_ptr(),
                kernels.stream())
        kernels.check("k2b_packed_ring", "gather_chunk_packed", rc)
        kernels.LAUNCHES["K2b gather"] += 1
    return EventBatch(ts=ts, cols=cols, valid=valid_out, types=types_out)


def _gather_chunk_packed(order, payload_mat, emit_ts, valid, types,
                         layout: dict) -> EventBatch:
    """Apply an emission permutation to packed rows and unpack them."""
    if payload_mat.is_cuda:
        return _gather_chunk_packed_cuda(order, payload_mat, emit_ts, valid,
                                         types, layout)
    return _gather_chunk_packed_plain(order, payload_mat, emit_ts, valid,
                                      types, layout)


def _ring_live_mask(ring_len: int, lo: torch.Tensor, hi: torch.Tensor):
    """Valid-slot mask for a ring holding overall indices [lo, hi): slot
    s's most recent write is idx = hi-1 - ((hi-1-s) % C); live iff >= lo."""
    s = torch.arange(ring_len, dtype=torch.int64, device=lo.device)
    last_written = hi - 1 - torch.remainder(hi - 1 - s, ring_len)
    return (last_written >= 0) & (last_written >= lo) & (last_written < hi)


def window_has_time_semantics(window: "WindowOp") -> bool:
    """True if the window needs heartbeats (empty timer batches) to emit
    expirations when no data arrives (the reference Scheduler's TIMER
    events). Of the ported windows, the time-bound sliding ones."""
    return getattr(window, "time_ms", None) is not None


class WindowOp:
    """Base window operator."""

    #: chunk width produced per step for a full-capacity batch
    chunk_width: int
    #: True when step() works at any lane count (no baked-in capacity)
    shape_polymorphic = False

    def init_state(self, device):
        raise NotImplementedError

    def step(self, state, batch: EventBatch, now):
        raise NotImplementedError


class BatchState(NamedTuple):
    """The JAX BatchState's fields; rings are [C + 1] (spare row last)."""

    ring_cols: dict
    ring_ts: torch.Tensor
    appended: torch.Tensor  # int64 total arrivals
    flushed: torch.Tensor  # int64 arrivals already emitted
    prev_start: torch.Tensor  # int64 start index of the previous flush
    epoch_base: torch.Tensor  # int64 (time batches only)
    has_base: torch.Tensor  # bool (time batches only)
    wm: torch.Tensor  # int64 (external-time batches only)


class LengthBatchWindow(WindowOp):
    """lengthBatch(N): tumbling count window. At each flush boundary emits
    [expired lanes of the previous flush, RESET, N current lanes]."""

    def __init__(self, layout: dict, batch_cap: int, length: int,
                 expired_on: bool = True):
        if length <= 0:
            raise SiddhiAppCreationError("lengthBatch length must be > 0")
        self.layout = layout
        self.B = batch_cap
        self.N = length
        self.expired_on = expired_on
        self.C = 2 * length + batch_cap  # prev flush + partial + batch
        max_flushes = batch_cap // length + 2
        width = batch_cap + length
        if expired_on:
            width += batch_cap + length
        width += max_flushes
        self.chunk_width = width
        self._max_flushes = max_flushes

    def init_state(self, device) -> BatchState:
        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        return BatchState(
            ring_cols=_empty_like_cols(self.layout, self.C + 1, device),
            ring_ts=torch.zeros(self.C + 1, dtype=dtypes.TS_DTYPE,
                                device=device),
            appended=i64(0), flushed=i64(0), prev_start=i64(-1),
            epoch_base=i64(0),
            has_base=torch.tensor(False, device=device),
            wm=i64(-(2**62)))

    def step(self, state: BatchState, batch: EventBatch, now):
        B, N = self.B, self.N
        dev = batch.ts.device
        comp_cols, comp_ts, n_valid, _ = compact(batch)
        appended1 = state.appended + n_valid

        f_done = torch.div(state.flushed, N, rounding_mode="floor")
        f_now = torch.div(appended1, N, rounding_mode="floor")
        nf = (f_now - f_done).to(torch.int32)  # flushes completing now
        r0 = (state.appended - state.flushed).to(torch.int32)  # partial len

        cur_count_max = B + N
        p_cur = torch.arange(cur_count_max, dtype=torch.int32, device=dev)
        cur_exists = p_cur < nf * N
        cur_cols, cur_ts = _gather_rel(
            state.ring_cols, state.ring_ts, comp_cols, comp_ts,
            state.appended, state.flushed, p_cur)
        cur_comp = (p_cur // N + 1) * N - 1 - r0  # batch pos of flush end
        cur_keys = _emit_key(cur_comp, KIND_CURRENT, p_cur % N, B)

        MF = self._max_flushes
        f_rel = torch.arange(MF, dtype=torch.int32, device=dev)
        reset_exists = f_rel < nf
        reset_comp = (f_rel + 1) * N - 1 - r0
        reset_keys = _emit_key(reset_comp, KIND_RESET,
                               torch.zeros(MF, dtype=torch.int32, device=dev),
                               B)
        reset_cols = _empty_like_cols(self.layout, MF, dev)
        reset_ts = comp_ts[torch.clamp(reset_comp, 0, B - 1).long()]

        keys = [cur_keys, reset_keys]
        colss = [cur_cols, reset_cols]
        tss = [cur_ts, reset_ts]
        valids = [cur_exists, reset_exists]
        types = [torch.full((cur_count_max,), int(EventType.CURRENT),
                            dtype=torch.int8, device=dev),
                 torch.full((MF,), int(EventType.RESET), dtype=torch.int8,
                            device=dev)]

        if self.expired_on:
            # events of flush f re-emitted as expired when flush f+1
            # completes; base (f_done - 1) * N
            p_exp = p_cur
            exp_flush_rel = p_exp // N - 1
            exp_exists = ((f_done >= 1) | (p_exp >= N)) & (
                (exp_flush_rel + 1) < nf)
            exp_cols, _ = _gather_rel(
                state.ring_cols, state.ring_ts, comp_cols, comp_ts,
                state.appended, (f_done - 1) * N, p_exp)
            exp_comp = (exp_flush_rel + 2) * N - 1 - r0
            exp_keys = _emit_key(exp_comp, KIND_EXPIRED, p_exp % N, B)
            # the reference re-stamps expired events with the current time
            exp_ts = comp_ts[torch.clamp(exp_comp, 0, B - 1).long()]
            keys.append(exp_keys)
            colss.append(exp_cols)
            tss.append(exp_ts)
            valids.append(exp_exists)
            types.append(torch.full((cur_count_max,), int(EventType.EXPIRED),
                                    dtype=torch.int8, device=dev))

        chunk = _merge_sorted_chunks(keys, colss, tss, valids, types,
                                     self.chunk_width)

        _scatter_append(state.ring_cols, state.ring_ts, comp_cols, comp_ts,
                        state.appended, n_valid)
        new_state = state._replace(
            appended=appended1, flushed=f_now * N,
            prev_start=(f_now - 1) * N)
        return new_state, chunk

    def contents(self, state: BatchState, now):
        """Joins see the accumulating (unflushed) bucket: ring rows
        [flushed, appended), without the spare row."""
        live = _ring_live_mask(self.C, state.flushed, state.appended)
        return ({k: v[:self.C] for k, v in state.ring_cols.items()},
                state.ring_ts[:self.C], live)


class PassThroughWindow(WindowOp):
    """No window: batch lanes flow through as CURRENT."""

    shape_polymorphic = True

    def __init__(self, layout: dict, batch_cap: int):
        self.layout = layout
        self.B = batch_cap
        self.chunk_width = batch_cap

    def init_state(self, device):
        return ()

    def step(self, state, batch: EventBatch, now):
        return state, batch

    def contents(self, state, now, device=None):
        """A windowless join side holds nothing: only the arriving event
        matches. The state is empty, so the caller names the device."""
        dev = torch.device("cpu") if device is None else device
        return (_empty_like_cols(self.layout, 1, dev),
                torch.zeros(1, dtype=dtypes.TS_DTYPE, device=dev),
                torch.zeros(1, dtype=torch.bool, device=dev))


# --------------------------------------------------------------------------- #
# sliding windows (length, time, timeLength, delay, externalTime)
# --------------------------------------------------------------------------- #


class SlidingState(NamedTuple):
    ring: torch.Tensor  # int32[W, C] packed rows (all columns + ts words)
    appended: torch.Tensor  # int64 total valid arrivals ever
    expired: torch.Tensor  # int64 total expirations ever
    wm: torch.Tensor  # int64 external-time watermark (externalTime only)
    overflow: torch.Tensor  # int64 lifetime live rows overwritten past C


class SlidingWindow(WindowOp):
    """Unified FIFO sliding window: length(N), time(W), timeLength(W, N),
    delay(W) and externalTime(attr, W) are one machine with different
    expiry rules. Events expire in arrival order (timestamps are monotone
    per junction), so the window is the contiguous range [expired,
    appended) of overall indices, held in the packed ring."""

    shape_polymorphic = True  # step() reads B from the batch (buckets)

    def __init__(self, layout: dict, batch_cap: int, *,
                 length: Optional[int] = None,
                 time_ms: Optional[int] = None,
                 capacity: Optional[int] = None,
                 max_expired: Optional[int] = None,
                 is_delay: bool = False,
                 ts_attr: Optional[str] = None):
        self.layout = layout
        self.B = batch_cap
        self.length = length
        self.time_ms = time_ms
        self.is_delay = is_delay
        #: externalTime(tsAttr, W): expiry follows an event attribute clock
        self.ts_attr = ts_attr
        # the packed FIFO append requires B <= C
        if length is not None and time_ms is None:
            self.C = max(length, batch_cap, 1)
        else:
            self.C = max(capacity or dtypes.config.default_window_capacity,
                         batch_cap)
        self.E = max_expired if max_expired is not None else (
            batch_cap if (length is not None and time_ms is None)
            else max(batch_cap, 1024))
        # the candidate fetch reads E rows from the ring: C >= E
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

    def step(self, state: SlidingState, batch: EventBatch, now):
        # B is the incoming batch's capacity (<= self.B for bucketed
        # batches); E and C stay fixed
        B, E, C = batch.capacity, self.E, self.C
        dev = batch.ts.device
        comp_mat, n_valid32 = compact_packed(batch, self.layout)
        n_valid = n_valid32.to(torch.int64)
        lane_b = torch.arange(B, dtype=torch.int32, device=dev)

        if self.ts_attr is not None:
            # the attribute clock replaces the packed ts words, so ring rows
            # carry the expiry-relevant time; the watermark is the largest
            # attribute value seen
            tcols, _ = _unpack_rows(comp_mat, self.layout)
            comp_ts = tcols[self.ts_attr].to(torch.int64)
            w = comp_ts.contiguous().view(torch.int32).view(-1, 2)
            comp_mat[-2] = w[:, 0]
            comp_mat[-1] = w[:, 1]
            mx = torch.where(lane_b < n_valid32, comp_ts, -(2**62)).max()
            wm = torch.maximum(state.wm, mx)
            now = wm
        else:
            comp_ts = _packed_ts(comp_mat)
            wm = state.wm

        appended1 = state.appended + n_valid

        # expiry candidates: the E oldest in-window events
        pe = torch.arange(E, dtype=torch.int32, device=dev)
        win_len1 = (appended1 - state.expired).to(torch.int32)
        cand_exists = pe < win_len1
        cand_mat = _fetch_rel_packed(state.ring, comp_mat, state.expired,
                                     state.appended, E)
        cand_ts = _packed_ts(cand_mat)

        if self.time_ms is not None:
            # a candidate expires once now >= ts + W, before the first
            # arrival with ts >= its deadline (ties expire first), or at the
            # end of the batch when only the final time covers it
            deadline = cand_ts + self.time_ms
            trig_time = searchsorted32(
                torch.where(lane_b < n_valid32, comp_ts, BIG), deadline,
                side="left")
            time_fires = deadline <= now
        if self.length is not None:
            # length(N): candidate o leaves at the arrival with overall
            # index o + N; its position in this batch, relative -> int32
            rel = (state.expired + self.length
                   - state.appended).to(torch.int32)
            trig_len = pe + rel
            len_fires = trig_len < n_valid32

        if self.length is None:
            trig, expires, emit_ts = trig_time, cand_exists & time_fires, \
                deadline
        elif self.time_ms is None:
            trig = trig_len
            expires = cand_exists & len_fires
            # evicted events carry the current time (the evicting arrival's)
            emit_ts = comp_ts[torch.clamp(trig, 0, B - 1).long()]
        else:
            # timeLength(W, N): whichever rule fires first
            trig = torch.where(
                time_fires & len_fires, torch.minimum(trig_time, trig_len),
                torch.where(time_fires, trig_time, trig_len))
            expires = cand_exists & (time_fires | len_fires)
            emit_ts = torch.where(
                time_fires & (trig_time <= trig_len), deadline,
                comp_ts[torch.clamp(trig, 0, B - 1).long()])

        n_expired_new = expires.sum(dtype=torch.int64)

        # chunk: E expired lanes + B current lanes, rank-merged
        cur_valid = lane_b < n_valid32
        keys_exp = torch.clamp(trig, 0, B) * 4 + KIND_EXPIRED
        keys_cur = lane_b * 4 + KIND_CURRENT
        all_mat = torch.cat([cand_mat, comp_mat], dim=1)
        all_emit = torch.cat([emit_ts, comp_ts])
        if self.is_delay:
            # delay(W): expired lanes re-emit as CURRENT after the delay;
            # arrivals are swallowed
            cur_v = torch.zeros(B, dtype=torch.bool, device=dev)
            all_types = torch.full((E + B,), int(EventType.CURRENT),
                                   dtype=torch.int8, device=dev)
        else:
            cur_v = cur_valid
            all_types = torch.cat([
                torch.full((E,), int(EventType.EXPIRED), dtype=torch.int8,
                           device=dev),
                torch.full((B,), int(EventType.CURRENT), dtype=torch.int8,
                           device=dev)])
        all_valid = torch.cat([expires, cur_v])
        order = _merge_order([(keys_exp, pe), (keys_cur, lane_b)],
                             [expires, cur_v])
        chunk = _gather_chunk_packed(order, all_mat, all_emit, all_valid,
                                     all_types, self.layout)

        # the ring append comes after the fetch, whose range it can overlap
        ring = _append_packed(state.ring, comp_mat, state.appended, n_valid32)

        # live rows overwritten by the ring wrap (a time window holding more
        # than C rows): the new excess of this step
        expired1 = state.expired + n_expired_new
        over0 = torch.clamp(state.appended - state.expired - C, min=0)
        over1 = torch.clamp(appended1 - expired1 - C, min=0)
        new_state = SlidingState(
            ring=ring, appended=appended1, expired=expired1, wm=wm,
            overflow=state.overflow + torch.clamp(over1 - over0, min=0))
        return new_state, chunk

    def contents(self, state: SlidingState, now):
        """In-window rows as (cols, ts, live) over the ring, for probes."""
        ring_cols, ring_ts = _unpack_rows(state.ring, self.layout)
        live = _ring_live_mask(self.C, state.expired, state.appended)
        if self.time_ms is not None:
            # rows past their deadline are out even before a batch flushes
            live = live & (ring_ts + self.time_ms > now)
        return ring_cols, ring_ts, live
