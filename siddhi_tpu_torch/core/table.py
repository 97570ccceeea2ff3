"""In-memory tables: CRUD event stores queryable from streams (counterpart
of siddhi_tpu/core/table.py).

A table is a columnar device store: capacity-padded column tensors, row
timestamps and a validity mask (`TableState`). Conditions compile once
into broadcastable column functions: stream frames enter the scope as
[B, 1] columns and the table frame as [C] columns, so a mixed condition
evaluates to a [B, C] cross mask.

- insert: a primary-key dedup against the live rows and the earlier lanes
  (K13d dedup, one launch through a hash of the keys), the free rows in
  row order (K1), and one launch that places every staying lane there
  (K13d place) unless they overflow; the overflow and the dropped count
  come back in one host read, the only one a table write makes;
- delete, update, update or insert: the mask's per-row any, last matching
  event and per-event any in one launch (K13e). An ON condition of `==`
  compares between table and output sides hashes its keys instead (the
  equality route: no [B, C] mask); any other condition is read as
  evaluated, through its strides, with the valid vectors folded in (the
  mask route). SET expressions evaluate on the [C] frame of (the row's
  last matching event, the row);
- `expr in T`: the sorted index of an @Index or sole primary-key attribute
  (K7 sort, rebuilt lazily after a mutation; K6's search), or the
  per-event any of the condition (K13e's mask route).

The JAX package's documented divergences hold: an update applies the last
matching event per row with SET evaluated against the row as it was
before the batch; two new events of one batch with one primary key insert
once (the first); a duplicate primary-key insert is dropped and counted,
not raised; an overflowing insert raises CapacityExceededError and leaves
the table as it was. On the card the insert writes the table's tensors in
place (JAX builds a new state): callers use the returned state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..errors import CapacityExceededError, SiddhiAppCreationError
from ..ops.expr_compile import (Scope, TypeResolver, compile_expression,
                                equality_key_plan)
from ..ops.groupby import _scatter_drop
from ..ops.search import (float64_sort_key, searchsorted32,
                          stable_partition_order, stable_radix_argsort)
from ..query_api.definition import AttributeType, TableDefinition
from ..query_api.execution import OutputAction, OutputStream
from ..query_api.expression import Variable
from . import dtypes
from .context import SiddhiAppContext
from .event import EventBatch, StreamCodec


class TableState(NamedTuple):
    """Device-resident table contents."""

    cols: dict
    ts: torch.Tensor  # int64[C]
    valid: torch.Tensor  # bool[C]


def broadcast_to(x, shape, device) -> torch.Tensor:
    """x broadcast to `shape` on `device` (a compiled constant is a 0-d CPU
    tensor)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x)
    if x.device != device:
        if x.dim() == 0:
            return torch.full(shape, x.item(), dtype=x.dtype, device=device)
        x = x.to(device)
    return torch.broadcast_to(x, shape)


def _broadcast_scope(scope: Scope, table_id: str, tstate: TableState):
    """`scope`'s [B] frames as [B, 1] ones plus the [C] table frame, so
    compiled conditions evaluate to [B, C] cross masks."""
    s2 = Scope()
    for ref, cols in scope.frames.items():
        s2.add_frame(ref, {k: v[:, None] for k, v in cols.items()},
                     scope.ts[ref][:, None], scope.valids[ref][:, None],
                     default=(ref == scope.default_frame))
    s2.add_frame(table_id, tstate.cols, tstate.ts, tstate.valid)
    s2.extras = dict(scope.extras)
    return s2


# --------------------------------------------------------------------------- #
# K13d: primary-key dedup and placement
# --------------------------------------------------------------------------- #

#: the kernels' key types (csrc/k13_keys.cuh KeyType)
_KEY_TYPE = {torch.bool: 0, torch.int8: 0, torch.int32: 1, torch.int64: 2,
             torch.float32: 3, torch.float64: 4}


def pk_duplicates_plain(lane_keys: Sequence[torch.Tensor],
                        row_keys: Sequence[torch.Tensor],
                        lane_valid: torch.Tensor,
                        row_valid: torch.Tensor) -> torch.Tensor:
    """Plain K13d dedup, the JAX form: the [B, C] and [B, B] equality
    masks. A valid lane is a duplicate when a live row or an earlier valid
    lane has equal key columns. bool[B]."""
    B, C = lane_valid.shape[0], row_valid.shape[0]
    dev = lane_valid.device
    eq = torch.ones((B, C), dtype=torch.bool, device=dev)
    for a, r in zip(lane_keys, row_keys):
        eq = eq & (a[:, None] == r[None, :])
    dup = (eq & row_valid[None, :]).any(dim=1)
    eq_b = torch.ones((B, B), dtype=torch.bool, device=dev)
    for a in lane_keys:
        eq_b = eq_b & (a[:, None] == a[None, :])
    earlier = torch.tril(torch.ones((B, B), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup_in_batch = (eq_b & earlier & lane_valid[None, :]).any(dim=1)
    return (dup | dup_in_batch) & lane_valid


_K13D = "k13d_table_insert"


def _k13d_workspace(B: int, C: int, device) -> torch.Tensor:
    """The library's workspace for B lanes against C rows (the dedup's
    hash table, or the placement's block counts), zero between launches."""
    nbytes = kernels.bind(_K13D, "k13d_workspace_bytes",
                          [ctypes.c_int, ctypes.c_int],
                          restype=ctypes.c_longlong)(B, C)
    if nbytes <= 0:
        raise kernels.KernelError("K13d: the card has no cooperative "
                                  "launches")
    return kernels.workspace(_K13D, nbytes, device)


def pk_duplicates_cuda(lane_keys, row_keys, lane_valid, row_valid, *,
                       counter: str = "K13d dedup") -> torch.Tensor:
    """K13d dedup on the card: one launch that hashes the live rows' and
    valid lanes' keys into the workspace and probes it."""
    if not 1 <= len(lane_keys) == len(row_keys) <= 4:
        raise ValueError("pk_duplicates: 1 to 4 key columns")
    lanes, rows, types = [], [], []
    for a, r in zip(lane_keys, row_keys):
        dt = torch.promote_types(a.dtype, r.dtype)  # as `==` compares
        if dt not in _KEY_TYPE:
            raise ValueError(f"pk_duplicates: key dtype {dt}")
        lanes.append(a.to(dt).contiguous())
        rows.append(r.to(dt).contiguous())
        types.append(_KEY_TYPE[dt])
    kernels.require_cuda("pk_duplicates", lane_valid, row_valid, *lanes,
                         *rows)
    B, C = lane_valid.shape[0], row_valid.shape[0]
    dev = lane_valid.device
    drop = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return drop
    ws = _k13d_workspace(B, C, dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    n = len(lanes)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    rc = kernels.bind(_K13D, "k13d_dedup",
                      [P, P, P, I, P, P, I, I, P, P, P])(
        ptrs(lanes), ptrs(rows), (ctypes.c_int * n)(*types), n,
        lane_valid.data_ptr(), row_valid.data_ptr(), B, C, drop.data_ptr(),
        ws.data_ptr(), kernels.stream())
    kernels.check(_K13D, "pk_duplicates", rc, dev)
    kernels.LAUNCHES[counter] += 1
    return drop


def pk_duplicates(lane_keys, row_keys, lane_valid, row_valid, *,
                  counter: str = "K13d dedup") -> torch.Tensor:
    if lane_valid.is_cuda:
        return pk_duplicates_cuda(lane_keys, row_keys, lane_valid, row_valid,
                                  counter=counter)
    return pk_duplicates_plain(lane_keys, row_keys, lane_valid, row_valid)


def place_rows_plain(tstate: TableState, cols: dict, ts: torch.Tensor,
                     valid: torch.Tensor, drop: Optional[torch.Tensor],
                     free_order: torch.Tensor):
    """Plain K13d place, the JAX form: rank the staying lanes, take the
    r-th free row, scatter every column, ts and valid there. Returns (new
    state, int32[2] of overflow and dropped); the caller discards the
    state on overflow."""
    C = tstate.ts.shape[0]
    ins = valid if drop is None else valid & ~drop
    n_ins = ins.sum(dtype=torch.int32)
    n_free = (~tstate.valid).sum(dtype=torch.int32)
    rank = torch.cumsum(ins.to(torch.int32), 0, dtype=torch.int32) - 1
    fits = ins & (rank < n_free)
    slot = torch.where(fits, free_order[torch.clamp(rank, 0, C - 1).long()],
                       C).long()
    new_cols = {k: _scatter_drop(v, slot, cols[k].to(v.dtype))
                for k, v in tstate.cols.items()}
    new_ts = _scatter_drop(tstate.ts, slot, ts)
    new_valid = _scatter_drop(tstate.valid, slot,
                              torch.ones_like(valid))
    overflow = n_ins - fits.sum(dtype=torch.int32)
    dropped = (valid & ~ins).sum(dtype=torch.int32)
    return (TableState(new_cols, new_ts, new_valid),
            torch.stack([overflow, dropped]))


def place_rows_cuda(tstate: TableState, cols: dict, ts: torch.Tensor,
                    valid: torch.Tensor, drop: Optional[torch.Tensor],
                    free_order: torch.Tensor, *,
                    counter: str = "K13d place"):
    """K13d place on the card: one launch over the whole card, in place;
    writes nothing when the staying lanes overflow the free rows."""
    names = list(tstate.cols)
    dsts = [tstate.cols[k] for k in names] + [tstate.ts]
    srcs = [cols[k].to(tstate.cols[k].dtype).contiguous() for k in names]
    srcs.append(ts.contiguous())
    free_order = free_order.to(torch.int32).contiguous()
    extra = [drop] if drop is not None else []
    kernels.require_cuda("place_rows", valid, tstate.valid, free_order,
                         *srcs, *dsts, *extra)
    B, C = valid.shape[0], tstate.ts.shape[0]
    if len(srcs) > kernels.bind(_K13D, "k13d_max_cols", [])():
        raise ValueError("place_rows: too many table columns for one launch")
    if any(s.shape != (B,) for s in srcs) or free_order.shape != (C,):
        raise ValueError("place_rows: batch columns [B], free_order [C]")
    dev = valid.device
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    ws = _k13d_workspace(B, C, dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    n = len(srcs)

    def ptrs(ts_):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts_])

    sizes = [d.element_size() for d in dsts]
    rc = kernels.bind(_K13D, "k13d_place_rows",
                      [P, P, I, P, I, P, P, P, P, I, P, P, P])(
        valid.data_ptr(), drop.data_ptr() if drop is not None else None, B,
        tstate.valid.data_ptr(), C, free_order.data_ptr(), ptrs(srcs),
        ptrs(dsts), (ctypes.c_int * n)(*sizes), n, counts.data_ptr(),
        ws.data_ptr(), kernels.stream())
    kernels.check(_K13D, "place_rows", rc, dev)
    kernels.LAUNCHES[counter] += 1
    return tstate, counts


def place_rows(tstate, cols, ts, valid, drop, free_order):
    if valid.is_cuda:
        return place_rows_cuda(tstate, cols, ts, valid, drop, free_order)
    return place_rows_plain(tstate, cols, ts, valid, drop, free_order)


def table_insert(tstate: TableState, batch: EventBatch,
                 primary_keys: Sequence[str]):
    """`_make_insert`: (new state, int32[2] overflow and dropped)."""
    drop = None
    if primary_keys:
        drop = pk_duplicates([batch.cols[k] for k in primary_keys],
                             [tstate.cols[k] for k in primary_keys],
                             batch.valid, tstate.valid)
    free_order = stable_partition_order(~tstate.valid,
                                        counter="K1 table free")
    return place_rows(tstate, batch.cols, batch.ts, batch.valid, drop,
                      free_order)


# --------------------------------------------------------------------------- #
# K13e: per-row any, last matching event, per-event any
# --------------------------------------------------------------------------- #


def last_match_plain(mask: torch.Tensor):
    """Plain K13e, the JAX reductions of the [B, C] mask: (has bool[C],
    b_star int32[C], ev_matched bool[B])."""
    B = mask.shape[0]
    has = mask.any(dim=0)
    b_star = (B - 1) - torch.argmax(mask.flip(0).to(torch.uint8), dim=0)
    return has, b_star.to(torch.int32), mask.any(dim=1)


def _shape(cond, lane_valid, row_valid) -> tuple:
    B = lane_valid.shape[0] if lane_valid is not None else cond.shape[0]
    C = row_valid.shape[0] if row_valid is not None else cond.shape[-1]
    return B, C


def last_match_mask_plain(cond, lane_valid: Optional[torch.Tensor] = None,
                          row_valid: Optional[torch.Tensor] = None):
    """Plain K13e mask route: the [B, C] mask cond & lane_valid[:, None] &
    row_valid[None, :] built and reduced by last_match_plain. The CPU path
    and the kernel's oracle."""
    B, C = _shape(cond, lane_valid, row_valid)
    dev = next(v.device for v in (lane_valid, row_valid, cond)
               if isinstance(v, torch.Tensor))
    mask = broadcast_to(cond, (B, C), dev)
    if lane_valid is not None:
        mask = mask & lane_valid[:, None]
    if row_valid is not None:
        mask = mask & row_valid[None, :]
    return last_match_plain(mask)


_K13E = "k13e_last_match"


@functools.lru_cache(maxsize=256)
def _k13e_workspace_bytes(B: int, C: int) -> int:
    nbytes = kernels.bind(_K13E, "k13e_workspace_bytes",
                          [ctypes.c_int, ctypes.c_int],
                          restype=ctypes.c_longlong)(B, C)
    if nbytes <= 0:
        raise kernels.KernelError("K13e: the card has no cooperative "
                                  "launches")
    return nbytes


def _k13e_workspace(B: int, C: int, device, stream: int) -> torch.Tensor:
    """The library's workspace for B lanes against C rows (the dense
    route's folds, or the equality route's hash of the lanes' keys), zero
    between launches."""
    return kernels.workspace(_K13E, _k13e_workspace_bytes(B, C), device,
                             stream)


def _k13e_outputs(B: int, C: int, dev):
    return (torch.empty(C, dtype=torch.bool, device=dev),
            torch.empty(C, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev))


def _k13e_empty(B: int, C: int, dev):
    """The reductions of a [B, 0] mask (no launch)."""
    has, b_star, _ = _k13e_outputs(B, C, dev)
    return has, b_star, torch.zeros(B, dtype=torch.bool, device=dev)


def last_match_cuda(cond, lane_valid: Optional[torch.Tensor] = None,
                    row_valid: Optional[torch.Tensor] = None, *,
                    counter: str = "K13e"):
    """K13e's mask route on the card: one launch over the condition as
    evaluated (a [B, C], [B, 1] or [C] bool tensor, or a 0-d one, on the
    host for a constant), read through its strides, with the two valid
    vectors folded in; the [B, C] mask is never built."""
    if not isinstance(cond, torch.Tensor):
        cond = torch.tensor(bool(cond))
    if cond.dtype != torch.bool or cond.dim() > 2:
        raise ValueError("last_match: the condition must be bool, at most "
                         "[B, C]")
    B, C = _shape(cond, lane_valid, row_valid)
    valids = [v for v in (lane_valid, row_valid) if v is not None]
    dev = (valids[0] if valids else cond).device
    if dev.type != "cuda":
        raise ValueError(f"last_match: a CUDA tensor expected, got {dev}")
    if valids:
        kernels.require_cuda("last_match", *valids)
    if B < 1:
        raise ValueError("last_match: at least one lane")
    if C == 0:
        return _k13e_empty(B, C, dev)
    cval = 0
    if cond.dim() == 0 and not cond.is_cuda:
        cval, ptr, sb, sc = int(cond.item()), None, 0, 0  # no device read
    else:
        if cond.device != dev:
            raise ValueError("last_match: the condition is on another "
                             "device")
        view = torch.broadcast_to(cond, (B, C))
        ptr, (sb, sc) = view.data_ptr(), view.stride()
    has, b_star, ev = _k13e_outputs(B, C, dev)
    stream = kernels.stream()
    ws = _k13e_workspace(B, C, dev, stream)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    rc = kernels.bind(_K13E, "k13e_last_match",
                      [P, L, L, I, P, P, I, I, P, P, P, P, P])(
        ptr, sb, sc, cval,
        lane_valid.data_ptr() if lane_valid is not None else None,
        row_valid.data_ptr() if row_valid is not None else None, B, C,
        ws.data_ptr(), has.data_ptr(), b_star.data_ptr(), ev.data_ptr(),
        stream)
    kernels.check(_K13E, "last_match", rc, dev)
    kernels.LAUNCHES[counter] += 1
    return has, b_star, ev


def last_match(cond, lane_valid: Optional[torch.Tensor] = None,
               row_valid: Optional[torch.Tensor] = None, *,
               counter: str = "K13e"):
    """K13e's (has, b_star, ev_matched) of the mask cond & lane_valid[:,
    None] & row_valid[None, :], where `cond` broadcasts to [B, C] (B, C
    from the valid vectors where given, else from cond)."""
    dev = next((v.device for v in (lane_valid, row_valid, cond)
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    if dev.type == "cuda":
        return last_match_cuda(cond, lane_valid, row_valid, counter=counter)
    return last_match_mask_plain(cond, lane_valid, row_valid)


def last_match_eq_plain(lane_keys: Sequence[torch.Tensor],
                        row_keys: Sequence[torch.Tensor],
                        lane_valid: torch.Tensor, row_valid: torch.Tensor):
    """Plain K13e equality route: the [B, C] mask AND_k lane_keys[k][:,
    None] == row_keys[k][None, :] & lane_valid[:, None] & row_valid[None,
    :] through last_match_plain. The CPU path and the kernel's oracle."""
    eq = lane_valid[:, None] & row_valid[None, :]
    for a, r in zip(lane_keys, row_keys):
        eq = eq & (a[:, None] == r[None, :])
    return last_match_plain(eq)


def last_match_eq_cuda(lane_keys, row_keys, lane_valid, row_valid, *,
                       counter: str = "K13e eq"):
    """K13e's equality route on the card: one launch that hashes the valid
    lanes' keys into the workspace (a slot keeps its class's last lane),
    probes it with every live row and reads the rows' marks back for the
    lanes; no [B, C] tensor."""
    if not 1 <= len(lane_keys) == len(row_keys) <= 4:
        raise ValueError("last_match_eq: 1 to 4 key columns")
    lanes, rows, types = [], [], []
    for a, r in zip(lane_keys, row_keys):
        dt = torch.promote_types(a.dtype, r.dtype)  # as `==` compares
        if dt not in _KEY_TYPE:
            raise ValueError(f"last_match_eq: key dtype {dt}")
        lanes.append(a.to(dt).contiguous())
        rows.append(r.to(dt).contiguous())
        types.append(_KEY_TYPE[dt])
    kernels.require_cuda("last_match_eq", lane_valid, row_valid, *lanes,
                         *rows)
    B, C = lane_valid.shape[0], row_valid.shape[0]
    dev = row_valid.device
    if any(t.shape != (B,) for t in lanes) or any(
            t.shape != (C,) for t in rows):
        raise ValueError("last_match_eq: lane keys [B], row keys [C]")
    if B < 1:
        raise ValueError("last_match_eq: at least one lane")
    if C == 0:
        return _k13e_empty(B, C, dev)
    has, b_star, ev = _k13e_outputs(B, C, dev)
    stream = kernels.stream()
    ws = _k13e_workspace(B, C, dev, stream)
    P, I = ctypes.c_void_p, ctypes.c_int
    n = len(lanes)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    rc = kernels.bind(_K13E, "k13e_last_match_eq",
                      [P, P, P, I, P, P, I, I, P, P, P, P, P])(
        ptrs(lanes), ptrs(rows), (ctypes.c_int * n)(*types), n,
        lane_valid.data_ptr(), row_valid.data_ptr(), B, C, ws.data_ptr(),
        has.data_ptr(), b_star.data_ptr(), ev.data_ptr(), stream)
    kernels.check(_K13E, "last_match_eq", rc, dev)
    kernels.LAUNCHES[counter] += 1
    return has, b_star, ev


def last_match_eq(lane_keys, row_keys, lane_valid, row_valid, *,
                  counter: str = "K13e eq"):
    if row_valid.is_cuda:
        return last_match_eq_cuda(lane_keys, row_keys, lane_valid,
                                  row_valid, counter=counter)
    return last_match_eq_plain(lane_keys, row_keys, lane_valid, row_valid)


def sorted_index(keys: torch.Tensor) -> torch.Tensor:
    """`jnp.sort(keys)` through K7's stable argsort: int32 keys as signed
    int32 (4 passes), other integers as int64, floats through
    `float64_sort_key` (NaN last, -0.0 equal to 0.0)."""
    if keys.dtype.is_floating_point:
        k = float64_sort_key(keys)
    elif keys.dtype == torch.int32:
        k = keys
    else:
        k = keys.to(torch.int64)
    order = stable_radix_argsort(k, counter="K7 table index")
    return keys[order.long()]


# --------------------------------------------------------------------------- #
# the table
# --------------------------------------------------------------------------- #


class InMemoryTable:
    """Host handle owning the device TableState."""

    def __init__(self, definition: TableDefinition, ctx: SiddhiAppContext,
                 capacity: Optional[int] = None) -> None:
        self.definition = definition
        self.ctx = ctx
        self.codec = StreamCodec(definition, ctx.global_strings)
        cap_ann = (definition.annotation("capacity")
                   if definition.annotations else None)
        self.capacity = capacity or (
            int(cap_ann.element(None))
            if cap_ann is not None and cap_ann.element(None)
            else dtypes.config.default_table_capacity)
        self.attr_types = {a.name: a.type for a in definition.attributes
                           if a.type != AttributeType.OBJECT}
        dev = ctx.device
        C = self.capacity
        self._state = TableState(
            cols={n: torch.zeros(C, dtype=dtypes.device_dtype(t), device=dev)
                  for n, t in self.attr_types.items()},
            ts=torch.zeros(C, dtype=dtypes.TS_DTYPE, device=dev),
            valid=torch.zeros(C, dtype=torch.bool, device=dev))
        pk = (definition.annotation("PrimaryKey")
              if definition.annotations else None)
        self.primary_keys: tuple[str, ...] = tuple(
            e.value for e in pk.elements) if pk is not None else ()
        # @Index: a sorted copy of each indexed column (invalid rows at the
        # dtype's max), rebuilt lazily after any mutation
        idx_ann = (definition.annotation("Index")
                   if definition.annotations else None)
        self.index_attrs: tuple[str, ...] = tuple(
            e.value for e in idx_ann.elements) if idx_ann is not None else ()
        for a in self.index_attrs:
            if a not in self.attr_types:
                raise SiddhiAppCreationError(
                    f"@Index({a!r}): no such attribute on {definition.id!r}")
            if self.attr_types[a] == AttributeType.BOOL:
                raise SiddhiAppCreationError(
                    f"@Index({a!r}): bool attributes are not indexable")
        self._indexes = None  # attr -> (sorted values [C], n_live)
        self.dropped_duplicates = 0
        #: attributes carrying a forwarded unionSet set-size projection
        self.set_projection_attrs: set = set()

    # ------------------------------------------------------------------ state

    @property
    def state(self) -> TableState:
        return self._state

    @state.setter
    def state(self, new_state: TableState) -> None:
        self._state = new_state
        self._indexes = None  # any mutation invalidates the sorted copies

    def clear(self) -> None:
        """Empty the table, keeping its capacity."""
        st = self._state
        self.state = TableState(
            cols={k: torch.zeros_like(v) for k, v in st.cols.items()},
            ts=torch.zeros_like(st.ts), valid=torch.zeros_like(st.valid))

    def probe_indexes(self) -> dict:
        """The sorted-copy indexes for equality probes (K7, one sort per
        indexed column), rebuilt after a mutation."""
        attrs = tuple(sorted(self.indexable_eq_attrs()))
        if not attrs:
            return {}
        if self._indexes is None:
            st = self._state
            n_live = st.valid.sum(dtype=torch.int32)
            out = {}
            for a in attrs:
                col = st.cols[a]
                big = (float("inf") if col.dtype.is_floating_point
                       else torch.iinfo(col.dtype).max)
                out[a] = (sorted_index(torch.where(st.valid, col, big)),
                          n_live)
            self._indexes = out
        return self._indexes

    # ------------------------------------------------------------------ insert

    def insert_batch(self, batch: EventBatch) -> None:
        new_state, counts = table_insert(self._state, batch,
                                         self.primary_keys)
        overflow, dropped = counts.tolist()  # the write's one host read
        if overflow:
            raise CapacityExceededError(
                f"table {self.definition.id} capacity {self.capacity} "
                f"exceeded ({overflow} rows would be dropped)")
        self.state = new_state
        self.dropped_duplicates += dropped

    def insert_rows(self, rows, timestamp: int = 0) -> None:
        cols = self.codec.rows_to_columns(rows, n_pad=len(rows))
        ts = np.full(len(rows), timestamp, dtype=np.int64)
        self.insert_batch(EventBatch.from_numpy(ts, cols, len(rows),
                                                self.ctx.device))

    # ------------------------------------------------------------------ reads

    def contains_probe(self, scope: Scope, inner, eq_plan=None):
        """`expr in T`: the per-lane any-match over live rows. Reads the
        table state from scope.extras, so each step sees fresh contents. A
        single equality on an indexed attribute searches the sorted index
        instead of building the [B, C] mask."""
        tid = self.definition.id
        if eq_plan is not None:
            attr, sexpr = eq_plan
            idx = scope.extras.get(f"tableidx:{tid}")
            if idx and attr in idx:
                sorted_vals, n_live = idx[attr]
                C = sorted_vals.shape[0]
                v = sexpr(scope)
                if not isinstance(v, torch.Tensor) or v.device != \
                        sorted_vals.device:
                    v = broadcast_to(v, (), sorted_vals.device)
                v = v.to(sorted_vals.dtype).contiguous()
                pos = searchsorted32(sorted_vals, v, side="left")
                return (pos < n_live) & (
                    sorted_vals[torch.clamp(pos, 0, C - 1).long()] == v)
        tstate: TableState = scope.extras.get(f"table:{tid}", self.state)
        s2 = _broadcast_scope(scope, tid, tstate)
        if inner is None:
            raise SiddhiAppCreationError("`in Table` requires a condition")
        cond = inner(s2)
        if cond.dim() == 2:  # read where it lies, with the rows' valid
            return last_match(cond, row_valid=tstate.valid)[2]
        return (cond & tstate.valid).any(dim=-1)

    def indexable_eq_attrs(self) -> set:
        """Attributes whose equality probes can use a sorted index."""
        out = set(self.index_attrs)
        if len(self.primary_keys) == 1:
            out.add(self.primary_keys[0])
        return out

    def all_rows(self) -> list[tuple]:
        st = self.state
        batch = EventBatch(ts=st.ts, cols=st.cols, valid=st.valid,
                           types=torch.zeros(self.capacity, dtype=torch.int8,
                                             device=st.ts.device))
        return [e.data for e in batch.to_host_events(self.codec)]

    def __len__(self) -> int:
        return int(self.state.valid.sum())


def _key_column(ce, scope: Scope, n: int, dev) -> torch.Tensor:
    """A side of an equality key evaluated on `scope`'s [n] frame, in its
    type's device dtype (the compiled `==` of one type casts so)."""
    return broadcast_to(ce(scope), (n,), dev).to(dtypes.device_dtype(ce.type))


class TableOutputExecutor:
    """One query output targeting a table: `delete`, `update` or `update
    or insert into T ... on <cond>`, applied per output batch."""

    def __init__(self, table: InMemoryTable, output_stream: OutputStream,
                 out_types: dict, out_codec: StreamCodec, registry,
                 out_frame_aliases: Sequence[str] = ()) -> None:
        self.table = table
        self.action = output_stream.action
        tid = table.definition.id
        # the ON condition may name the output attributes through the
        # query's input-stream name or alias
        frames = {"__out__": dict(out_types), tid: dict(table.attr_types)}
        codecs = {"__out__": out_codec, tid: table.codec}
        for alias in out_frame_aliases:
            if alias and alias not in frames:
                frames[alias] = dict(out_types)
                codecs[alias] = out_codec
        self.out_frame_aliases = tuple(
            a for a in out_frame_aliases if a and a != tid)
        resolver = TypeResolver(frames, "__out__", codecs)

        cond = output_stream.on_condition
        if cond is None:
            raise SiddhiAppCreationError(
                f"{self.action.name} into table requires an ON condition")
        self.cond = compile_expression(cond, resolver, registry)
        if self.cond.type != AttributeType.BOOL:
            raise SiddhiAppCreationError("table ON condition must be boolean")
        # a conjunction of `==` compares between table and output sides:
        # K13e's equality route, whose keys hash on the card (no [B, C]
        # mask)
        self.eq_plan = equality_key_plan(
            cond, tid, ("__out__",) + self.out_frame_aliases, resolver,
            registry)

        # SET clause; by default every table attribute from the output
        # attribute of the same name
        sets: list = []
        if output_stream.set_attributes:
            for sa in output_stream.set_attributes:
                if sa.table_variable.stream_id not in (None, tid):
                    raise SiddhiAppCreationError(
                        f"SET target must be a {tid} attribute")
                sets.append((sa.table_variable.attribute,
                             compile_expression(sa.expression, resolver,
                                                registry)))
        else:
            for name in table.attr_types:
                if name in out_types:
                    sets.append((name, compile_expression(
                        Variable(name, stream_id="__out__"), resolver,
                        registry)))
        self.sets = sets

    def _scope(self, cols: dict, ts, valid) -> Scope:
        scope = Scope()
        scope.add_frame("__out__", cols, ts, valid, default=True)
        for alias in self.out_frame_aliases:
            scope.add_frame(alias, cols, ts, valid)
        return scope

    def run(self, tstate: TableState, out: EventBatch):
        """(new table state, the events to insert or None)."""
        tid = self.table.definition.id
        B, C = out.ts.shape[0], tstate.ts.shape[0]
        dev = tstate.ts.device
        out_scope = self._scope(out.cols, out.ts, out.valid)
        if self.eq_plan is not None:
            # each side as the compiled `==` evaluates it: the output sides
            # on the [B] frame, the table sides on the [C] frame
            t_scope = Scope()
            t_scope.add_frame(tid, tstate.cols, tstate.ts, tstate.valid)
            has, b_star, ev_matched = last_match_eq(
                [_key_column(o, out_scope, B, dev) for _, o in self.eq_plan],
                [_key_column(t, t_scope, C, dev) for t, _ in self.eq_plan],
                out.valid, tstate.valid)
        else:
            s2 = _broadcast_scope(out_scope, tid, tstate)
            has, b_star, ev_matched = last_match(self.cond(s2), out.valid,
                                                 tstate.valid)
        if self.action == OutputAction.DELETE:
            return TableState(tstate.cols, tstate.ts,
                              tstate.valid & ~has), None
        # update: the last matching event per row; each SET is elementwise,
        # so its value on the gathered [C] frame is the [B, C] value at
        # (b_star, row)
        g = b_star.long()
        scope = self._scope({k: v[g] for k, v in out.cols.items()},
                            out.ts[g], out.valid[g])
        scope.add_frame(tid, tstate.cols, tstate.ts, tstate.valid)
        new_cols = dict(tstate.cols)
        for name, ce in self.sets:
            old = tstate.cols[name]
            vals = broadcast_to(ce(scope), (C,), dev).to(old.dtype)
            new_cols[name] = torch.where(has, vals, old)
        updated = TableState(new_cols, tstate.ts, tstate.valid)
        if self.action == OutputAction.UPDATE:
            return updated, None
        # update or insert: the events that matched no row are inserted
        return updated, dataclasses.replace(out,
                                            valid=out.valid & ~ev_matched)

    def apply(self, out: EventBatch) -> None:
        new_state, to_insert = self.run(self.table.state, out)
        self.table.state = new_state
        if to_insert is not None:
            self.table.insert_batch(to_insert)


class TableJunctionAdapter:
    """The query-output junction interface onto a table insert."""

    #: a query publishes into the table whether or not anyone reads it
    receivers = (True,)

    def __init__(self, table: InMemoryTable) -> None:
        self.table = table

    def publish_batch(self, batch: EventBatch, now: int) -> None:
        self.table.insert_batch(batch)
