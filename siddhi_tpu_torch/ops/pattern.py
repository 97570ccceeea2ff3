"""Device primitives of the pattern / sequence step (counterpart of the
[B, P] reductions and pending-table scatters inside
siddhi_tpu/core/pattern_runtime.py).

A pattern position keeps a fixed-capacity pending table of partial
matches (`PendingTable`, P slots). A micro-batch of B arrivals meets it
in five primitives:

- `first_match` (K11a): for each pending entry, the first arrival that
  qualifies — the leg condition, `arr_seq > last_seq` (pattern) or
  `arr_seq == last_seq + 1` (sequence, with the strict kill), and
  `ts - start_ts <= within` — as the JAX step's `argmin` over a [B, P]
  `where(q, arr_seq, BIGSEQ)` (`pattern_runtime.py:1197-1226`). The leg
  condition comes split: equalities between an arrival column and a
  captured column of the same integral, string-code or bool type are
  evaluated in the kernel; conjuncts over the arrival alone arrive as a
  lane mask; the rest as a [B, T] mask tile per range of T entries. On
  the card, pattern mode probes an index of the batch per entry.
- `pending_insert` (K11b): candidate entries into the free slots of a
  table (`_insert_entries`, `pattern_runtime.py:1460`): the k-th valid
  candidate takes the k-th free slot in ascending slot order; candidates
  past the free slots are dropped and counted.
- `absent_scan` (K11c): for each entry, the arrivals of an absent leg
  (`not X for t`, `not X and Y`) that reach it: the first one's seq, and
  whether one lands before and one at or after the entry's deadline
  (`pattern_runtime.py:871-882, 937-941, 1088-1094`).
- `match_count` (K11d): the number of qualifying (lane, entry) pairs,
  on the device: the matches a mid-pattern `every` or an every-group
  leaves past its pass bound (`:1318-1331, 1368-1380`).
- `release_origin` (K11e): a mid-pattern every-group's completions clear
  their origin entries' busy latch and scatter-max their seq into them
  (`_advance` `:1440-1446`).

On the card K11a's pattern mode, K11c and K11d probe one index of the
batch (`match_index`: K7 an equality column, K1, a gather), which depends
on the batch side alone: each call builds its own, or a pattern step
builds it once a leg and hands it to every call on that leg (`index=`).

Each has a `_plain` and a `_cuda` version behind one name: a CUDA tensor
launches csrc/k11_pattern.cu (K11a, K11b) or csrc/k11c_absent.cu (K11c,
K11d, K11e), a CPU tensor runs the plain version. The CUDA insert and
release update the table in place (the counterpart of JAX's buffer
donation); the plain ones return new tensors.

The plain reductions over [B, P] materialise their mask one range of
`match_tile(B)` entries at a time (at most 2^25 lane-entry pairs a tile:
1024 entries at B = 32768, where one int64 temporary is 256 MiB), so
their memory stays bounded at BASELINE config 4's width (B = 32768, P =
131072, for which a whole int64 [B, P] would be 34 GB). The kernels read
a residual mask in tiles of the same size.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from .. import kernels
from .search import (stable_partition_order, stable_partition_order_plain,
                     stable_radix_argsort)

#: arrival sequence of an invalid lane (never the first match)
BIGSEQ = 2**62

#: lane-entry pairs per mask tile (see the module docstring)
TILE_PAIRS = 1 << 25

#: equalities the kernel evaluates itself; further ones become residual
MAX_EQ = 4


def match_tile(B: int) -> int:
    """Entries per mask tile for a batch of B lanes."""
    return max(1, TILE_PAIRS // max(B, 1))


class PendingTable(NamedTuple):
    """One pattern position's waiting partial matches, P slots."""

    frames: dict  # {ref: {attr: [P]}} captured columns of earlier positions
    frame_valid: dict  # {ref: bool[P]} (leg / skipped frames may be missing)
    frame_ts: dict  # {ref: int64[P]}
    start_ts: torch.Tensor  # int64[P] first captured event ts (within)
    last_seq: torch.Tensor  # int64[P] arrival seq of the latest capture
    armed_ts: torch.Tensor  # int64[P] when the entry reached this position
    valid: torch.Tensor  # bool[P]
    leg_done: torch.Tensor  # bool[P, 2] logical positions: legs captured
    origin: torch.Tensor  # int32[P] mid-every-group origin slot, -1 here


# --------------------------------------------------------------------------- #
# K11a: first_match
# --------------------------------------------------------------------------- #


Residual = Optional[Callable[[int, int], torch.Tensor]]


def _qualify_tile(arr_seq, lane_ok, eq_pairs, pend_valid, last_seq,
                  residual, p0, p1, start_ts=None, ts=None, within=None,
                  sequence=False):
    """bool[B, p1 - p0]: the qualifying (lane, entry) pairs of one tile of
    entries: the lane mask, the entry mask, every equality, the residual,
    arr_seq > last_seq (sequence: arr_seq == last_seq + 1) and (where
    given) ts - start_ts <= within."""
    q = lane_ok[:, None] & pend_valid[None, p0:p1]
    for arr, ent in eq_pairs:
        q = q & (arr[:, None] == ent[None, p0:p1])
    if residual is not None:
        q = q & residual(p0, p1)
    if sequence:
        q = q & (arr_seq[:, None] == last_seq[None, p0:p1] + 1)
    else:
        q = q & (arr_seq[:, None] > last_seq[None, p0:p1])
    if within is not None:
        q = q & (ts[:, None] - start_ts[None, p0:p1] <= within)
    return q


def first_match_plain(arr_seq: torch.Tensor, ts: torch.Tensor,
                      valid: torch.Tensor, lane_ok: torch.Tensor,
                      eq_pairs: Sequence, pend_valid: torch.Tensor,
                      last_seq: torch.Tensor, start_ts: torch.Tensor,
                      within: Optional[int], sequence: bool,
                      seq0: Optional[torch.Tensor] = None,
                      residual: Residual = None,
                      tile: Optional[int] = None):
    """Plain K11a: the JAX step's mask, one tile of entries at a time.
    `seq0` is unused here (the kernel locates the next lane with it)."""
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    dev = arr_seq.device
    T = tile or match_tile(B)
    b_star = torch.zeros(P, dtype=torch.int64, device=dev)
    matched = torch.zeros(P, dtype=torch.bool, device=dev)
    killed = torch.zeros(P, dtype=torch.bool, device=dev)
    for p0 in range(0, P, T):
        p1 = min(P, p0 + T)
        q = _qualify_tile(arr_seq, lane_ok, eq_pairs, pend_valid, last_seq,
                          residual, p0, p1, start_ts, ts, within, sequence)
        if sequence:
            # strict contiguity: the next valid arrival failing the
            # condition kills the entry (pattern_runtime.py:1214-1221)
            nxt_seq = arr_seq[:, None] == last_seq[None, p0:p1] + 1
            kill = ((nxt_seq & valid[:, None] & ~q).any(0)
                    & pend_valid[p0:p1])
            q = q & ~kill[None, :]
            killed[p0:p1] = kill
        qseq = torch.where(q, arr_seq[:, None], BIGSEQ)
        # torch.argmin returns the first minimal index, as jnp.argmin does:
        # 0 for an entry with no qualifying arrival (all BIGSEQ)
        b_star[p0:p1] = torch.argmin(qseq, dim=0)
        matched[p0:p1] = q.any(0)
    return b_star, matched, killed


_ESIZE = {torch.bool: 1, torch.int32: 4, torch.int64: 8}


def _eq_args(eq_pairs, B: int, P: int) -> tuple:
    """The equality columns as the C function takes them: host arrays of
    arrival pointers, captured pointers and element sizes, and the count."""
    if len(eq_pairs) > MAX_EQ:
        raise ValueError(f"first_match: at most {MAX_EQ} equalities")
    for arr, ent in eq_pairs:
        if (arr.dtype != ent.dtype or arr.dtype not in _ESIZE
                or arr.shape != (B,) or ent.shape != (P,)
                or not arr.is_contiguous() or not ent.is_contiguous()):
            raise ValueError("first_match: equality columns are contiguous "
                             "[B] and [P] of one bool/int32/int64 type")
    n = len(eq_pairs)
    Pt = ctypes.c_void_p
    return ((Pt * MAX_EQ)(*[a.data_ptr() for a, _ in eq_pairs]),
            (Pt * MAX_EQ)(*[e.data_ptr() for _, e in eq_pairs]),
            (ctypes.c_int * MAX_EQ)(*[_ESIZE[a.dtype] for a, _ in eq_pairs]),
            n)


def _residual_tiles(what, residual, B, P, tile, dev):
    """(p0, p1, contiguous bool [B, p1 - p0] mask or None) per launch."""
    T = max(P, 1) if residual is None else (tile or match_tile(B))
    for p0 in range(0, P, T):
        p1 = min(P, p0 + T)
        mask = None
        if residual is not None:
            mask = torch.broadcast_to(residual(p0, p1),
                                      (B, p1 - p0)).contiguous()
            if mask.dtype != torch.bool or mask.device != dev:
                raise ValueError(f"{what}: the residual mask is bool on the "
                                 "batch's device")
        yield p0, p1, mask


def _index_key(col: torch.Tensor):
    """(K7 key, bound) whose order is the column's value order: bool as 0/1
    under bound 1, int32 and int64 in signed order."""
    if col.dtype == torch.bool:
        return col.to(torch.int32), 1
    return col, None


def _index_bytes(B: int, n_eq: int) -> int:
    return kernels.bind("k11_pattern", "k11_index_bytes",
                        [ctypes.c_int, ctypes.c_int],
                        restype=ctypes.c_longlong)(B, n_eq)


def match_index(arr_seq: torch.Tensor, ts: torch.Tensor,
                lane_ok: torch.Tensor, arrivals: Sequence[torch.Tensor],
                counter: str = "K11a") -> Optional[torch.Tensor]:
    """The index of a batch that K11a's pattern mode, K11c and K11d probe
    (csrc/k11_index.cuh): its lanes by (lane_ok first, the equality
    arrival columns `arrivals`, lane), from one stable K7 sort a column,
    least significant first, and K1; then k11_match_index gathers the
    sorted columns into a buffer of this call's, from the stream-ordered
    caching allocator, so concurrent calls on one stream never share an
    index. It depends on the batch side alone, so a pattern step builds it
    once a leg and hands it to each call on that leg as `index=`. The
    gather counts under `counter`, the call that builds it. Sized from the
    shapes alone: no host sync. None for a batch on the CPU, where the
    plain versions take no index."""
    if not arr_seq.is_cuda:
        return None
    B = arr_seq.shape[0]
    arrivals = [a.contiguous() for a in arrivals]
    kernels.require_cuda("match_index", arr_seq, ts, lane_ok, *arrivals)
    if (len(arrivals) > MAX_EQ or arr_seq.dtype != torch.int64
            or ts.dtype != torch.int64 or lane_ok.dtype != torch.bool
            or ts.shape != (B,) or lane_ok.shape != (B,)
            or any(a.dtype not in _ESIZE or a.shape != (B,)
                   for a in arrivals)):
        raise ValueError(f"match_index: int64 arr_seq/ts, bool lane_ok and "
                         f"at most {MAX_EQ} bool/int32/int64 arrival "
                         "columns, all [B]")
    order = None
    for arr in reversed(arrivals):
        key, bound = _index_key(arr if order is None
                                else torch.index_select(arr, 0, order))
        perm = stable_radix_argsort(key, bound, counter="K7 pattern index")
        order = perm if order is None else torch.index_select(order, 0, perm)
    ok = lane_ok if order is None else torch.index_select(lane_ok, 0, order)
    perm = stable_partition_order(ok)  # K1: lane_ok lanes first
    order = perm if order is None else torch.index_select(order, 0, perm)
    n = len(arrivals)
    index = torch.empty(_index_bytes(B, n), dtype=torch.uint8,
                        device=arr_seq.device)
    Pt = ctypes.c_void_p
    fn = kernels.bind("k11_pattern", "k11_match_index",
                      [Pt] * 4 + [ctypes.c_int, Pt, Pt, ctypes.c_int, Pt,
                                  Pt])
    rc = fn(order.data_ptr(), arr_seq.data_ptr(), ts.data_ptr(),
            lane_ok.data_ptr(), B,
            (Pt * MAX_EQ)(*[a.data_ptr() for a in arrivals]),
            (ctypes.c_int * MAX_EQ)(*[_ESIZE[a.dtype] for a in arrivals]),
            n, index.data_ptr(), kernels.stream())
    kernels.check("k11_pattern", "match_index", rc)
    if B:
        kernels.LAUNCHES[counter] += 1
    return index


def _probe_index(what, index, arr_seq, ts, lane_ok, eq_pairs,
                 counter) -> torch.Tensor:
    """`index` (match_index's for this batch and these equalities' arrival
    columns), checked against the shapes, or one built for this call."""
    if index is None:
        return match_index(arr_seq, ts, lane_ok, [a for a, _ in eq_pairs],
                           counter)
    if (index.dtype != torch.uint8 or index.device != arr_seq.device
            or index.shape != (_index_bytes(arr_seq.shape[0],
                                            len(eq_pairs)),)):
        raise ValueError(f"{what}: `index` is match_index's buffer for "
                         "this batch and these equalities")
    return index


def first_match_cuda(arr_seq: torch.Tensor, ts: torch.Tensor,
                     valid: torch.Tensor, lane_ok: torch.Tensor,
                     eq_pairs: Sequence, pend_valid: torch.Tensor,
                     last_seq: torch.Tensor, start_ts: torch.Tensor,
                     within: Optional[int], sequence: bool,
                     seq0: Optional[torch.Tensor] = None,
                     residual: Residual = None,
                     tile: Optional[int] = None,
                     index: Optional[torch.Tensor] = None):
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    eq_pairs = [(a.contiguous(), e.contiguous()) for a, e in eq_pairs]
    kernels.require_cuda("first_match", arr_seq, ts, valid, lane_ok,
                         pend_valid, last_seq, start_ts,
                         *[t for pair in eq_pairs for t in pair])
    if (arr_seq.dtype != torch.int64 or ts.dtype != torch.int64
            or valid.dtype != torch.bool or lane_ok.dtype != torch.bool
            or pend_valid.dtype != torch.bool
            or last_seq.dtype != torch.int64
            or start_ts.dtype != torch.int64
            or ts.shape != (B,) or valid.shape != (B,)
            or lane_ok.shape != (B,) or last_seq.shape != (P,)
            or start_ts.shape != (P,)):
        raise ValueError("first_match: int64 arr_seq/ts and bool valid/"
                         "lane_ok [B]; bool pend_valid and int64 last_seq/"
                         "start_ts [P]")
    eq = _eq_args(eq_pairs, B, P)
    dev = arr_seq.device
    b_star = torch.empty(P, dtype=torch.int64, device=dev)
    matched = torch.empty(P, dtype=torch.bool, device=dev)
    killed = torch.empty(P, dtype=torch.bool, device=dev)
    if P == 0:
        return b_star, matched, killed
    order = None
    if sequence:
        if seq0 is None or seq0.dtype != torch.int64 or seq0.numel() != 1:
            raise ValueError("first_match: sequence mode needs seq0, the "
                             "int64 arrival seq of the batch's first lane")
        kernels.require_cuda("first_match", seq0)
        order = stable_partition_order(valid)  # K1: valid lanes first
    else:  # built once a call, probed by every residual tile's launch
        index = _probe_index("first_match", index, arr_seq, ts, lane_ok,
                             eq_pairs, "K11a")
    Pt = ctypes.c_void_p
    fn = kernels.bind("k11_pattern", "k11_first_match",
                      [Pt] * 6 + [ctypes.c_int, Pt, Pt, Pt, ctypes.c_int]
                      + [Pt] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                      + [Pt] * 5)
    for p0, p1, mask in _residual_tiles("first_match", residual, B, P, tile,
                                        dev):
        rc = fn(ts.data_ptr(), valid.data_ptr(), lane_ok.data_ptr(),
                order.data_ptr() if order is not None else None,
                seq0.data_ptr() if sequence else None,
                index.data_ptr() if index is not None else None, B, *eq,
                pend_valid.data_ptr(), last_seq.data_ptr(),
                start_ts.data_ptr(), p0, p1 - p0, int(sequence),
                int(within is not None),
                int(within) if within is not None else 0,
                mask.data_ptr() if mask is not None else None,
                b_star.data_ptr(), matched.data_ptr(), killed.data_ptr(),
                kernels.stream())
        kernels.check("k11_pattern", "first_match", rc)
        kernels.LAUNCHES["K11a"] += 1
    return b_star, matched, killed


def first_match(arr_seq: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor,
                lane_ok: torch.Tensor, eq_pairs: Sequence,
                pend_valid: torch.Tensor, last_seq: torch.Tensor,
                start_ts: torch.Tensor, within: Optional[int],
                sequence: bool, seq0: Optional[torch.Tensor] = None,
                residual: Residual = None, tile: Optional[int] = None,
                index: Optional[torch.Tensor] = None):
    """The first qualifying arrival of every pending entry (K11a).

    Batch side, [B]: `arr_seq` int64 (seq0 + rank on valid lanes, BIGSEQ
    on the others), `ts` int64, `valid` bool (the batch's lanes),
    `lane_ok` bool (valid and the conjuncts over the arrival alone).
    Entry side, [P]: `pend_valid` bool, `last_seq` int64 (the seq the
    arrival must pass: the entry's, or the position's snapshot for a
    logical leg), `start_ts` int64. `eq_pairs`: (arrival column [B],
    captured column [P]) of one bool/int32/int64 type, equal for a
    qualifying pair. `residual(p0, p1)`: the other conjuncts as a bool
    mask broadcastable to [B, p1 - p0], or None. `within`: ms or None.
    `sequence`: strict contiguity — only the arrival with seq last_seq + 1
    can qualify, and if it is valid and fails, the entry is killed; the
    kernel finds it through K1's valid-lane order and `seq0` (int64 0-d).

    `index`: `match_index`'s index of this batch side for pattern mode
    (default: one built for this call); sequence mode and the plain
    version take none.

    Returns b_star int64[P] (0 where nothing qualifies, as `argmin` over
    an all-BIGSEQ column gives), matched bool[P], killed bool[P] (valid
    entries killed by a strict sequence; all False for patterns)."""
    if arr_seq.is_cuda:
        return first_match_cuda(arr_seq, ts, valid, lane_ok, eq_pairs,
                                pend_valid, last_seq, start_ts, within,
                                sequence, seq0, residual, tile, index)
    return first_match_plain(arr_seq, ts, valid, lane_ok, eq_pairs,
                             pend_valid, last_seq, start_ts, within,
                             sequence, seq0, residual, tile)


# --------------------------------------------------------------------------- #
# K11b: pending_insert
# --------------------------------------------------------------------------- #


def _candidate_columns(dst: PendingTable, frames: dict, fvalid: dict,
                       fts: dict, start_ts, last_seq, armed_ts, valid,
                       origin):
    """(destination tensor, candidate source or None, fill) for every
    column an insert writes, in `_insert_entries`' order: a missing
    frame-validity source takes the candidate's `valid` (True wherever a
    candidate fits), a missing frame timestamp 0, a missing origin -1."""
    cols = []
    for ref in dst.frames:
        src_cols = frames.get(ref)
        if src_cols is None:
            continue
        for n, d in dst.frames[ref].items():
            cols.append((d, src_cols[n], 0))
        cols.append((dst.frame_valid[ref], fvalid.get(ref), 1))
        cols.append((dst.frame_ts[ref], fts.get(ref), 0))
    cols += [(dst.start_ts, start_ts, 0), (dst.last_seq, last_seq, 0),
             (dst.armed_ts, armed_ts, 0), (dst.leg_done, None, 0),
             (dst.origin, origin, -1), (dst.valid, None, 1)]
    return cols


def pending_insert_plain(dst: PendingTable, frames: dict, fvalid: dict,
                         fts: dict, start_ts: torch.Tensor,
                         last_seq: torch.Tensor, armed_ts: torch.Tensor,
                         valid: torch.Tensor,
                         origin: Optional[torch.Tensor] = None):
    """Plain K11b, the JAX function's scatters with drop semantics: lanes
    that do not fit aim at slot P of a table one row longer, which is cut
    off. Returns (a new PendingTable, n_drop int64 0-d)."""
    P = dst.valid.shape[0]
    free = ~dst.valid
    free_order = stable_partition_order_plain(free)
    n_free = free.sum(dtype=torch.int32)
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    fits = valid & (rank < n_free)
    n_drop = (valid & ~fits).sum(dtype=torch.int64)
    slot = torch.where(fits, free_order[torch.clamp(rank, 0, P - 1).long()]
                       .long(), P)

    def put(arr, src, fill):
        ext = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
        if src is None:
            ext[slot] = torch.tensor(fill, dtype=arr.dtype,
                                     device=arr.device)
        else:
            ext[slot] = src.to(arr.dtype)
        return ext[:P]

    out = {id(d): put(d, s, f) for d, s, f in _candidate_columns(
        dst, frames, fvalid, fts, start_ts, last_seq, armed_ts, valid,
        origin)}

    def new(t):
        return out.get(id(t), t)

    return PendingTable(
        frames={r: {n: new(c) for n, c in cs.items()}
                for r, cs in dst.frames.items()},
        frame_valid={r: new(v) for r, v in dst.frame_valid.items()},
        frame_ts={r: new(v) for r, v in dst.frame_ts.items()},
        start_ts=new(dst.start_ts), last_seq=new(dst.last_seq),
        armed_ts=new(dst.armed_ts), valid=new(dst.valid),
        leg_done=new(dst.leg_done), origin=new(dst.origin)), n_drop


_K11 = "k11_pattern"
_MAX_JOBS = 32  # column jobs of the cooperative launch (and of each more)
#: the destination half of the job arrays, built once a table: (its
#: columns' pointers, the jobs' (fill, bytes an element)) -> the ctypes
#: arrays of pointers, fills and sizes
_insert_plans: dict = {}
_MAX_PLANS = 64


def pending_insert_cuda(dst: PendingTable, frames: dict, fvalid: dict,
                        fts: dict, start_ts: torch.Tensor,
                        last_seq: torch.Tensor, armed_ts: torch.Tensor,
                        valid: torch.Tensor,
                        origin: Optional[torch.Tensor] = None):
    """K11b on the card: one cooperative launch ranks the candidates and
    the free slots and writes up to 32 column jobs (n_drop stays on the
    device); a table of more jobs adds one plain launch a further 32.
    Updates `dst` in place."""
    P = dst.valid.shape[0]
    W = valid.shape[0]
    valid = valid.contiguous()
    if (not valid.is_cuda or valid.dtype != torch.bool
            or dst.valid.dtype != torch.bool):
        raise ValueError("pending_insert: bool valid on a CUDA device")
    card = valid.get_device()
    dptr, sptr, meta = [], [], []
    for d, s, fill in _candidate_columns(dst, frames, fvalid, fts, start_ts,
                                         last_seq, armed_ts, valid, origin):
        if (d.shape[0] != P or not d.is_contiguous()
                or d.get_device() != card):
            raise ValueError("pending_insert: table columns are contiguous "
                             "[P] (leg_done [P, 2]) on the candidates' "
                             "device")
        dptr.append(d.data_ptr())
        if s is None:
            sptr.append(None)
        else:
            s = s.contiguous()
            if (s.dtype != d.dtype or s.shape != (W,)
                    or s.get_device() != card):
                raise ValueError("pending_insert: a candidate column is "
                                 "[W] of its table column's type and "
                                 "device")
            sptr.append(s.data_ptr())
        meta.append((fill, d.element_size() * (d.shape[1] if d.dim() == 2
                                               else 1)))
    dev = valid.device
    if W == 0:
        return dst, torch.zeros((), dtype=torch.int64, device=dev)
    Pt = ctypes.c_void_p
    nbytes = kernels.bind(_K11, "k11_insert_workspace_bytes",
                          [ctypes.c_int] * 2, restype=ctypes.c_longlong)
    fn = kernels.bind(_K11, "k11_pending_insert",
                      [Pt, ctypes.c_int, Pt, ctypes.c_int] + [Pt] * 4
                      + [ctypes.c_int] + [Pt] * 4)
    n = len(meta)
    key = (tuple(dptr), tuple(meta))
    plan = _insert_plans.get(key)
    if plan is None:
        if len(_insert_plans) >= _MAX_PLANS:
            _insert_plans.clear()
        plan = _insert_plans[key] = (
            (Pt * n)(*dptr), (ctypes.c_longlong * n)(*[f for f, _ in meta]),
            (ctypes.c_int * n)(*[z for _, z in meta]))
    n_drop = torch.empty((), dtype=torch.int64, device=dev)
    dest = (torch.empty(W, dtype=torch.int32, device=dev)
            if n > _MAX_JOBS else None)
    ws = kernels.workspace(_K11, nbytes(W, P), dev)
    rc = fn(valid.data_ptr(), W, dst.valid.data_ptr(), P, plan[0],
            (Pt * n)(*sptr), plan[1], plan[2], n,
            dest.data_ptr() if dest is not None else None,
            n_drop.data_ptr(), ws.data_ptr(), kernels.stream())
    kernels.check(_K11, "pending_insert", rc, dev)
    kernels.LAUNCHES["K11b"] += -(-n // _MAX_JOBS)
    return dst, n_drop


def pending_insert(dst: PendingTable, frames: dict, fvalid: dict, fts: dict,
                   start_ts: torch.Tensor, last_seq: torch.Tensor,
                   armed_ts: torch.Tensor, valid: torch.Tensor,
                   origin: Optional[torch.Tensor] = None):
    """Insert W candidate entries into dst's free slots (K11b).

    Candidates, [W]: `valid` bool, `start_ts`/`last_seq`/`armed_ts` int64,
    `origin` int32 or None (-1), `frames` {ref: {attr: [W]}} of the table
    column types, `fvalid` {ref: bool[W]} (default: `valid`), `fts` {ref:
    int64[W]} (default 0). Refs of dst missing from `frames` keep their
    columns. The k-th valid candidate takes the k-th free slot in
    ascending slot order; `leg_done` of a written slot is cleared.
    Returns (the table, n_drop int64 0-d: valid candidates past the free
    slots)."""
    if valid.is_cuda:
        return pending_insert_cuda(dst, frames, fvalid, fts, start_ts,
                                   last_seq, armed_ts, valid, origin)
    return pending_insert_plain(dst, frames, fvalid, fts, start_ts,
                                last_seq, armed_ts, valid, origin)


# --------------------------------------------------------------------------- #
# K11c: absent_scan
# --------------------------------------------------------------------------- #


def absent_scan_plain(arr_seq: torch.Tensor, ts: torch.Tensor,
                      lane_ok: torch.Tensor, eq_pairs: Sequence,
                      pend_valid: torch.Tensor, last_seq: torch.Tensor,
                      deadline: Optional[torch.Tensor],
                      residual: Residual = None,
                      tile: Optional[int] = None):
    """Plain K11c: the JAX step's [B, P] kill masks (`pattern_runtime.py:
    871-882, 937-941, 1088-1094`), one tile of entries at a time."""
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    dev = arr_seq.device
    T = tile or match_tile(B)
    first = torch.full((P,), BIGSEQ, dtype=torch.int64, device=dev)
    before = torch.zeros(P, dtype=torch.bool, device=dev)
    after = torch.zeros(P, dtype=torch.bool, device=dev)
    for p0 in range(0, P, T):
        p1 = min(P, p0 + T)
        q = _qualify_tile(arr_seq, lane_ok, eq_pairs, pend_valid, last_seq,
                          residual, p0, p1)
        first[p0:p1] = torch.where(q, arr_seq[:, None], BIGSEQ).amin(0)
        if deadline is None:
            before[p0:p1] = q.any(0)
        else:
            early = ts[:, None] < deadline[None, p0:p1]
            before[p0:p1] = (q & early).any(0)
            after[p0:p1] = (q & ~early).any(0)
    return first, before, after


def _batch_checks(what, arr_seq, ts, lane_ok, pend_valid, last_seq,
                  entry_cols=()):
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    if (arr_seq.dtype != torch.int64 or ts.dtype != torch.int64
            or lane_ok.dtype != torch.bool or pend_valid.dtype != torch.bool
            or last_seq.dtype != torch.int64 or ts.shape != (B,)
            or lane_ok.shape != (B,) or last_seq.shape != (P,)
            or any(c.dtype != torch.int64 or c.shape != (P,)
                   for c in entry_cols)):
        raise ValueError(f"{what}: int64 arr_seq/ts and bool lane_ok [B]; "
                         "bool pend_valid and int64 last_seq (and the "
                         "other entry columns) [P]")


def absent_scan_cuda(arr_seq: torch.Tensor, ts: torch.Tensor,
                     lane_ok: torch.Tensor, eq_pairs: Sequence,
                     pend_valid: torch.Tensor, last_seq: torch.Tensor,
                     deadline: Optional[torch.Tensor],
                     residual: Residual = None,
                     tile: Optional[int] = None,
                     index: Optional[torch.Tensor] = None):
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    eq_pairs = [(a.contiguous(), e.contiguous()) for a, e in eq_pairs]
    extra = (deadline,) if deadline is not None else ()
    kernels.require_cuda("absent_scan", arr_seq, ts, lane_ok, pend_valid,
                         last_seq, *extra,
                         *[t for pair in eq_pairs for t in pair])
    _batch_checks("absent_scan", arr_seq, ts, lane_ok, pend_valid, last_seq,
                  extra)
    eq = _eq_args(eq_pairs, B, P)
    dev = arr_seq.device
    first = torch.empty(P, dtype=torch.int64, device=dev)
    before = torch.empty(P, dtype=torch.bool, device=dev)
    after = torch.empty(P, dtype=torch.bool, device=dev)
    if P == 0:
        return first, before, after
    # built once a call (or handed in), probed by every residual tile
    index = _probe_index("absent_scan", index, arr_seq, ts, lane_ok,
                         eq_pairs, "K11c")
    Pt = ctypes.c_void_p
    fn = kernels.bind("k11c_absent", "k11c_absent_scan",
                      [Pt, ctypes.c_int, Pt, Pt, ctypes.c_int] + [Pt] * 3
                      + [ctypes.c_int] * 2 + [Pt] * 5)
    for p0, p1, mask in _residual_tiles("absent_scan", residual, B, P, tile,
                                        dev):
        rc = fn(index.data_ptr(), B, eq[1], eq[2], eq[3],
                pend_valid.data_ptr(), last_seq.data_ptr(),
                deadline.data_ptr() if deadline is not None else None,
                p0, p1 - p0, mask.data_ptr() if mask is not None else None,
                first.data_ptr(), before.data_ptr(), after.data_ptr(),
                kernels.stream())
        kernels.check("k11c_absent", "absent_scan", rc)
        kernels.LAUNCHES["K11c"] += 1
    return first, before, after


def absent_scan(arr_seq: torch.Tensor, ts: torch.Tensor,
                lane_ok: torch.Tensor, eq_pairs: Sequence,
                pend_valid: torch.Tensor, last_seq: torch.Tensor,
                deadline: Optional[torch.Tensor], residual: Residual = None,
                tile: Optional[int] = None,
                index: Optional[torch.Tensor] = None):
    """Per pending entry, the arrivals of an absent leg that reach it
    (K11c).

    The batch and entry sides are as for `first_match` (valid lanes carry
    strictly increasing `arr_seq`; `lane_ok` holds the valid lanes passing
    the conjuncts over the arrival alone). An arrival qualifies for entry
    p when p is live, every equality holds, the residual holds and
    arr_seq > last_seq[p]. `deadline`: int64 [P] (armed_ts + wait) or
    None (an absence with no timer: every arrival counts as before it).
    `index`: `match_index`'s index of this batch side (default: one built
    for this call); the plain version takes none.

    Returns first int64[P] (the first qualifying arrival seq, BIGSEQ if
    none), before bool[P] (one qualifies with ts < deadline) and after
    bool[P] (one qualifies with ts >= deadline)."""
    if arr_seq.is_cuda:
        return absent_scan_cuda(arr_seq, ts, lane_ok, eq_pairs, pend_valid,
                                last_seq, deadline, residual, tile, index)
    return absent_scan_plain(arr_seq, ts, lane_ok, eq_pairs, pend_valid,
                             last_seq, deadline, residual, tile)


# --------------------------------------------------------------------------- #
# K11d: match_count
# --------------------------------------------------------------------------- #


def match_count_plain(arr_seq: torch.Tensor, ts: torch.Tensor,
                      lane_ok: torch.Tensor, eq_pairs: Sequence,
                      pend_valid: torch.Tensor, last_seq: torch.Tensor,
                      start_ts: torch.Tensor, within: Optional[int],
                      residual: Residual = None,
                      tile: Optional[int] = None) -> torch.Tensor:
    """Plain K11d: the JAX step's `jnp.sum(q, dtype=int64)` over a [B, P]
    mask (`pattern_runtime.py:1318-1331, 1368-1380`), tile by tile."""
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    T = tile or match_tile(B)
    total = torch.zeros((), dtype=torch.int64, device=arr_seq.device)
    for p0 in range(0, P, T):
        p1 = min(P, p0 + T)
        total = total + _qualify_tile(
            arr_seq, lane_ok, eq_pairs, pend_valid, last_seq, residual, p0,
            p1, start_ts, ts, within).sum(dtype=torch.int64)
    return total


def match_count_cuda(arr_seq: torch.Tensor, ts: torch.Tensor,
                     lane_ok: torch.Tensor, eq_pairs: Sequence,
                     pend_valid: torch.Tensor, last_seq: torch.Tensor,
                     start_ts: torch.Tensor, within: Optional[int],
                     residual: Residual = None,
                     tile: Optional[int] = None,
                     index: Optional[torch.Tensor] = None) -> torch.Tensor:
    B = arr_seq.shape[0]
    P = pend_valid.shape[0]
    eq_pairs = [(a.contiguous(), e.contiguous()) for a, e in eq_pairs]
    kernels.require_cuda("match_count", arr_seq, ts, lane_ok, pend_valid,
                         last_seq, start_ts,
                         *[t for pair in eq_pairs for t in pair])
    _batch_checks("match_count", arr_seq, ts, lane_ok, pend_valid, last_seq,
                  (start_ts,))
    eq = _eq_args(eq_pairs, B, P)
    dev = arr_seq.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if P == 0:
        return total
    # built once a call (or handed in), probed by every residual tile
    index = _probe_index("match_count", index, arr_seq, ts, lane_ok,
                         eq_pairs, "K11d")
    Pt = ctypes.c_void_p
    fn = kernels.bind("k11c_absent", "k11d_match_count",
                      [Pt, ctypes.c_int, Pt, Pt, ctypes.c_int] + [Pt] * 3
                      + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                      + [Pt] * 3)
    for p0, p1, mask in _residual_tiles("match_count", residual, B, P, tile,
                                        dev):
        rc = fn(index.data_ptr(), B, eq[1], eq[2], eq[3],
                pend_valid.data_ptr(), last_seq.data_ptr(),
                start_ts.data_ptr(), p0, p1 - p0, int(within is not None),
                int(within) if within is not None else 0,
                mask.data_ptr() if mask is not None else None,
                total.data_ptr(), kernels.stream())
        kernels.check("k11c_absent", "match_count", rc)
        kernels.LAUNCHES["K11d"] += 1
    return total


def match_count(arr_seq: torch.Tensor, ts: torch.Tensor,
                lane_ok: torch.Tensor, eq_pairs: Sequence,
                pend_valid: torch.Tensor, last_seq: torch.Tensor,
                start_ts: torch.Tensor, within: Optional[int],
                residual: Residual = None,
                tile: Optional[int] = None,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The number of qualifying (lane, entry) pairs (K11d), int64 0-d on
    the batch's device: K11a's pattern-mode mask (the lane mask, live
    entries, the equalities, the residual, arr_seq > last_seq and ts -
    start_ts <= within) summed over [B, P] instead of reduced to a first
    lane per entry. `index`: `match_index`'s index of this batch side
    (default: one built for this call); the plain version takes none."""
    if arr_seq.is_cuda:
        return match_count_cuda(arr_seq, ts, lane_ok, eq_pairs, pend_valid,
                                last_seq, start_ts, within, residual, tile,
                                index)
    return match_count_plain(arr_seq, ts, lane_ok, eq_pairs, pend_valid,
                             last_seq, start_ts, within, residual, tile)


# --------------------------------------------------------------------------- #
# K11e: release_origin
# --------------------------------------------------------------------------- #


def release_origin_plain(table: PendingTable, valid: torch.Tensor,
                         origin: torch.Tensor, last_seq: torch.Tensor):
    """Plain K11e, the JAX scatters with drop semantics (`_advance`
    `pattern_runtime.py:1440-1446`): lanes that release nothing aim at
    slot P of a table one row longer, which is cut off."""
    P = table.valid.shape[0]
    o = torch.where(valid & (origin >= 0), origin.long(), P)
    clear = torch.zeros(P + 1, dtype=torch.bool, device=valid.device)
    clear[o] = True
    leg_done = table.leg_done.clone()
    leg_done[:, 0] &= ~clear[:P]
    ext = torch.cat([table.last_seq, table.last_seq.new_zeros(1)])
    ext = ext.scatter_reduce(0, o, last_seq, "amax", include_self=True)
    return table._replace(leg_done=leg_done, last_seq=ext[:P])


def release_origin_cuda(table: PendingTable, valid: torch.Tensor,
                        origin: torch.Tensor, last_seq: torch.Tensor):
    """K11e on the card: one thread per completion; updates `table`'s
    leg_done and last_seq in place."""
    W = valid.shape[0]
    P = table.valid.shape[0]
    kernels.require_cuda("release_origin", valid, origin, last_seq,
                         table.leg_done, table.last_seq)
    if (valid.dtype != torch.bool or origin.dtype != torch.int32
            or last_seq.dtype != torch.int64 or origin.shape != (W,)
            or last_seq.shape != (W,) or table.leg_done.shape != (P, 2)
            or table.leg_done.dtype != torch.bool
            or table.last_seq.dtype != torch.int64):
        raise ValueError("release_origin: bool valid, int32 origin, int64 "
                         "last_seq [W]; the table's bool leg_done [P, 2] "
                         "and int64 last_seq [P]")
    if W == 0:
        return table
    Pt = ctypes.c_void_p
    fn = kernels.bind("k11c_absent", "k11e_release_origin",
                      [Pt] * 3 + [ctypes.c_int, Pt, Pt, ctypes.c_int, Pt])
    rc = fn(valid.data_ptr(), origin.data_ptr(), last_seq.data_ptr(), W,
            table.leg_done.data_ptr(), table.last_seq.data_ptr(), P,
            kernels.stream())
    kernels.check("k11c_absent", "release_origin", rc)
    kernels.LAUNCHES["K11e"] += 1
    return table


def release_origin(table: PendingTable, valid: torch.Tensor,
                   origin: torch.Tensor, last_seq: torch.Tensor):
    """Completions of a mid-pattern `every ( ... )` iteration release the
    context entries they came from (K11e): for every valid completion w
    with origin[w] >= 0, clear leg_done[origin[w], 0] (the busy latch) and
    raise last_seq[origin[w]] to at least last_seq[w]. Several completions
    may share one origin: the seq is a scatter-max. `valid` bool, `origin`
    int32, `last_seq` int64, all [W]. Returns the table (the CUDA version
    updates it in place)."""
    if valid.is_cuda:
        return release_origin_cuda(table, valid, origin, last_seq)
    return release_origin_plain(table, valid, origin, last_seq)
