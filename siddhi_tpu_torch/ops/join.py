"""Device join primitives (counterpart of siddhi_tpu/ops/join.py).

A batch arriving on one join side probes the other side's window as a
whole micro-batch:

- **multimap** (sliding-window build sides with equality keys; BASELINE
  config 5): a bucket-chained hash multimap over the window ring, inserted
  as rows append (`multimap_append`, K10) and walked per probe lane
  (`multimap_probe`, K10);
- **sort-merge** (`probe_equi`; other build sides with equality keys): a
  sort of the build hashes (a torch sort still to port) and K6's binary
  search per probe lane — a composition over K3b;
- **cross** (`probe_cross`; ON conditions without an equality): the first
  k_max valid build rows for every probe lane — a composition over K1.

All three give a [B * k_max] candidate block, which `compact_pairs` (K10)
shrinks to the pair block the selector sees; where the multimap path
compacts, `multimap_probe_compact` (K10) walks the chains and writes the
compacted pairs in one launch, with no [B * k_max] block. Hashes only
generate candidates: the exact ON condition re-verifies every pair.

u32 values (hashes, arrival tags) are stored as int32 bit patterns, as
the packed ring stores its words; the plain versions do u32 arithmetic in
int64 masked to 32 bits. Each K10 primitive has a `_plain` and a `_cuda`
version behind one name: a CUDA tensor launches csrc/k10_join.cu, a CPU
tensor runs the plain version. The CUDA versions update the multimap in
place (the counterpart of JAX's buffer donation).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch

from .. import kernels
from ..errors import SiddhiAppCreationError
from ..query_api.definition import AttributeType
from ..query_api.expression import And, Compare, CompareOp, Expression, Variable
from .expr_compile import CompiledExpr, Scope, TypeResolver, compile_expression
from .groupby import hash_columns32, to_u32_bits
from .search import (searchsorted32, stable_argsort_bounded,
                     stable_partition_order)

_MASK32 = 0xFFFFFFFF


def split_conjuncts(expr: Optional[Expression]) -> list[Expression]:
    if expr is None:
        return []
    if isinstance(expr, And):
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def _walk_vars(expr, visit) -> None:
    if isinstance(expr, Variable):
        visit(expr)
        return
    for a in ("left", "right", "expression"):
        sub = getattr(expr, a, None)
        if isinstance(sub, Expression):
            _walk_vars(sub, visit)
    for p in getattr(expr, "parameters", ()) or ():
        if isinstance(p, Expression):
            _walk_vars(p, visit)


def collect_vars(expr) -> list:
    """All Variable leaves of a condition AST."""
    out: list = []
    if expr is not None:
        _walk_vars(expr, out.append)
    return out


def frames_of(expr: Expression, resolver: TypeResolver) -> set:
    """Frame refs referenced by an expression (resolving unqualified vars)."""
    out: set = set()

    def visit(v):
        ref, _, _ = resolver.resolve(v)
        out.add(ref if ref is not None else resolver.default_frame)

    _walk_vars(expr, visit)
    return out


@dataclass
class JoinPlan:
    """Extracted equi-keys + residual condition for one (probe, build) pair."""

    probe_keys: list  # CompiledExpr evaluated on the probe frame
    build_keys: list  # CompiledExpr evaluated on the build frame
    residual: Optional[CompiledExpr]  # full ON condition (pair-verified)


def plan_join(on: Optional[Expression], probe_frame: str, build_frame: str,
              resolver: TypeResolver, registry) -> JoinPlan:
    probe_keys: list = []
    build_keys: list = []
    for conj in split_conjuncts(on):
        if isinstance(conj, Compare) and conj.op == CompareOp.EQUAL:
            lf = frames_of(conj.left, resolver)
            rf = frames_of(conj.right, resolver)
            if lf <= {probe_frame} and rf <= {build_frame}:
                probe_keys.append(compile_expression(conj.left, resolver,
                                                     registry))
                build_keys.append(compile_expression(conj.right, resolver,
                                                     registry))
                continue
            if lf <= {build_frame} and rf <= {probe_frame}:
                probe_keys.append(compile_expression(conj.right, resolver,
                                                     registry))
                build_keys.append(compile_expression(conj.left, resolver,
                                                     registry))
                continue
    residual = (compile_expression(on, resolver, registry)
                if on is not None else None)
    if residual is not None and residual.type != AttributeType.BOOL:
        raise SiddhiAppCreationError("join ON condition must be boolean")
    return JoinPlan(probe_keys, build_keys, residual)


def _hash_exprs(keys: Sequence[CompiledExpr], scope: Scope,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3b over the key expressions, with the BIGKEY remap (a real key never
    hashes to the invalid sentinel) and, where `valid` is given, the
    sentinel on invalid lanes."""
    return hash_columns32([k(scope) for k in keys], remap=True, valid=valid)


def _u64(h: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their zero-extended u32 values (int64), which
    sort and search in u32 order."""
    return h.to(torch.int64) & _MASK32


def _lanes(B: int, k_max: int, device) -> torch.Tensor:
    """Probe lane of each candidate, lane-major: int32[B * k_max]."""
    return torch.arange(B, dtype=torch.int32, device=device)[:, None].expand(
        B, k_max).reshape(-1)


def probe_equi(plan: JoinPlan, probe_scope: Scope, probe_valid: torch.Tensor,
               build_cols: dict, build_ts: torch.Tensor,
               build_valid: torch.Tensor, build_frame: str, k_max: int):
    """Candidate pairs via sort-merge on key hashes (K3b, a torch sort, K6):
    the build hashes sort as u32 (invalid rows, 0xFFFFFFFF, last).

    Returns (probe_lane[P], build_row[P], pair_valid[P]) with P = B*k_max.
    """
    B = probe_valid.shape[0]
    C = build_ts.shape[0]
    dev = probe_valid.device
    bscope = Scope()
    bscope.add_frame(build_frame, build_cols, build_ts, build_valid,
                     default=True)
    bkeys = _u64(_hash_exprs(plan.build_keys, bscope, valid=build_valid))
    pkeys = _u64(_hash_exprs(plan.probe_keys, probe_scope))
    sorted_keys, order = torch.sort(bkeys, stable=True)
    start = searchsorted32(sorted_keys, pkeys)
    pos = start[:, None] + torch.arange(k_max, dtype=torch.int32,
                                        device=dev)[None, :]
    pos_c = torch.clamp(pos, 0, C - 1).long()
    cand_valid = ((pos < C) & (sorted_keys[pos_c] == pkeys[:, None])
                  & probe_valid[:, None])
    build_row = order[pos_c].to(torch.int32)
    return (_lanes(B, k_max, dev), build_row.reshape(-1),
            cand_valid.reshape(-1))


# --------------------------------------------------------------------------- #
# K10: compact_pairs
# --------------------------------------------------------------------------- #


def compact_pairs_plain(probe_lane: torch.Tensor, build_row: torch.Tensor,
                        pair_valid: torch.Tensor, pair_cap: int):
    """Plain K10 compaction: one cumsum and one scatter into a zeroed
    [pair_cap] block (lanes past the kept count stay zero); candidate order
    is kept, pairs past pair_cap are dropped."""
    dev = pair_valid.device
    pos = torch.cumsum(pair_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    dest = torch.where(pair_valid & (pos < pair_cap), pos, pair_cap).long()
    lane = torch.zeros(pair_cap + 1, dtype=torch.int32, device=dev)
    row = torch.zeros(pair_cap + 1, dtype=torch.int32, device=dev)
    lane[dest] = probe_lane.to(torch.int32)
    row[dest] = build_row.to(torch.int32)
    n = torch.clamp(pair_valid.sum(dtype=torch.int32), max=pair_cap)
    pv = torch.arange(pair_cap, dtype=torch.int32, device=dev) < n
    return lane[:pair_cap], row[:pair_cap], pv


_K10_CBLOCK = 1024


def compact_pairs_cuda(probe_lane: torch.Tensor, build_row: torch.Tensor,
                       pair_valid: torch.Tensor, pair_cap: int):
    probe_lane = probe_lane.to(torch.int32).contiguous()
    build_row = build_row.to(torch.int32).contiguous()
    pair_valid = pair_valid.contiguous()
    kernels.require_cuda("compact_pairs", probe_lane, build_row, pair_valid)
    P = pair_valid.shape[0]
    if (pair_valid.dtype != torch.bool or probe_lane.shape != (P,)
            or build_row.shape != (P,) or not 0 < pair_cap <= P):
        raise ValueError("compact_pairs: int32 lanes and rows and bool valid "
                         "[P], 0 < pair_cap <= P")
    dev = pair_valid.device
    nblocks = -(-P // _K10_CBLOCK)
    scratch = torch.empty(nblocks + 1, dtype=torch.int32, device=dev)
    lane = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    row = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    pv = torch.empty(pair_cap, dtype=torch.bool, device=dev)
    Pt = ctypes.c_void_p
    fn = kernels.bind("k10_join", "k10_compact_pairs",
                      [Pt, Pt, Pt, ctypes.c_int, ctypes.c_int] + [Pt] * 5)
    rc = fn(probe_lane.data_ptr(), build_row.data_ptr(),
            pair_valid.data_ptr(), P, pair_cap, scratch.data_ptr(),
            lane.data_ptr(), row.data_ptr(), pv.data_ptr(), kernels.stream())
    kernels.check("k10_join", "compact_pairs", rc)
    kernels.LAUNCHES["K10 compact"] += 3
    return lane, row, pv


def compact_pairs(probe_lane: torch.Tensor, build_row: torch.Tensor,
                  pair_valid: torch.Tensor, pair_cap: int):
    """Compact the sparse [B*k_max] candidate block to `pair_cap` lanes
    (K10): (lane i32, row i32, valid bool), each [pair_cap]."""
    if pair_valid.is_cuda:
        return compact_pairs_cuda(probe_lane, build_row, pair_valid,
                                  pair_cap)
    return compact_pairs_plain(probe_lane, build_row, pair_valid, pair_cap)


# --------------------------------------------------------------------------- #
# K10: the multimap over a window ring
# --------------------------------------------------------------------------- #


class MultimapState(NamedTuple):
    """Incrementally maintained hash multimap over a FIFO window ring.

    Entries are inserted as rows append to the ring and never deleted: FIFO
    overwrite invalidates them, and a chain through an overwritten slot
    ends because every entry past it is older and overwritten too. Entries
    are addressed by ring position; liveness rides a u32 arrival tag per
    slot, compared by wraparound age (`appended - tag`)."""

    heads: torch.Tensor  # int32[H] ring position of the newest entry per bucket
    nexts: torch.Tensor  # int32[C] ring position of the next-older entry
    slot_hash: torch.Tensor  # int32[C] bits of the slot row's u32 key hash
    slot_seq: torch.Tensor  # int32[C] bits of the row's u32 arrival index


def multimap_init(ring_capacity: int, n_buckets: int,
                  device) -> MultimapState:
    return MultimapState(
        heads=torch.full((n_buckets,), -1, dtype=torch.int32, device=device),
        nexts=torch.full((ring_capacity,), -1, dtype=torch.int32,
                         device=device),
        slot_hash=torch.zeros(ring_capacity, dtype=torch.int32,
                              device=device),
        slot_seq=torch.full((ring_capacity,), -1, dtype=torch.int32,
                            device=device))


def multimap_buckets(ring_capacity: int) -> int:
    """Power-of-two bucket count ~2x the ring: short chains, cheap masking."""
    h = 1
    while h < 2 * ring_capacity:
        h *= 2
    return h


def _bucket_order(hashes: torch.Tensor, live: torch.Tensor, H: int):
    """Stages 1-2 of the plain append: K1's live-first order (the window's
    compaction order), then a stable sort by bucket (dead lanes keyed H,
    last; K7 on the card, bounded by H). Returns (hashes in live-first
    order, sorted bucket keys int32, their live-first positions int64)."""
    order = stable_partition_order(live).long()
    h_o = hashes[order]
    sortkey = torch.where(live[order], h_o & (H - 1), H).to(torch.int32)
    run = stable_argsort_bounded(sortkey, H,
                                 counter="K7 bucket order").long()
    return h_o, sortkey[run], run


def _ring_pos(appended0: torch.Tensor, C: int, j: torch.Tensor):
    pos = torch.remainder(appended0, C) + j
    return torch.where(pos >= C, pos - C, pos)


def multimap_append_plain(mm: MultimapState, hashes: torch.Tensor,
                          live: torch.Tensor,
                          appended0: torch.Tensor) -> MultimapState:
    """Plain K10 append, the JAX function's scatters: within a bucket run
    rows link oldest <- newest, the run's oldest to the bucket's previous
    head, and each run's newest becomes the head. Returns a new state."""
    C = mm.nexts.shape[0]
    H = mm.heads.shape[0]
    B = hashes.shape[0]
    dev = hashes.device
    h_o, b_s, run = _bucket_order(hashes, live, H)
    seq_s = to_u32_bits((appended0 + run) & _MASK32)
    pos_s = _ring_pos(appended0, C, run)
    hash_s = h_o[run]
    valid = b_s < H
    same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                              b_s[1:] == b_s[:-1]])
    old_head = mm.heads[torch.clamp(b_s, 0, H - 1).long()]
    prev_pos = torch.cat([torch.full((1,), -1, dtype=torch.int64,
                                     device=dev), pos_s[:-1]])
    next_val = torch.where(same_as_prev, prev_pos, old_head.to(torch.int64))
    dest = torch.where(valid, pos_s, C)

    def scatter(arr, vals, idx):
        ext = torch.cat([arr, arr.new_zeros(1)])
        ext[idx] = vals.to(arr.dtype)
        return ext[:-1]

    is_end = torch.cat([b_s[1:] != b_s[:-1],
                        torch.ones(1, dtype=torch.bool, device=dev)]) & valid
    hdest = torch.where(is_end, b_s.long(), H)
    return MultimapState(heads=scatter(mm.heads, pos_s, hdest),
                         nexts=scatter(mm.nexts, next_val, dest),
                         slot_hash=scatter(mm.slot_hash, hash_s, dest),
                         slot_seq=scatter(mm.slot_seq, seq_s, dest))


_K10 = "k10_join"


def multimap_append_cuda(mm: MultimapState, hashes: torch.Tensor,
                         live: torch.Tensor,
                         appended0: torch.Tensor) -> MultimapState:
    """K10 append on the card: one launch groups the live lanes by bucket
    and writes the chained scatters in place."""
    C = mm.nexts.shape[0]
    H = mm.heads.shape[0]
    B = hashes.shape[0]
    kernels.require_cuda("multimap_append", hashes, live, appended0, *mm)
    if (B > C or hashes.dtype != torch.int32 or live.dtype != torch.bool
            or appended0.dtype != torch.int64
            or any(t.dtype != torch.int32 for t in mm)):
        raise ValueError("multimap_append: int32 hashes and bool live [B <= "
                         "C], int64 appended0, int32 state")
    if B == 0:
        return mm
    dev = hashes.device
    nbytes = kernels.bind(_K10, "k10_append_workspace_bytes",
                          [ctypes.c_int] * 2, restype=ctypes.c_longlong)(B, H)
    ws = scratch = None
    if nbytes:  # past one tile: the cooperative grid's masks and lists
        ws = kernels.workspace(_K10, nbytes, dev).data_ptr()
        sbytes = kernels.bind(_K10, "k10_append_scratch_bytes",
                              [ctypes.c_int], restype=ctypes.c_longlong)(B)
        scratch = kernels.workspace(_K10 + " scratch", sbytes,
                                    dev).data_ptr()
    P = ctypes.c_void_p
    fn = kernels.bind(_K10, "k10_multimap_append",
                      [P, P] + [ctypes.c_int] * 3 + [P] * 8)
    rc = fn(hashes.data_ptr(), live.data_ptr(), B, H, C,
            appended0.data_ptr(), mm.heads.data_ptr(), mm.nexts.data_ptr(),
            mm.slot_hash.data_ptr(), mm.slot_seq.data_ptr(), ws, scratch,
            kernels.stream())
    kernels.check(_K10, "multimap_append", rc, dev if nbytes else None)
    kernels.LAUNCHES["K10 append"] += 1
    return mm


def multimap_append(mm: MultimapState, hashes: torch.Tensor,
                    live: torch.Tensor,
                    appended0: torch.Tensor) -> MultimapState:
    """Insert this batch's live rows, which the window appends (compacted,
    arrival order) at overall indices [appended0, appended0 + n_live)
    (K10)."""
    if hashes.is_cuda:
        return multimap_append_cuda(mm, hashes, live, appended0)
    return multimap_append_plain(mm, hashes, live, appended0)


def multimap_probe_plain(mm: MultimapState, probe_hash: torch.Tensor,
                         probe_valid: torch.Tensor, appended: torch.Tensor,
                         window_len: torch.Tensor, k_max: int):
    """Plain K10 probe: k_max chain steps for every lane at once, u32 ages
    as int64 masked to 32 bits."""
    H = mm.heads.shape[0]
    app32 = appended & _MASK32
    wlen = window_len & _MASK32
    seq = _u64(mm.slot_seq)
    bucket = (probe_hash & (H - 1)).long()
    pos = torch.where(probe_valid, mm.heads[bucket], -1)
    alive = probe_valid
    prev_age = torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    cands, oks = [], []
    for _ in range(k_max):
        ok_pos = alive & (pos >= 0)
        p = torch.where(ok_pos, pos, 0).long()
        age = (app32 - seq[p]) & _MASK32
        live = ok_pos & (age > prev_age) & (age <= wlen)
        match = live & (mm.slot_hash[p] == probe_hash)
        cands.append(torch.where(match, p, 0).to(torch.int32))
        oks.append(match)
        alive = live
        prev_age = age
        pos = mm.nexts[p]
    ok_pos = alive & (pos >= 0)
    p = torch.where(ok_pos, pos, 0).long()
    age = (app32 - seq[p]) & _MASK32
    truncated = (ok_pos & (age > prev_age) & (age <= wlen)).sum(
        dtype=torch.int32)
    # chains run newest -> oldest; reversed, emission is oldest-first
    return (torch.stack(cands[::-1], dim=1), torch.stack(oks[::-1], dim=1),
            truncated)


def multimap_probe_cuda(mm: MultimapState, probe_hash: torch.Tensor,
                        probe_valid: torch.Tensor, appended: torch.Tensor,
                        window_len: torch.Tensor, k_max: int):
    probe_hash = probe_hash.contiguous()
    probe_valid = probe_valid.contiguous()
    kernels.require_cuda("multimap_probe", probe_hash, probe_valid, appended,
                         window_len, *mm)
    B = probe_hash.shape[0]
    H = mm.heads.shape[0]
    if (probe_hash.dtype != torch.int32 or probe_valid.dtype != torch.bool
            or probe_valid.shape != (B,) or appended.dtype != torch.int64
            or window_len.dtype != torch.int64 or H & (H - 1)):
        raise ValueError("multimap_probe: int32 hashes and bool valid [B], "
                         "int64 appended and window_len, 2^k buckets")
    dev = probe_hash.device
    cand_pos = torch.empty((B, k_max), dtype=torch.int32, device=dev)
    cand_ok = torch.empty((B, k_max), dtype=torch.bool, device=dev)
    truncated = torch.zeros((), dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    fn = kernels.bind("k10_join", "k10_multimap_probe",
                      [P, P] + [ctypes.c_int] * 3 + [P] * 9)
    rc = fn(probe_hash.data_ptr(), probe_valid.data_ptr(), B, k_max, H,
            mm.heads.data_ptr(), mm.nexts.data_ptr(), mm.slot_hash.data_ptr(),
            mm.slot_seq.data_ptr(), appended.data_ptr(),
            window_len.data_ptr(), cand_pos.data_ptr(), cand_ok.data_ptr(),
            truncated.data_ptr(), kernels.stream())
    kernels.check("k10_join", "multimap_probe", rc)
    kernels.LAUNCHES["K10 probe"] += 1
    return cand_pos, cand_ok, truncated


def multimap_probe(mm: MultimapState, probe_hash: torch.Tensor,
                   probe_valid: torch.Tensor, appended: torch.Tensor,
                   window_len: torch.Tensor, k_max: int):
    """Walk bucket chains for each probe lane; k_max candidates at most
    (K10). Liveness is the u32 age test `0 < appended - slot_seq <=
    window_len`, and ages must strictly increase along the walk.

    Returns (cand_pos int32[B, K] ring positions oldest-first, cand_ok
    bool[B, K], truncated int32 — probe lanes whose chain still had a live
    entry after k_max steps)."""
    if probe_hash.is_cuda:
        return multimap_probe_cuda(mm, probe_hash, probe_valid, appended,
                                   window_len, k_max)
    return multimap_probe_plain(mm, probe_hash, probe_valid, appended,
                                window_len, k_max)


#: largest k_max of the fused probe (csrc/k10_join.cu PROBE_MAX_K)
PROBE_COMPACT_MAX_K = 64


def multimap_probe_compact_plain(mm: MultimapState, probe_hash: torch.Tensor,
                                 probe_valid: torch.Tensor,
                                 appended: torch.Tensor,
                                 window_len: torch.Tensor, k_max: int,
                                 pair_cap: int):
    """Plain fused K10: `multimap_probe_plain`, then `compact_pairs_plain`
    of its [B * k_max] block, and the pairs past pair_cap counted."""
    B = probe_hash.shape[0]
    cand_pos, cand_ok, truncated = multimap_probe_plain(
        mm, probe_hash, probe_valid, appended, window_len, k_max)
    pv = cand_ok.reshape(-1)
    over = torch.clamp(pv.sum(dtype=torch.int32) - pair_cap, min=0)
    lane, row, pv = compact_pairs_plain(
        _lanes(B, k_max, probe_hash.device), cand_pos.reshape(-1), pv,
        pair_cap)
    return lane, row, pv, over, truncated


def multimap_probe_compact_cuda(mm: MultimapState, probe_hash: torch.Tensor,
                                probe_valid: torch.Tensor,
                                appended: torch.Tensor,
                                window_len: torch.Tensor, k_max: int,
                                pair_cap: int):
    """The fused K10 probe on the card: one cooperative launch (the tile
    counts and the barrier in the library's workspace)."""
    probe_hash = probe_hash.contiguous()
    probe_valid = probe_valid.contiguous()
    kernels.require_cuda("multimap_probe_compact", probe_hash, probe_valid,
                         appended, window_len, *mm)
    B = probe_hash.shape[0]
    H = mm.heads.shape[0]
    if (probe_hash.dtype != torch.int32 or probe_valid.dtype != torch.bool
            or probe_valid.shape != (B,) or appended.dtype != torch.int64
            or window_len.dtype != torch.int64 or H & (H - 1)
            or not 1 <= k_max <= PROBE_COMPACT_MAX_K
            or not 0 < pair_cap <= B * k_max):
        raise ValueError("multimap_probe_compact: int32 hashes and bool "
                         "valid [B], int64 appended and window_len, 2^k "
                         f"buckets, 1 <= k_max <= {PROBE_COMPACT_MAX_K}, "
                         "0 < pair_cap <= B * k_max")
    dev = probe_hash.device
    lane = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    row = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    pv = torch.empty(pair_cap, dtype=torch.bool, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    nbytes = kernels.bind(_K10, "k10_probe_compact_workspace_bytes",
                          [ctypes.c_int], restype=ctypes.c_longlong)
    fn = kernels.bind(_K10, "k10_multimap_probe_compact",
                      [P, P] + [ctypes.c_int] * 3 + [P] * 6
                      + [ctypes.c_int] + [P] * 6)
    ws = kernels.workspace(_K10, nbytes(B), dev)
    rc = fn(probe_hash.data_ptr(), probe_valid.data_ptr(), B, k_max, H,
            mm.heads.data_ptr(), mm.nexts.data_ptr(), mm.slot_hash.data_ptr(),
            mm.slot_seq.data_ptr(), appended.data_ptr(),
            window_len.data_ptr(), pair_cap, lane.data_ptr(), row.data_ptr(),
            pv.data_ptr(), counts.data_ptr(), ws.data_ptr(),
            kernels.stream())
    kernels.check(_K10, "multimap_probe_compact", rc, dev)
    kernels.LAUNCHES["K10 probe compact"] += 1
    return lane, row, pv, counts[1], counts[2]


def multimap_probe_compact(mm: MultimapState, probe_hash: torch.Tensor,
                           probe_valid: torch.Tensor, appended: torch.Tensor,
                           window_len: torch.Tensor, k_max: int,
                           pair_cap: int):
    """`multimap_probe` and `compact_pairs` of its [B * k_max] block into
    pair_cap pairs (K10, one launch on the card): (lane int32, row int32
    ring positions, pv bool, each [pair_cap]; over int32, the pairs past
    pair_cap; truncated int32, as `multimap_probe` counts it). Needs
    1 <= k_max <= PROBE_COMPACT_MAX_K and 0 < pair_cap <= B * k_max."""
    if probe_hash.is_cuda:
        return multimap_probe_compact_cuda(mm, probe_hash, probe_valid,
                                           appended, window_len, k_max,
                                           pair_cap)
    return multimap_probe_compact_plain(mm, probe_hash, probe_valid,
                                        appended, window_len, k_max,
                                        pair_cap)


def probe_equi_mm(plan: JoinPlan, probe_scope: Scope,
                  probe_valid: torch.Tensor, mm: MultimapState,
                  appended: torch.Tensor, window_len: torch.Tensor,
                  k_max: int, pair_cap: Optional[int] = None):
    """`probe_equi` against the multimap: K3b on the probe keys, then the
    chain walks. Returns (probe_lane[P], build_row[P] int32 ring positions,
    pair_valid[P], truncated) with P = B*k_max; given `pair_cap`, the
    walks write the compacted pairs instead (`multimap_probe_compact`):
    (lane, row, pv [pair_cap], over, truncated)."""
    B = probe_valid.shape[0]
    pkeys = _hash_exprs(plan.probe_keys, probe_scope)
    if pair_cap is not None:
        return multimap_probe_compact(mm, pkeys, probe_valid, appended,
                                      window_len, k_max, pair_cap)
    cand_pos, cand_ok, truncated = multimap_probe(
        mm, pkeys, probe_valid, appended, window_len, k_max)
    return (_lanes(B, k_max, probe_valid.device), cand_pos.reshape(-1),
            cand_ok.reshape(-1), truncated)


def probe_cross(probe_valid: torch.Tensor, build_valid: torch.Tensor,
                k_max: int):
    """All (probe, build) candidates, bounded to the first k_max valid build
    rows per probe lane (small build sides only): a composition over K1."""
    B = probe_valid.shape[0]
    C = build_valid.shape[0]
    dev = probe_valid.device
    order = stable_partition_order(build_valid.contiguous())  # valid first
    k = torch.arange(k_max, dtype=torch.int64, device=dev)
    kth = order[torch.clamp(k, 0, C - 1)]
    kv = k < build_valid.sum(dtype=torch.int64)
    build_row = kth[None, :].expand(B, k_max).reshape(-1)
    pair_valid = (probe_valid[:, None] & kv[None, :]).reshape(-1)
    return _lanes(B, k_max, dev), build_row, pair_valid
