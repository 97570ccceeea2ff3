"""Removal-capable min/max over sliding windows (counterpart of
siddhi_tpu/ops/extrema.py): kernel K8.

A FIFO window's contents at any point of the chunk are a contiguous range
of its arrival sequence: the ring rotated to the expiry frontier, followed
by this chunk's CURRENT values. Each chunk lane's window min/max is a
range-extremum query over that sequence: its range [l, r) runs from the
EXPIRED lanes seen so far (a lane includes its own removal) to the pre-step
window length plus the CURRENT lanes seen so far (a lane includes its own
arrival). Grouped, the positions are stably sorted by the 64-bit group
hash, so each group's rows form a run in position order and the lane's
range is found by two lower-bound searches on (hash, position).

Each function has a plain PyTorch version (the JAX function's sparse table
and vectorised binary search, step for step) and a CUDA wrapper over
csrc/k8_extrema.cu (three-level range structure, see the source). A CUDA
tensor reaches the kernel or raises; a CPU tensor runs the plain version.
Results are bit for bit equal: min and max select one of the inputs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..core.event import EventBatch, EventType
from .groupby import _op_max, _op_min, _scatter_drop

_K8_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int64: 2,
              torch.int32: 3}
_K8_OPS = {"min": 0, "max": 1}


def _ops(op: str, dtype):
    return (_op_min if op == "min" else _op_max)(dtype)


def _lane_counts(chunk: EventBatch):
    """Inclusive running counts of CURRENT and EXPIRED lanes."""
    is_cur = chunk.valid & (chunk.types == int(EventType.CURRENT))
    is_exp = chunk.valid & (chunk.types == int(EventType.EXPIRED))
    return (is_cur, torch.cumsum(is_cur.to(torch.int32), 0, dtype=torch.int32),
            torch.cumsum(is_exp.to(torch.int32), 0, dtype=torch.int32))


def _sequence(ring, expired, appended, chunk: EventBatch, cur, fill):
    """The window's arrival-order sequence over N = C + L positions: the
    ring rotated to the expiry frontier, `fill` past C, the chunk's CURRENT
    values written behind the pre-step window. Returns (A, cc, ce, winlen0)."""
    C = ring.shape[0]
    L = chunk.capacity
    N = C + L
    dev = ring.device
    winlen0 = (appended - expired).to(torch.int32)
    base = torch.remainder(expired, C)
    arr = ring[torch.remainder(base + torch.arange(C, device=dev), C)]
    is_cur, cc, ce = _lane_counts(chunk)
    A = torch.cat([arr, torch.full((L,), fill, dtype=ring.dtype, device=dev)])
    # positions past N exist only when the window overflowed its ring (the
    # JAX scatter drops them: mode="drop")
    dest = torch.where(is_cur, winlen0 + cc - 1, N).clamp(0, N).long()
    return _scatter_drop(A, dest, cur.to(ring.dtype)), cc, ce, winlen0


def _sparse_lookup(combine, identity, vals, l, r):
    """The JAX sparse table over `vals` and its two-probe lookup of [l, r)."""
    N = vals.shape[0]
    levels = [vals]
    span = 1
    while span < N:
        prev = levels[-1]
        shifted = torch.cat([prev[span:], prev.new_full((span,), identity)])
        levels.append(combine(prev, shifted))
        span *= 2
    flat = torch.stack(levels).reshape(-1)
    length = r - l
    # floor(log2(length)) for length >= 1
    k = torch.frexp(length.clamp(min=1).double())[1] - 1
    off = torch.ones_like(k) << k
    g1 = flat[(k * N + l.clamp(0, N - 1)).long()]
    g2 = flat[(k * N + (r - off).clamp(0, N - 1)).long()]
    out = combine(g1, g2)
    return torch.where(length > 0, out, torch.full_like(out, identity))


def sliding_extrema_lanes_plain(op, ring_vals, expired, appended,
                                chunk: EventBatch, cur_vals):
    """Plain PyTorch K8 (the JAX `sliding_extrema_lanes`)."""
    combine, identity = _ops(op, ring_vals.dtype)
    A, cc, ce, winlen0 = _sequence(ring_vals, expired, appended, chunk,
                                   cur_vals, identity)
    return _sparse_lookup(combine, identity, A, ce, winlen0 + cc)


def grouped_sliding_extrema_lanes_plain(op, ring_vals, ring_gkey, expired,
                                        appended, chunk: EventBatch, cur_vals,
                                        cur_gkey):
    """Plain PyTorch grouped K8 (the JAX `grouped_sliding_extrema_lanes`),
    with the positions sorted by (int64 hash, position) instead of JAX's
    (low word, high word, position): a lane's run is the same."""
    combine, identity = _ops(op, ring_vals.dtype)
    A, cc, ce, winlen0 = _sequence(ring_vals, expired, appended, chunk,
                                   cur_vals, identity)
    G, _, _, _ = _sequence(ring_gkey, expired, appended, chunk, cur_gkey, 0)
    N = A.shape[0]
    skey, spos = torch.sort(G, stable=True)
    sval = A[spos]

    def lower_bound(tp):
        """First sorted index with (hash, position) >= (lane's hash, tp)."""
        lo = torch.zeros_like(tp)
        hi = torch.full_like(tp, N)
        for _ in range(N.bit_length() + 1):
            mid = (lo + hi) >> 1
            m = mid.clamp(0, N - 1).long()
            a, ap = skey[m], spos[m]
            lt = (a < cur_gkey) | ((a == cur_gkey) & (ap < tp))
            take = lo < hi
            lo = torch.where(take & lt, mid + 1, lo)
            hi = torch.where(take & ~lt, mid, hi)
        return lo

    return _sparse_lookup(combine, identity, sval, lower_bound(ce),
                          lower_bound(winlen0 + cc))


def _check(what, ring_vals, expired, appended, chunk, cur_vals):
    kernels.require_cuda(what, ring_vals, expired, appended, chunk.valid,
                         chunk.types, cur_vals)
    if (ring_vals.dtype not in _K8_DTYPES or ring_vals.dim() != 1
            or cur_vals.shape != (chunk.capacity,)
            or expired.dtype != torch.int64 or appended.dtype != torch.int64
            or chunk.types.dtype != torch.int8
            or chunk.valid.dtype != torch.bool):
        raise ValueError(f"{what}: ring values [C] and chunk values [L] of "
                         "float32/float64/int64/int32, int64 scalars, bool "
                         "valid and int8 types")


def _k8_cuda(family, op, ring_vals, ring_gkey, expired, appended,
             chunk: EventBatch, cur_vals, cur_gkey):
    """Both K8 stages; `ring_gkey` None for the ungrouped call."""
    cur_vals = cur_vals.to(ring_vals.dtype).contiguous()
    C = ring_vals.shape[0]
    L = chunk.capacity
    N = C + L
    dev = ring_vals.device
    dt = ring_vals.dtype
    block = kernels.library("k8_extrema").k8_block_size()
    nbl = -(-L // block)
    nsb = -(-N // block)
    levels = nsb.bit_length()
    ntiles = -(-N // 32)
    V = torch.empty(N, dtype=dt, device=dev)
    key = (torch.empty(N, dtype=torch.int64, device=dev)
           if ring_gkey is not None else None)
    blk = torch.empty(2 * nbl, dtype=torch.int32, device=dev)
    lo = torch.empty(L, dtype=torch.int32, device=dev)
    hi = torch.empty(L, dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    I = ctypes.c_int

    def ptr(t):
        return t.data_ptr() if t is not None else None

    prepare = kernels.bind("k8_extrema", "k8_prepare",
                           [I, I, P, I, P, P, P, P, P, P, P, I, P, P, P, P, P,
                            P])
    rc = prepare(_K8_OPS[op], _K8_DTYPES[dt], ring_vals.data_ptr(), C,
                 ptr(ring_gkey), expired.data_ptr(), appended.data_ptr(),
                 chunk.valid.data_ptr(), chunk.types.data_ptr(),
                 cur_vals.data_ptr(), ptr(cur_gkey), L, V.data_ptr(),
                 ptr(key), blk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                 kernels.stream())
    kernels.check("k8_extrema", f"{family} (prepare)", rc)
    skey = perm = X = None
    if key is not None:
        skey, perm = torch.sort(key, stable=True)
        X = torch.empty(N, dtype=dt, device=dev)
    arrays = [torch.empty(n, dtype=dt, device=dev)
              for n in (N, N, ntiles, ntiles, ntiles, levels * nsb)]
    out = torch.empty(L, dtype=dt, device=dev)
    query = kernels.bind("k8_extrema", "k8_query_lanes",
                         [I, I] + [P] * 6 + [I, I] + [P] * 7 + [I, I, P, P])
    rc = query(_K8_OPS[op], _K8_DTYPES[dt], V.data_ptr(), ptr(perm),
               ptr(skey), ptr(cur_gkey), lo.data_ptr(), hi.data_ptr(), L, N,
               ptr(X), *[a.data_ptr() for a in arrays], nsb, levels,
               out.data_ptr(), kernels.stream())
    kernels.check("k8_extrema", f"{family} (query)", rc)
    kernels.LAUNCHES[family] += 6
    return out


def sliding_extrema_lanes_cuda(op, ring_vals, expired, appended,
                               chunk: EventBatch, cur_vals):
    _check("sliding_extrema_lanes", ring_vals, expired, appended, chunk,
           cur_vals)
    return _k8_cuda("K8", op, ring_vals.contiguous(), None, expired,
                    appended, chunk, cur_vals, None)


def grouped_sliding_extrema_lanes_cuda(op, ring_vals, ring_gkey, expired,
                                       appended, chunk: EventBatch, cur_vals,
                                       cur_gkey):
    _check("grouped_sliding_extrema_lanes", ring_vals, expired, appended,
           chunk, cur_vals)
    kernels.require_cuda("grouped_sliding_extrema_lanes", ring_gkey,
                         cur_gkey)
    if (ring_gkey.shape != ring_vals.shape
            or cur_gkey.shape != (chunk.capacity,)
            or ring_gkey.dtype != torch.int64
            or cur_gkey.dtype != torch.int64):
        raise ValueError("grouped_sliding_extrema_lanes: int64 group hashes "
                         "[C] and [L]")
    return _k8_cuda("K8 grouped", op, ring_vals.contiguous(), ring_gkey,
                    expired, appended, chunk, cur_vals, cur_gkey)


def sliding_extrema_lanes(op: str, ring_vals, expired, appended,
                          chunk: EventBatch, cur_vals):
    """Per chunk lane, the window's min or max after that lane's add or
    remove (K8). ring_vals [C] over ring slots; expired and appended the
    pre-step window frontiers (int64 scalars); cur_vals [L] over the
    chunk's lanes. An empty range gives the op's identity."""
    if ring_vals.is_cuda:
        return sliding_extrema_lanes_cuda(op, ring_vals, expired, appended,
                                          chunk, cur_vals)
    return sliding_extrema_lanes_plain(op, ring_vals, expired, appended,
                                       chunk, cur_vals)


def grouped_sliding_extrema_lanes(op: str, ring_vals, ring_gkey, expired,
                                  appended, chunk: EventBatch, cur_vals,
                                  cur_gkey):
    """The same within the lane's group, given the 64-bit group hash of
    every ring row and chunk lane (K8 grouped)."""
    if ring_vals.is_cuda:
        return grouped_sliding_extrema_lanes_cuda(
            op, ring_vals, ring_gkey, expired, appended, chunk, cur_vals,
            cur_gkey)
    return grouped_sliding_extrema_lanes_plain(
        op, ring_vals, ring_gkey, expired, appended, chunk, cur_vals,
        cur_gkey)
