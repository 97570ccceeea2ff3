"""K13f: the bucket scatter of incremental aggregation (the scatters of
siddhi_tpu/core/aggregation.py `_make_ingest`, `_make_evict` and
`_restore_fn`).

`bucket_scatter(widx, cols)` writes, for every lane i whose slot widx[i]
lies in [0, K), each column's source value i into its destination slot
under the column's op:

- "set": a plain store (bucket start, group columns; every column of an
  evict or a restore);
- "true": stores True (the alive flags), no source;
- "add": a sum (float sums land in lane order here, in atomic order on the
  card; integer sums wrap);
- "min" / "max": as XLA's scatter min/max on the CPU orders floats: NaN
  wins (stored as the canonical quiet NaN), -0.0 < +0.0, so the result does
  not depend on the lanes' order.

The destinations are updated in place (the counterpart of the JAX step's
buffer donation). For CUDA tensors the wrapper launches
csrc/k13f_bucket_scatter.cu once for all columns; for CPU tensors it runs
`bucket_scatter_plain` (`index_put_`, `index_add_` and `scatter_reduce_`
with include_self). It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import kernels

#: the kernel's element kinds and ops (csrc/k13f_bucket_scatter.cu)
_KIND = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3,
         torch.bool: 4, torch.int8: 4, torch.uint8: 4}
_OP = {"set": 0, "true": 1, "add": 2, "min": 3, "max": 4}
_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF, 0x7FC00000),
         torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF,
                         0x7FF8000000000000)}

#: one column: (destination [K], source [n] or None for "true", op)
Column = tuple


def _order_key(x: torch.Tensor, nan_key: int) -> torch.Tensor:
    """Float bits as integers in a total order with -0.0 < +0.0; NaN at
    `nan_key`."""
    bits_dt, mag, _ = _BITS[x.dtype]
    b = x.contiguous().view(bits_dt)
    k = torch.where(b >= 0, b, b ^ mag)
    return torch.where(torch.isnan(x), torch.full_like(k, nan_key), k)


def _from_key(k: torch.Tensor, dtype: torch.dtype,
              nan_key: int) -> torch.Tensor:
    bits_dt, mag, qnan = _BITS[dtype]
    b = torch.where(k >= 0, k, k ^ mag)
    b = torch.where(k == nan_key, torch.full_like(b, qnan), b)
    return b.view(dtype)


def _extreme_plain(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                   op: str) -> None:
    reduce = "amin" if op == "min" else "amax"
    if not dst.dtype.is_floating_point:
        dst.scatter_reduce_(0, idx, src, reduce=reduce, include_self=True)
        return
    info = torch.iinfo(_BITS[dst.dtype][0])
    nan_key = info.min if op == "min" else info.max
    k = _order_key(dst, nan_key)
    k.scatter_reduce_(0, idx, _order_key(src, nan_key), reduce=reduce,
                      include_self=True)
    dst.copy_(_from_key(k, dst.dtype, nan_key))


def bucket_scatter_plain(widx: torch.Tensor, cols: Sequence[Column]) -> None:
    """Plain K13f, in place: the lanes with a slot in [0, K) only."""
    if not cols:
        return
    K = cols[0][0].shape[0]
    keep = (widx >= 0) & (widx < K)
    idx = widx[keep].long()
    for dst, src, op in cols:
        if op == "true":
            dst.index_put_((idx,), torch.ones((), dtype=dst.dtype,
                                              device=dst.device))
        elif op == "set":
            dst.index_put_((idx,), src[keep])
        elif op == "add":
            dst.index_add_(0, idx, src[keep])
        else:
            _extreme_plain(dst, idx, src[keep], op)


def _check(widx: torch.Tensor, cols: Sequence[Column]) -> None:
    if widx.dtype != torch.int32 or widx.dim() != 1:
        raise ValueError("bucket_scatter: widx must be int32[n]")
    n = widx.shape[0]
    K = cols[0][0].shape[0] if cols else 0
    for dst, src, op in cols:
        if op not in _OP:
            raise ValueError(f"bucket_scatter: unknown op {op!r}")
        if dst.dim() != 1 or dst.shape[0] != K:
            raise ValueError("bucket_scatter: destinations must be [K]")
        if dst.dtype not in _KIND:
            raise ValueError(f"bucket_scatter: no kind for {dst.dtype}")
        if _KIND[dst.dtype] == 4 and op not in ("set", "true"):
            raise ValueError("bucket_scatter: bool columns take set only")
        if (op == "true") != (src is None):
            raise ValueError("bucket_scatter: a source for every op but "
                             "'true'")
        if src is not None and (src.dtype != dst.dtype
                                or src.shape != (n,)):
            raise ValueError("bucket_scatter: each source must be [n] of "
                             "its destination's dtype")


def bucket_scatter_cuda(widx: torch.Tensor, cols: Sequence[Column], *,
                        counter: str = "K13f ingest") -> None:
    """K13f on the card: one launch for every column, in place."""
    lib = "k13f_bucket_scatter"
    _check(widx, cols)
    widx = widx.contiguous()
    srcs = [s.contiguous() if s is not None else None for _, s, _ in cols]
    dsts = [d for d, _, _ in cols]
    kernels.require_cuda("bucket_scatter", widx, *dsts,
                         *[s for s in srcs if s is not None])
    n_cols = len(cols)  # the entry point refuses more than its MAX_COLS
    K = dsts[0].shape[0] if dsts else 0
    P, I = ctypes.c_void_p, ctypes.c_int
    rc = kernels.bind(lib, "k13f_bucket_scatter",
                      [P, ctypes.c_longlong, I, P, P, P, P, I, P])(
        widx.data_ptr(), widx.shape[0], K,
        (P * n_cols)(*[d.data_ptr() for d in dsts]),
        (P * n_cols)(*[s.data_ptr() if s is not None else None
                       for s in srcs]),
        (I * n_cols)(*[_KIND[d.dtype] for d in dsts]),
        (I * n_cols)(*[_OP[op] for _, _, op in cols]), n_cols,
        kernels.stream())
    kernels.check(lib, "bucket_scatter", rc)
    kernels.LAUNCHES[counter] += 1


def bucket_scatter(widx: torch.Tensor, cols: Sequence[Column], *,
                   counter: str = "K13f ingest") -> None:
    """Scatter every column of one duration store at the lanes' slots
    (K13f); `counter` names the call site's launch counter."""
    if widx.is_cuda:
        bucket_scatter_cuda(widx, cols, counter=counter)
    else:
        _check(widx, cols)
        bucket_scatter_plain(widx, cols)


def slots_or_drop(ids: torch.Tensor, ok: torch.Tensor, K: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`jnp.where(valid & kres, ids, K)`: int32 slots, K for a dropped
    lane."""
    m = ok if valid is None else valid & ok
    return torch.where(m, ids, torch.full_like(ids, K)).to(torch.int32)
