"""Superstep pack, kernel K12b (counterpart of the compaction at the end of
siddhi_tpu/core/superstep.py `SuperstepRunner._make_jit`, :417-428).

A superstep runs K ingress chunks through a query chain and keeps, for
each emitting slot, its K outputs stacked as `ts [K, W]`, columns
`[K, W]` and `valid [K, W]`. The pack writes every valid row, compacted in
(iteration, lane) order, with the per-iteration counts, into ONE device
buffer, so one copy moves a slot's whole superstep to the host:

    header  int64[4]     total, K, W, 0
    counts  int64[K]     valid rows of each iteration
    then, per region, K * W entries of which the first `total` hold the
    compacted rows (the rest are undefined; `pack_payload` is the part a
    reader uses):
      ts      int64
      8-byte columns
      4-byte columns
      2-byte columns
      1-byte columns (bool, int8)

Regions are ordered by width, as K12a's (ops/wire.py), so every region is
aligned. Iteration k's rows are entries [off_k, off_k + counts[k]) of each
region, off_k the sum of the counts before k. Types are not packed: a
published output is all CURRENT (`_select_event_type`).

`superstep_pack` launches K12b (csrc/k12b_superstep_pack.cu) on CUDA
tensors and runs `superstep_pack_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .wire import _NP, MAX_COLUMNS, WireHost

HEADER_BYTES = 32


@dataclass(frozen=True)
class PackLayout:
    """Byte offsets of one packed superstep of K iterations of W lanes."""

    K: int
    W: int
    names: tuple  # column names, in the stacks' order
    dtypes: tuple  # their torch dtypes
    col_offsets: tuple  # byte offset of each column's region
    ts_offset: int
    nbytes: int


@functools.lru_cache(maxsize=256)
def pack_layout(K: int, W: int, names: tuple, dtypes: tuple) -> PackLayout:
    if len(names) > MAX_COLUMNS:
        raise ValueError(f"superstep_pack: {len(names)} columns, at most "
                         f"{MAX_COLUMNS}")
    widths = [torch.empty((), dtype=d).element_size() for d in dtypes]
    if any(w not in (1, 2, 4, 8) for w in widths):
        raise ValueError(f"superstep_pack: column widths {widths}")
    n = K * W
    at = HEADER_BYTES + 8 * K
    ts_off = at
    at += 8 * n
    offsets = [0] * len(names)
    for w in (8, 4, 2, 1):
        for i, cw in enumerate(widths):
            if cw == w:
                offsets[i] = at
                at += w * n
    return PackLayout(K, W, tuple(names), tuple(dtypes), tuple(offsets),
                      ts_off, at)


def layout_of(ts: torch.Tensor, cols: dict) -> PackLayout:
    K, W = ts.shape
    return pack_layout(K, W, tuple(cols),
                       tuple(c.dtype for c in cols.values()))


def _check(ts: torch.Tensor, valid: torch.Tensor, cols: dict) -> None:
    if ts.dim() != 2 or ts.dtype != torch.int64 or valid.dtype != torch.bool:
        raise ValueError("superstep_pack: int64 ts [K, W] and bool valid")
    if valid.shape != ts.shape or any(c.shape != ts.shape
                                      for c in cols.values()):
        raise ValueError("superstep_pack: every stack must be [K, W] "
                         f"{tuple(ts.shape)}")


def superstep_pack_plain(ts: torch.Tensor, valid: torch.Tensor,
                         cols: dict) -> torch.Tensor:
    """Plain PyTorch K12b: the per-iteration sums, a stable order of the
    flattened valid lanes and one `index_select` a column, written into
    the packed buffer (uint8[layout.nbytes])."""
    _check(ts, valid, cols)
    layout = layout_of(ts, cols)
    K, W = ts.shape
    n = K * W
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8, device=ts.device)
    counts = valid.sum(dim=1, dtype=torch.int64)
    flat = valid.reshape(-1)
    from .search import stable_partition_order_plain
    total = int(counts.sum())
    idx = stable_partition_order_plain(flat)[:total].long()
    head = torch.tensor([total, K, W, 0], dtype=torch.int64,
                        device=ts.device)
    buf[:HEADER_BYTES] = head.view(torch.uint8)
    buf[HEADER_BYTES:HEADER_BYTES + 8 * K] = counts.view(torch.uint8)

    def region(off: int, dtype: torch.dtype) -> torch.Tensor:
        w = torch.empty((), dtype=dtype).element_size()
        return buf[off:off + w * n].view(dtype)[:total]

    region(layout.ts_offset, torch.int64)[:] = \
        ts.reshape(-1).index_select(0, idx)
    for off, col in zip(layout.col_offsets, cols.values()):
        region(off, col.dtype)[:] = col.reshape(-1).index_select(0, idx)
    return buf


_K12B_BLOCK = 1024


def superstep_pack_cuda(ts: torch.Tensor, valid: torch.Tensor,
                        cols: dict) -> torch.Tensor:
    """K12b on the card: three launches, no host sync."""
    _check(ts, valid, cols)
    ts, valid = ts.contiguous(), valid.contiguous()
    cols = {k: c.contiguous() for k, c in cols.items()}
    kernels.require_cuda("superstep_pack", ts, valid, *cols.values())
    layout = layout_of(ts, cols)
    K, W = ts.shape
    buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=ts.device)
    tiles = -(-W // _K12B_BLOCK)
    scratch = torch.empty(max(K * tiles, 1), dtype=torch.int64,
                          device=ts.device)
    n = len(cols)
    fn = kernels.bind("k12b_superstep_pack", "k12b_superstep_pack",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                      + [ctypes.c_void_p] * 3)
    rc = fn(ts.data_ptr(), valid.data_ptr(), K, W, n,
            (ctypes.c_void_p * max(n, 1))(*[c.data_ptr()
                                            for c in cols.values()]),
            (ctypes.c_int * max(n, 1))(*[c.element_size()
                                         for c in cols.values()]),
            (ctypes.c_longlong * max(n, 1))(*layout.col_offsets),
            layout.ts_offset, buf.data_ptr(), scratch.data_ptr(),
            kernels.stream())
    kernels.check("k12b_superstep_pack", "superstep_pack", rc)
    kernels.LAUNCHES["K12b"] += 1
    return buf


def superstep_pack(ts: torch.Tensor, valid: torch.Tensor,
                   cols: dict) -> tuple[torch.Tensor, PackLayout]:
    """Pack one emitting slot's K iterations (K12b on the card)."""
    layout = layout_of(ts, cols)
    if ts.is_cuda:
        return superstep_pack_cuda(ts, valid, cols), layout
    return superstep_pack_plain(ts, valid, cols), layout


def pack_payload(buf: torch.Tensor, layout: PackLayout) -> torch.Tensor:
    """The bytes of a packed buffer a reader uses: the header, the counts
    and the first `total` entries of each region, concatenated (one host
    sync to read the total). Two packs of one superstep agree on them."""
    total = int(buf[:8].view(torch.int64)[0])
    regions = [(layout.ts_offset, 8)] + [
        (off, torch.empty((), dtype=dt).element_size())
        for off, dt in zip(layout.col_offsets, layout.dtypes)]
    return torch.cat([buf[:HEADER_BYTES + 8 * layout.K]]
                     + [buf[off:off + w * total] for off, w in regions])


class PackedHost:
    """A packed superstep on the host: `counts` and `slice(k)`, iteration
    k's rows as a WireHost (fresh numpy arrays)."""

    def __init__(self, host: np.ndarray, layout: PackLayout) -> None:
        self._host = host
        self.layout = layout
        self.counts = host[HEADER_BYTES:HEADER_BYTES + 8 * layout.K].view(
            np.int64).copy()
        self.offsets = np.zeros(layout.K + 1, dtype=np.int64)
        np.cumsum(self.counts, out=self.offsets[1:])

    def region(self, off: int, dtype, k: int) -> np.ndarray:
        dt = np.dtype(dtype)
        lo, hi = int(self.offsets[k]), int(self.offsets[k + 1])
        return self._host[off + dt.itemsize * lo:
                          off + dt.itemsize * hi].view(dt).copy()

    def slice(self, k: int) -> WireHost:
        lay = self.layout
        c = int(self.counts[k])
        ts = self.region(lay.ts_offset, np.int64, k)
        cols = {name: self.region(off, _NP[dt], k)
                for name, dt, off in zip(lay.names, lay.dtypes,
                                         lay.col_offsets)}
        return WireHost(c, int(ts[0]) if c else 0, False, ts,
                        np.zeros(c, dtype=np.int8), cols)
