"""Wire packing of a step's output for the host, kernel K12a (counterpart
of siddhi_tpu/core/stream.py `_wire_pack` / `_wire_unpack`, with the host
compaction `np.nonzero(valid)` of its readers).

A delivery's valid lanes, compacted in lane order, go into ONE device
buffer, and one copy moves that buffer to the host:

    header  int64[4]     count, ts0, over, 0
    then, per region, `capacity` entries of which the first `count` hold
    the compacted lanes (the rest are undefined; `wire_payload` is the
    part a reader uses):
      8-byte columns
      dts     uint32     low 32 bits of ts - ts0 (wrapping int64)
      dts_hi  uint32     high 32 bits of ts - ts0
      4-byte columns
      2-byte columns
      flags   uint8      types << 1 | valid
      1-byte columns (bool, int8)

ts0 is the least valid timestamp (0 when none), as `_wire_pack` computes
it. `over` flags a delta past 2^32 - 1 or below 0; the JAX reader then
re-reads the raw batch, which the port may not do (the next step may
update the output's tensors in place), so the high words ride in the same
buffer and the reader rebuilds the exact timestamps from them. The
timestamp regions so ship 8 bytes a lane, as many as the raw int64: the
packed copy saves only the folded flags byte, and gains its one copy and
one wait and the compaction on the device. Regions are ordered by width, so
every region is aligned and no byte is padding.

`wire_pack` launches K12a (csrc/k12a_wire_pack.cu) on a CUDA batch and
runs `wire_pack_plain` on a CPU batch; `start_readback` packs and enqueues
the copy into pinned host memory at once, so the pack is ordered on the
step's stream before any later in-place update.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels

HEADER_BYTES = 32
#: ts of an invalid lane in the minimum, as `_wire_pack`'s `big`
_BIG = 1 << 62
#: columns one K12a launch takes (its parameter block holds their pointers)
MAX_COLUMNS = 64

_NP = {torch.bool: np.bool_, torch.int8: np.int8, torch.uint8: np.uint8,
       torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
       torch.float32: np.float32, torch.float64: np.float64}


@dataclass(frozen=True)
class WireLayout:
    """Byte offsets of one packed buffer of `capacity` lanes."""

    capacity: int
    names: tuple  # column names, in the batch's order
    dtypes: tuple  # their torch dtypes
    col_offsets: tuple  # byte offset of each column's region
    dts_offset: int
    hi_offset: int
    flags_offset: int
    nbytes: int


@functools.lru_cache(maxsize=512)
def wire_layout(capacity: int, names: tuple, dtypes: tuple) -> WireLayout:
    if len(names) > MAX_COLUMNS:
        raise ValueError(f"wire_pack: {len(names)} columns, at most "
                         f"{MAX_COLUMNS}")
    widths = [torch.empty((), dtype=d).element_size() for d in dtypes]
    offsets = [0] * len(names)
    at = HEADER_BYTES
    dts = hi = flags = 0
    for w in (8, 4, 2, 1):
        if w == 4:
            dts, hi = at, at + 4 * capacity
            at += 8 * capacity
        if w == 1:
            flags = at
            at += capacity
        for i, cw in enumerate(widths):
            if cw == w:
                offsets[i] = at
                at += w * capacity
    if any(w not in (1, 2, 4, 8) for w in widths):
        raise ValueError(f"wire_pack: column widths {widths}")
    return WireLayout(capacity, names, dtypes, tuple(offsets), dts, hi,
                      flags, at)


def layout_of(ts: torch.Tensor, cols: dict) -> WireLayout:
    return wire_layout(ts.shape[0], tuple(cols),
                       tuple(c.dtype for c in cols.values()))


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 `x` as an int32 bit pattern."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def wire_pack_plain(ts: torch.Tensor, valid: torch.Tensor,
                    types: torch.Tensor, cols: dict,
                    layout: WireLayout) -> torch.Tensor:
    """Plain PyTorch K12a: the packed buffer as `_wire_pack` and the host
    compaction compute it (uint8[layout.nbytes])."""
    B = layout.capacity
    buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=ts.device)
    idx = torch.nonzero(valid).squeeze(1)
    count = idx.numel()
    m = (torch.where(valid, ts, torch.full_like(ts, _BIG)).min() if B
         else torch.tensor(_BIG, device=ts.device))
    ts0 = torch.where(m == _BIG, torch.zeros_like(m), m)
    d = ts[idx] - ts0  # wraps like the int64 subtraction of _wire_pack
    over = ((d > 0xFFFFFFFF) | (d < 0)).any()
    header = torch.stack([torch.tensor(count, device=ts.device), ts0,
                          over.to(torch.int64), torch.zeros_like(ts0)])
    buf[:HEADER_BYTES] = header.view(torch.uint8)

    def region(off: int, width: int, dtype: torch.dtype) -> torch.Tensor:
        return buf[off:off + width * B].view(dtype)[:count]

    region(layout.dts_offset, 4, torch.int32)[:] = _u32_bits(d)
    region(layout.hi_offset, 4, torch.int32)[:] = _u32_bits(d >> 32)
    region(layout.flags_offset, 1, torch.uint8)[:] = \
        (types[idx].to(torch.uint8) << 1) | 1
    for off, (name, col) in zip(layout.col_offsets, cols.items()):
        region(off, col.element_size(), col.dtype)[:] = col[idx]
    return buf


_K12A = "k12a_wire_pack"


class _PackPlan(NamedTuple):
    """What a K12a launch of one layout needs besides its tensors."""

    ws_bytes: int  # 0: one block, no workspace
    head: tuple  # n, the column count and the three region offsets
    col_static: tuple  # (dtype, byte width, region offset) a column
    args: type  # the ctypes int64 array type of the launch's arguments
    fn: object  # the bound k12a_wire_pack


@functools.lru_cache(maxsize=512)
def _pack_plan(layout: WireLayout) -> _PackPlan:
    ws = kernels.bind(_K12A, "k12a_workspace_bytes", [ctypes.c_int],
                      restype=ctypes.c_longlong)(layout.capacity)
    if ws < 0:
        raise kernels.KernelError("K12a: the card has no cooperative "
                                  "launches")
    n = len(layout.names)
    widths = [torch.empty((), dtype=d).element_size() for d in layout.dtypes]
    return _PackPlan(
        ws, (layout.capacity, n, layout.dts_offset, layout.hi_offset,
             layout.flags_offset),
        tuple(zip(layout.dtypes, widths, layout.col_offsets)),
        ctypes.c_longlong * (13 + 4 * n),
        kernels.bind(_K12A, "k12a_wire_pack",
                     [ctypes.c_void_p, ctypes.c_void_p]))


def wire_pack_cuda(ts: torch.Tensor, valid: torch.Tensor,
                   types: torch.Tensor, cols: dict,
                   layout: WireLayout) -> torch.Tensor:
    """K12a on the card: one launch, no host sync. Every column is read
    through its stride (views of a packed window ring are not copied);
    the launch's arguments go in one int64 array."""
    B = layout.capacity
    dev = ts.device
    if (not ts.is_cuda or ts.dtype != torch.int64
            or valid.dtype != torch.bool or types.dtype != torch.int8
            or len(cols) != len(layout.names)
            or any(t.device != dev or t.shape != (B,)
                   for t in (ts, valid, types, *cols.values()))):
        raise ValueError("wire_pack: int64 ts, bool valid, int8 types and "
                         f"the layout's columns, each of {B} lanes on one "
                         "CUDA device")
    plan = _pack_plan(layout)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
    stream = kernels.stream()
    ws = (kernels.workspace(_K12A, plan.ws_bytes, dev, stream).data_ptr()
          if plan.ws_bytes else 0)
    args = [ts.data_ptr(), ts.stride(0), valid.data_ptr(), valid.stride(0),
            types.data_ptr(), types.stride(0), *plan.head, buf.data_ptr(),
            ws]
    for c, (dt, width, off) in zip(cols.values(), plan.col_static):
        if c.dtype != dt:
            raise ValueError(f"wire_pack: a {c.dtype} column where the "
                             f"layout holds {dt}")
        args += (c.data_ptr(), c.stride(0), width, off)
    rc = plan.fn(plan.args(*args), stream)
    kernels.check(_K12A, "wire_pack", rc, dev if plan.ws_bytes else None)
    kernels.LAUNCHES["K12a"] += 1
    return buf


def wire_pack(ts: torch.Tensor, valid: torch.Tensor, types: torch.Tensor,
              cols: dict) -> tuple[torch.Tensor, WireLayout]:
    """Pack a batch's valid lanes into one buffer (K12a on the card)."""
    layout = layout_of(ts, cols)
    if ts.is_cuda:
        return wire_pack_cuda(ts, valid, types, cols, layout), layout
    return wire_pack_plain(ts, valid, types, cols, layout), layout


def wire_payload(buf: torch.Tensor, layout: WireLayout) -> torch.Tensor:
    """The bytes of a packed buffer that a reader uses: the header and the
    first `count` entries of each region, concatenated (one host sync to
    read the count). Two packs of one batch agree on these bytes."""
    count = int(buf[:HEADER_BYTES].view(torch.int64)[0])
    regions = [(layout.dts_offset, 4), (layout.hi_offset, 4),
               (layout.flags_offset, 1)] + [
        (off, torch.empty((), dtype=dt).element_size())
        for off, dt in zip(layout.col_offsets, layout.dtypes)]
    return torch.cat([buf[:HEADER_BYTES]]
                     + [buf[off:off + w * count] for off, w in regions])


class WireHost(NamedTuple):
    """A packed buffer unpacked on the host: the compacted valid lanes."""

    count: int
    ts0: int
    over: bool
    ts: np.ndarray  # int64[count]
    types: np.ndarray  # int8[count]
    cols: dict  # name -> numpy[count], device dtypes


def wire_unpack(host: np.ndarray, layout: WireLayout) -> WireHost:
    """Host numpy from a packed buffer (uint8[layout.nbytes]). Every array
    is a fresh copy, so the buffer may be reused at once."""
    hdr = host[:HEADER_BYTES].view(np.int64)
    count, ts0, over = int(hdr[0]), int(hdr[1]), bool(hdr[2])

    def region(off: int, dtype) -> np.ndarray:
        dt = np.dtype(dtype)
        return host[off:off + dt.itemsize * count].view(dt)

    lo = region(layout.dts_offset, np.uint32)
    if over:  # the span passed 32 bits: rebuild from both words, wrapping
        d = ((region(layout.hi_offset, np.uint32).astype(np.uint64)
              << np.uint64(32)) | lo)
        ts = (d + np.int64(ts0).view(np.uint64)).view(np.int64)
    else:
        ts = np.int64(ts0) + lo.astype(np.int64)
    types = (region(layout.flags_offset, np.uint8) >> 1).astype(np.int8)
    cols = {name: region(off, _NP[dt]).copy()
            for name, dt, off in zip(layout.names, layout.dtypes,
                                     layout.col_offsets)}
    return WireHost(count, ts0, over, ts, types, cols)


class Readback:
    """One packed output on its way to the host. `start_readback` enqueues
    the pack and the copy on the current stream; `result()` (any thread)
    waits for the copy and unpacks once."""

    def __init__(self, host: torch.Tensor, layout: WireLayout,
                 event: Optional[torch.cuda.Event]) -> None:
        self._host = host
        self._layout = layout
        self._event = event
        self._lock = threading.Lock()
        self._result: Optional[WireHost] = None

    def result(self) -> WireHost:
        with self._lock:
            if self._result is None:
                if self._event is not None:
                    self._event.synchronize()  # releases the GIL
                self._result = wire_unpack(self._host.numpy(), self._layout)
                self._host = None  # the pinned block returns to its cache
            return self._result


def start_readback(ts: torch.Tensor, valid: torch.Tensor,
                   types: torch.Tensor, cols: dict) -> Readback:
    """Pack the batch and start its copy to the host; no host sync. On the
    card the copy lands in pinned memory from torch's caching host
    allocator and an event marks its end."""
    buf, layout = wire_pack(ts, valid, types, cols)
    if not buf.is_cuda:
        return Readback(buf, layout, None)
    host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Readback(host, layout, event)
