"""Columnar event model (counterpart of siddhi_tpu/core/event.py).

    EventBatch
      ts     : int64[B]            timestamps (ms)
      cols   : {attr: tensor[B]}   one fixed-dtype tensor per attribute
      valid  : bool[B]             lane validity (filters mask lanes)
      types  : int8[B]             CURRENT / EXPIRED / TIMER / RESET

Batches are padded to fixed capacities. `Event` is the host-side event the
callbacks receive. Strings are interned host-side into int32 codes; the
native C interning path of the reference package is not ported, so
`StringTable` interns with a dict.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..query_api.definition import AttributeType, StreamDefinition
from . import dtypes
from .dtypes import NULL_CODE


class EventType(enum.IntEnum):
    CURRENT = 0
    EXPIRED = 1
    TIMER = 2
    RESET = 3


@dataclass(frozen=True, slots=True)
class Event:
    """Host-side single event."""

    timestamp: int
    data: tuple
    is_expired: bool = False

    def __iter__(self):
        return iter(self.data)


class StringTable:
    """Host-side string interner: code <-> string, code 0 = null."""

    def __init__(self) -> None:
        self._to_code: dict[str, int] = {}
        self._to_str: list[Optional[str]] = [None]

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return NULL_CODE
        code = self._to_code.get(s)
        if code is None:
            code = len(self._to_str)
            self._to_code[s] = code
            self._to_str.append(s)
        return code

    def encode_array(self, values) -> np.ndarray:
        """Intern a whole column (send_columns path)."""
        values = np.asarray(values, dtype=object)
        out = np.empty(len(values), dtype=np.int32)
        to_code, to_str = self._to_code, self._to_str
        for i, s in enumerate(values):
            if s is None:
                out[i] = NULL_CODE
                continue
            c = to_code.get(s)
            if c is None:
                c = len(to_str)
                to_code[s] = c
                to_str.append(s)
            out[i] = c
        return out

    def decode_array(self, codes) -> list:
        to_str = self._to_str
        n = len(to_str)
        return [to_str[c] if 0 <= c < n else None for c in codes]

    def __len__(self) -> int:
        return len(self._to_str)

    def restore(self, strings: Sequence[Optional[str]]) -> None:
        """Replace the contents with `strings` (code i -> strings[i]; entry 0
        is the null code). Mutates in place: codecs share this table."""
        self._to_str[:] = list(strings)
        self._to_code.clear()
        self._to_code.update(
            {s: i for i, s in enumerate(self._to_str) if s is not None})


class StreamCodec:
    """Per-stream encoder/decoder between host values and columns. String
    attributes share the app-global table so codes agree across streams."""

    def __init__(self, definition: StreamDefinition,
                 shared_strings: Optional[StringTable] = None) -> None:
        self.definition = definition
        self.string_tables: dict[str, StringTable] = {
            a.name: (shared_strings if shared_strings is not None
                     else StringTable())
            for a in definition.attributes if a.type == AttributeType.STRING
        }
        self.np_dtypes = {a.name: dtypes.numpy_dtype(a.type)
                          for a in definition.attributes
                          if a.type != AttributeType.OBJECT}

    def rows_to_columns(self, rows: Sequence[Sequence],
                        n_pad: Optional[int] = None) -> dict[str, np.ndarray]:
        """Encode host rows (tuples in attribute order) into numpy columns,
        zero-padded to n_pad lanes."""
        n = len(rows)
        cap = n_pad if n_pad is not None else n
        cols: dict[str, np.ndarray] = {}
        for i, attr in enumerate(self.definition.attributes):
            if attr.type == AttributeType.OBJECT:
                continue
            arr = np.zeros(cap, dtype=self.np_dtypes[attr.name])
            if attr.type == AttributeType.STRING:
                tbl = self.string_tables[attr.name]
                for r in range(n):
                    arr[r] = tbl.encode(rows[r][i])
            else:
                nv = dtypes.null_value(attr.type)
                for r in range(n):
                    v = rows[r][i]
                    arr[r] = nv if v is None else v
            cols[attr.name] = arr
        return cols

    def encode_columns(self, cols: dict, n: int) -> dict[str, np.ndarray]:
        """Encode user-supplied columns (numpy arrays or sequences). String
        columns take str/None object arrays or pre-encoded integer codes."""
        out: dict[str, np.ndarray] = {}
        for attr in self.definition.attributes:
            if attr.type == AttributeType.OBJECT:
                continue
            if attr.name not in cols:
                raise ValueError(
                    f"send_columns: missing column {attr.name!r} for stream "
                    f"{self.definition.id!r}")
            src = np.asarray(cols[attr.name])
            if src.shape[0] < n:
                raise ValueError(
                    f"send_columns: column {attr.name!r} has {src.shape[0]} "
                    f"rows, expected {n}")
            if attr.type == AttributeType.STRING and \
                    not np.issubdtype(src.dtype, np.integer):
                out[attr.name] = self.string_tables[attr.name].encode_array(
                    src[:n])
            else:
                out[attr.name] = src[:n].astype(self.np_dtypes[attr.name])
        return out


@dataclass
class EventBatch:
    """Columnar micro-batch of events over torch tensors."""

    ts: torch.Tensor  # int64[B]
    cols: dict  # name -> tensor[B]
    valid: torch.Tensor  # bool[B]
    types: torch.Tensor  # int8[B]

    @property
    def capacity(self) -> int:
        return self.ts.shape[0]

    @staticmethod
    def empty(definition: StreamDefinition, capacity: int,
              device) -> "EventBatch":
        """A batch with no valid lane (heartbeats)."""
        return EventBatch(
            ts=torch.zeros(capacity, dtype=dtypes.TS_DTYPE, device=device),
            cols={a.name: torch.zeros(capacity,
                                      dtype=dtypes.device_dtype(a.type),
                                      device=device)
                  for a in definition.attributes
                  if a.type != AttributeType.OBJECT},
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
            types=torch.zeros(capacity, dtype=torch.int8, device=device))

    @staticmethod
    def from_numpy(ts: np.ndarray, cols: dict, n_valid: int,
                   device) -> "EventBatch":
        """Host columns (already padded to the batch capacity) -> device."""
        cap = ts.shape[0]
        valid = np.zeros(cap, dtype=bool)
        valid[:n_valid] = True

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return EventBatch(
            ts=dev(ts.astype(np.int64, copy=False)),
            cols={k: dev(v) for k, v in cols.items()},
            valid=dev(valid),
            types=torch.zeros(cap, dtype=torch.int8, device=device))

    def where_valid(self, mask: torch.Tensor) -> "EventBatch":
        return dataclasses.replace(self, valid=self.valid & mask)

    def pad_to(self, capacity: int) -> "EventBatch":
        """Widen to `capacity` lanes: new lanes are invalid, columns zero,
        timestamps extended with the last value (monotone)."""
        n = capacity - self.capacity
        if n <= 0:
            return self

        def zpad(t):
            return torch.cat([t, t.new_zeros(n)])

        return EventBatch(
            ts=torch.cat([self.ts, self.ts[-1:].expand(n)]),
            cols={k: zpad(v) for k, v in self.cols.items()},
            valid=zpad(self.valid),
            types=zpad(self.types))

    def to_host_events(self, codec: StreamCodec) -> list[Event]:
        """Valid lanes, in lane order, as host Events — the one device to
        host readback of a step."""
        valid = self.valid.cpu().numpy()
        idx = np.nonzero(valid)[0]
        if idx.size == 0:
            return []
        t_idx = torch.from_numpy(idx).to(self.ts.device)
        ts_sel = self.ts[t_idx].cpu().numpy()
        exp_sel = (self.types[t_idx].cpu().numpy() == int(EventType.EXPIRED))
        col_lists = []
        for a in codec.definition.attributes:
            if a.type == AttributeType.OBJECT:
                col_lists.append([None] * idx.size)
                continue
            vals = self.cols[a.name][t_idx].cpu().numpy()
            if a.type == AttributeType.STRING:
                col_lists.append(
                    codec.string_tables[a.name].decode_array(vals.tolist()))
            elif a.type == AttributeType.BOOL:
                col_lists.append(vals.astype(bool).tolist())
            else:
                col_lists.append(vals.tolist())
        return [Event(t, d, is_expired=e)
                for t, d, e in zip(ts_sel.tolist(), zip(*col_lists),
                                   exp_sel.tolist())]
