"""Columnar event model (counterpart of siddhi_tpu/core/event.py).

    EventBatch
      ts     : int64[B]            timestamps (ms)
      cols   : {attr: tensor[B]}   one fixed-dtype tensor per attribute
      valid  : bool[B]             lane validity (filters mask lanes)
      types  : int8[B]             CURRENT / EXPIRED / TIMER / RESET

Batches are padded to fixed capacities. `Event` is the host-side event the
callbacks receive. Strings are interned host-side into int32 codes, through
the native C encoder (siddhi_tpu_torch/native.py) when it is built and a
dict loop that gives the same codes when it is not. A batch comes back to
the host as one packed buffer (ops/wire.py, K12a on the card).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch

from .. import native
from ..errors import StaleTransientCodeError
from ..ops.wire import Readback, WireHost, start_readback
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
    """Host-side string interner for one stream attribute (or the app-wide
    table every codec shares). Device tensors carry int32 codes; the table
    maps code <-> string. Code 0 is null."""

    #: transient codes live at the top of the code space (see
    #: encode_transient)
    TRANSIENT_BASE = 1 << 30

    def __init__(self) -> None:
        self._to_code: dict[str, int] = {}
        self._to_str: list[Optional[str]] = [None]  # code 0 = null
        self._transient: list[Optional[str]] = []
        self._transient_code: dict[str, int] = {}
        self._transient_next = 0
        #: generation per ring slot, folded into the code itself (code =
        #: BASE + gen*cap + pos): decoding a code whose slot was recycled
        #: raises instead of returning a newer string. Generations wrap
        #: after 2^30/cap reuses of a slot.
        self._transient_gens: list[int] = []
        self._transient_cap: Optional[int] = None
        #: native pointer-identity intern memo (capsule); created by
        #: encode_array, dropped whenever permanent codes are reassigned
        self._id_memo = None

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return NULL_CODE
        code = self._to_code.get(s)
        if code is None:
            # a LIVE transient string (a uuid coming back from a client)
            # round-trips to its transient code
            code = self._transient_code.get(s)
        if code is None:
            code = len(self._to_str)
            self._to_code[s] = code
            self._to_str.append(s)
        return code

    def encode_transient(self, s: str, capacity: int = 1 << 20) -> int:
        """Intern a never-repeating string (UUID() output) into a bounded
        recycling ring instead of the append-only table. Codes recycle after
        `capacity` newer entries; decoding a recycled code raises
        StaleTransientCodeError."""
        if self._transient_cap is None:
            self._transient_cap = capacity
        cap = self._transient_cap
        pos = self._transient_next
        if len(self._transient) <= pos:
            self._transient.append(s)
            self._transient_gens.append(0)
            gen = 0
        else:
            old = self._transient[pos]
            if old is not None:
                self._transient_code.pop(old, None)
            self._transient[pos] = s
            gen = (self._transient_gens[pos] + 1) % max(
                (1 << 30) // cap, 1)
            self._transient_gens[pos] = gen
        code = self.TRANSIENT_BASE + gen * cap + pos
        self._transient_code[s] = code
        self._transient_next = (pos + 1) % cap
        return code

    def decode(self, code: int) -> Optional[str]:
        if code >= self.TRANSIENT_BASE:
            idx = code - self.TRANSIENT_BASE
            cap = self._transient_cap or (1 << 20)
            pos, gen = idx % cap, idx // cap
            if not 0 <= pos < len(self._transient):
                return None
            if gen != self._transient_gens[pos]:
                raise StaleTransientCodeError(
                    f"transient uuid code {code} was recycled: the slot has "
                    f"seen {self._transient_gens[pos] - gen} newer uuids "
                    f"past the ~{cap}-entry ring — raise the transient "
                    "capacity or avoid retaining uuid codes this long")
            return self._transient[pos]
        return self._to_str[code] if 0 <= code < len(self._to_str) else None

    def encode_array(self, values) -> np.ndarray:
        """Intern a whole column (send_columns path): the native C loop
        when it is built (with the pointer-identity memo), else a dict loop
        that gives the same codes."""
        values = np.asarray(values, dtype=object)
        out = np.empty(len(values), dtype=np.int32)
        nat = native.load()
        if nat is not None:
            if self._id_memo is None:
                self._id_memo = nat.idmemo_new()
            nat.intern_column(values, out, self._to_code, self._to_str,
                              self._transient_code, self._id_memo)
            return out
        to_code, to_str = self._to_code, self._to_str
        transient = self._transient_code
        for i, s in enumerate(values):
            if s is None:
                out[i] = NULL_CODE
                continue
            c = to_code.get(s)
            if c is None:
                c = transient.get(s)
            if c is None:
                c = len(to_str)
                to_code[s] = c
                to_str.append(s)
            out[i] = c
        return out

    def decode_array(self, codes) -> list:
        """One list index per code, decode() only for transient codes."""
        to_str = self._to_str
        n = len(to_str)
        return [to_str[c] if 0 <= c < n else self.decode(c) for c in codes]

    def decode_column(self, codes: np.ndarray) -> list:
        """A code column as strings: native map_codes unless it holds
        transient codes."""
        nat = native.load()
        if nat is not None and (codes.size == 0 or
                                int(codes.max()) < self.TRANSIENT_BASE):
            return nat.map_codes(np.ascontiguousarray(codes), self._to_str)
        return self.decode_array(codes.tolist())

    def __len__(self) -> int:
        return len(self._to_str)

    def snapshot(self) -> dict:
        # the transient ring too: carried state may hold transient codes
        return {"strings": list(self._to_str),
                "transient": list(self._transient),
                "transient_next": self._transient_next,
                "transient_gens": list(self._transient_gens),
                "transient_cap": self._transient_cap}

    def restore(self, snap) -> None:
        """Replace the contents with a snapshot() dict, or a plain list of
        strings (code i -> strings[i], entry 0 the null code). Mutates in
        place: codecs and native encode plans hold these containers."""
        if not isinstance(snap, Mapping):  # pre-transient format
            snap = {"strings": list(snap), "transient": [],
                    "transient_next": 0}
        strings = snap["strings"]
        self._id_memo = None  # permanent codes reassigned below
        self._to_str[:] = list(strings)
        self._to_code.clear()
        self._to_code.update(
            {s: i for i, s in enumerate(strings) if s is not None})
        self._transient[:] = list(snap["transient"])
        self._transient_next = snap["transient_next"]
        self._transient_gens[:] = list(
            snap.get("transient_gens", [0] * len(self._transient)))
        self._transient_cap = snap.get("transient_cap", self._transient_cap)
        cap = self._transient_cap or (1 << 20)
        self._transient_code.clear()
        self._transient_code.update(
            {s: self.TRANSIENT_BASE + self._transient_gens[i] * cap + i
             for i, s in enumerate(self._transient) if s is not None})


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
        self.object_attrs = tuple(a.name for a in definition.attributes
                                  if a.type == AttributeType.OBJECT)
        self._native_plan = self._build_native_plan()

    def _build_native_plan(self):
        """The native encoder's arguments; None when the schema cannot use
        it (OBJECT attributes) or the extension is not available."""
        nat = native.load()
        if nat is None or self.object_attrs:
            return None
        codes, tables, nulls = [], [], []
        np_code = {"bool": "b", "int8": "b", "int32": "i", "int64": "l",
                   "float32": "f", "float64": "d"}
        for a in self.definition.attributes:
            if a.type == AttributeType.STRING:
                tbl = self.string_tables[a.name]
                codes.append("s")
                tables.append((tbl._to_code, tbl._to_str,
                               tbl._transient_code))
                nulls.append(0)
            else:
                c = np_code.get(self.np_dtypes[a.name].name)
                if c is None:
                    return None
                codes.append(c)
                tables.append(None)
                nv = dtypes.null_value(a.type)
                nulls.append(float(nv) if c in "fd" else int(nv))
        return ("".join(codes).encode("ascii"), tuple(tables), tuple(nulls),
                nat)

    def rows_to_columns(self, rows: Sequence[Sequence],
                        n_pad: Optional[int] = None) -> dict[str, np.ndarray]:
        """Encode host rows (tuples in attribute order) into numpy columns,
        zero-padded to n_pad lanes: the native marshaller when built, else
        the Python loop below (the same codes and values)."""
        n = len(rows)
        cap = n_pad if n_pad is not None else n
        if self._native_plan is not None:
            codes, tables, nulls, nat = self._native_plan
            out = tuple(np.zeros(cap, dtype=self.np_dtypes[a.name])
                        for a in self.definition.attributes)
            nat.encode_rows(rows, codes, out, tables, nulls)
            return {a.name: arr
                    for a, arr in zip(self.definition.attributes, out)}
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
        columns take str/None object arrays (interned natively when the
        extension is built) or pre-encoded integer codes."""
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


def events_from_columns(codec: StreamCodec, ts: np.ndarray,
                        is_expired: np.ndarray, cols: dict) -> list[Event]:
    """Host Events from compacted columns in device dtypes: strings decoded
    through the table (native map_codes), Events built natively
    (build_events) when the extension is available."""
    count = ts.shape[0]
    col_lists = []
    for a in codec.definition.attributes:
        if a.type == AttributeType.OBJECT:
            col_lists.append([None] * count)
        elif a.type == AttributeType.STRING:
            col_lists.append(
                codec.string_tables[a.name].decode_column(cols[a.name]))
        elif a.type == AttributeType.BOOL:
            col_lists.append(cols[a.name].astype(bool).tolist())
        else:
            col_lists.append(cols[a.name].tolist())
    nat = native.load()
    if nat is not None:
        return nat.build_events(Event, np.ascontiguousarray(ts),
                                np.ascontiguousarray(is_expired)
                                .astype(np.uint8), tuple(col_lists))
    return [Event(t, d, is_expired=e)
            for t, d, e in zip(ts.tolist(), zip(*col_lists),
                               is_expired.tolist())]


def host_events(host: WireHost, codec: StreamCodec) -> list[Event]:
    """The Events of an unpacked readback (its valid lanes, in order)."""
    if host.count == 0:
        return []
    return events_from_columns(codec, host.ts,
                               host.types == int(EventType.EXPIRED),
                               host.cols)


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

    def readback(self) -> Readback:
        """Pack the valid lanes (K12a on the card) and start their one copy
        to the host; no host sync until `result()`."""
        return start_readback(self.ts, self.valid, self.types, self.cols)

    def to_host_events(self, codec: StreamCodec) -> list[Event]:
        """Valid lanes, in lane order, as host Events — one packed readback
        and one wait."""
        return host_events(self.readback().result(), codec)
