"""Incremental aggregation — `define aggregation A from S select ... group by
... aggregate [by tsAttr] every sec ... year` (counterpart of
siddhi_tpu/core/aggregation.py).

Each duration keeps a bucket store (`DurationStore`): (bucket start, group
key) -> a dense slot of a key table, with the bucket start, the group
columns, one accumulator per decomposed component (avg = sum + count) and
an alive flag per slot. Because a bucket's start is a pure function of
the event's timestamp, a micro-batch goes into every duration's store at
once, with no rollover cascade: per duration K3 hashes (bucket, group
columns) (`"K3 aggregation"`), K4 looks the keys up or inserts them
(`"K4 aggregation"`), and K13f writes every column in one launch
(ops/bucket_scatter.py, `"K13f ingest"`). Out-of-order events need no
special path. Month and year buckets use Hinnant's civil-calendar integer
arithmetic in GMT.

Maintenance rides the heartbeat (and every 32nd batch): `@purge`
retention and capacity pressure evict old buckets by re-hashing the kept
slots into a fresh store (K3, K4, `"K13f evict"`); when eviction cannot
help the stores double (`_grow`). Its decisions read counts and buckets on
the host, as in the JAX package; an ingest step reads nothing.

`@store(type='x')` on the definition keeps one record store per duration
(`<Agg>_<duration>`): `flush_durable` (at shutdown) writes the buckets
through, and a new runtime rebuilds its stores from the rows it finds (K3,
K4, `"K13f restore"`).

`within ... per ...` finds and `join A per '...'` read one duration's store
through an `_AggregationView`. The mesh (sharded) paths are not yet ported
(ROADMAP Queue 1 item 10) and are refused.
"""

from __future__ import annotations

import dataclasses
import warnings
from datetime import datetime, timezone
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..errors import DefinitionNotExistError, SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..ops.aggregators import AggregatorFactory, AggregatorSpec
from ..ops.bucket_scatter import bucket_scatter, slots_or_drop
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.groupby import (KeyTable, hash_columns, init_key_table,
                           key_lookup_or_insert)
from ..query_api.definition import (
    AggregationDefinition,
    Attribute,
    AttributeType,
    Duration,
    StreamDefinition,
    TableDefinition,
)
from ..query_api.expression import (AttributeFunction, Constant, Expression,
                                    Variable)
from . import dtypes
from .context import SiddhiAppContext, parse_annotation_time
from .event import EventBatch, StreamCodec
from .stream import Receiver
from .table import broadcast_to

AGG_TIMESTAMP = "AGG_TIMESTAMP"

_MS_WIDTH = {
    Duration.SECONDS: 1_000,
    Duration.MINUTES: 60_000,
    Duration.HOURS: 3_600_000,
    Duration.DAYS: 86_400_000,
}

_DAY_MS = 86_400_000

#: the refusal of the sharded paths
_MESH = ("sharded (mesh) aggregations are not yet ported to siddhi_tpu_torch "
         "(ROADMAP Queue 1 item 10)")


# The calendar arithmetic runs on int64 tensors and on Python ints alike;
# both divisions floor toward -inf, as JAX's floor_divide does, so
# pre-1970 instants land in the right bucket.
def _fdiv(a, b):
    if isinstance(a, torch.Tensor):
        return torch.div(a, b, rounding_mode="floor")
    return a // b


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def _civil_from_days(days):
    """Hinnant civil_from_days: epoch day count -> (year, month) (GMT)."""
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    m = mp + _where(mp < 10, 3, -9)
    y = y + _where(m <= 2, 1, 0)
    return y, m


def _days_from_civil(y, m, d):
    y = y - _where(m <= 2, 1, 0)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m + _where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _bucket_start(duration: Duration, ts):
    if duration in _MS_WIDTH:
        w = _MS_WIDTH[duration]
        return ts - (torch.remainder(ts, w) if isinstance(ts, torch.Tensor)
                     else ts % w)
    y, m = _civil_from_days(_fdiv(ts, _DAY_MS))
    if duration == Duration.MONTHS:
        return _days_from_civil(y, m, 1) * _DAY_MS
    if duration == Duration.YEARS:
        return _days_from_civil(y, 1, 1) * _DAY_MS
    raise SiddhiAppCreationError(f"unsupported duration {duration}")


def bucket_start(duration: Duration, ts: torch.Tensor) -> torch.Tensor:
    """Bucket start (epoch ms) containing each timestamp, per duration,
    elementwise on int64 (reference:
    IncrementalTimeConverterUtil.getStartTimeOfAggregates)."""
    return _bucket_start(duration, ts.to(torch.int64))


def bucket_bounds(duration: Duration, t: int) -> tuple[int, int]:
    """[start, end) of the bucket containing instant `t` (host ints)."""
    lo = _bucket_start(duration, int(t))
    if duration in _MS_WIDTH:
        return lo, lo + _MS_WIDTH[duration]
    probe = lo + (40 if duration == Duration.MONTHS else 370) * _DAY_MS
    return lo, _bucket_start(duration, probe)


def parse_time_constant(value) -> int:
    """`within` bound -> epoch ms. Accepts epoch millis (int) or the
    reference's datetime string formats `yyyy-MM-dd HH:mm:ss` (GMT) with an
    optional `+HH:MM` offset."""
    if isinstance(value, int):
        return value
    if isinstance(value, str):
        s = value.strip()
        for fmt in ("%Y-%m-%d %H:%M:%S %z", "%Y-%m-%d %H:%M:%S"):
            try:
                dt = datetime.strptime(s, fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=timezone.utc)
                return int(dt.timestamp() * 1000)
            except ValueError:
                continue
        raise SiddhiAppCreationError(
            f"cannot parse within bound {value!r} (epoch ms or "
            "'yyyy-MM-dd HH:mm:ss [+HH:MM]')")
    raise SiddhiAppCreationError(f"bad within bound {value!r}")


class DurationStore(NamedTuple):
    """One duration's bucket table: (bucket, group key) -> dense slot."""

    key_table: KeyTable
    bucket_ts: torch.Tensor  # int64[K] bucket start per slot
    group_cols: dict  # name -> [K] group attribute value per slot
    comps: tuple  # per flattened component: [K] accumulator
    alive: torch.Tensor  # bool[K] (False = never used or purged)


@dataclasses.dataclass
class _OutputSpec:
    """One select item of the aggregation definition."""

    name: str
    type: AttributeType
    is_group: bool = False
    group_attr: Optional[str] = None
    spec: Optional[AggregatorSpec] = None
    comp_offset: int = 0  # index of the first component in the flat list


_SCATTER_OP = {"sum": "add", "min": "min", "max": "max"}


class AggregationRuntime(Receiver):
    """Runtime for one `define aggregation` (reference:
    core/aggregation/AggregationRuntime.java:82)."""

    def __init__(self, definition: AggregationDefinition,
                 ctx: SiddhiAppContext, input_junction,
                 registry: Registry) -> None:
        self.definition = definition
        self.ctx = ctx
        self.junction = input_junction
        self.durations = tuple(definition.durations)
        if not self.durations:
            raise SiddhiAppCreationError(
                f"aggregation {definition.id!r} needs `aggregate every ...`")

        in_def: StreamDefinition = input_junction.definition
        self.codec_in = input_junction.codec
        attr_types = {a.name: a.type for a in in_def.attributes
                      if a.type != AttributeType.OBJECT}
        self.resolver = TypeResolver({in_def.id: attr_types}, in_def.id,
                                     {in_def.id: self.codec_in})
        self.frame_ref = in_def.id

        # --- aggregate by <attr> ---
        self.ts_attr = definition.aggregate_attribute
        if self.ts_attr is not None and \
                attr_types.get(self.ts_attr) != AttributeType.LONG:
            raise SiddhiAppCreationError(
                f"aggregate by {self.ts_attr!r}: attribute must be long "
                "epoch ms")

        # --- group-by ---
        self.group_attrs: list[str] = []
        for g in definition.group_by or ():
            if not isinstance(g, Variable):
                raise SiddhiAppCreationError(
                    "aggregation group by must be attributes")
            if g.attribute not in attr_types:
                raise DefinitionNotExistError(
                    f"group by attribute {g.attribute!r} not in "
                    f"{in_def.id!r}")
            self.group_attrs.append(g.attribute)
        if getattr(ctx, "mesh", None) is not None and self.group_attrs:
            raise SiddhiAppCreationError(
                f"aggregation {definition.id!r}: {_MESH}")

        # --- outputs: group attrs pass through; aggregator calls decompose
        self.outputs: list[_OutputSpec] = []
        self._comp_args: list = []  # compiled arg per flat component
        self._comp_meta: list = []  # Component per flat component
        for oa in definition.selector.attributes:
            name = oa.rename or self._infer_name(oa.expression)
            expr = oa.expression
            if isinstance(expr, Variable) and expr.attribute in \
                    self.group_attrs:
                self.outputs.append(_OutputSpec(
                    name=name, type=attr_types[expr.attribute],
                    is_group=True, group_attr=expr.attribute))
                continue
            if isinstance(expr, AttributeFunction):
                factory = registry.lookup(ExtensionKind.AGGREGATOR,
                                          expr.namespace, expr.name)
                if isinstance(factory, AggregatorFactory):
                    args = [compile_expression(p, self.resolver, registry)
                            for p in expr.parameters]
                    spec = factory.make([a.type for a in args])
                    if spec.custom_scan is not None:
                        # distinctCount et al. do not decompose into
                        # additive bucket components
                        raise SiddhiAppCreationError(
                            f"aggregation {definition.id!r}: {expr.name!r} "
                            "is not supported in incremental aggregations")
                    off = len(self._comp_meta)
                    for comp in spec.components:
                        self._comp_meta.append(comp)
                        self._comp_args.append(args[0] if args else None)
                    self.outputs.append(_OutputSpec(
                        name=name, type=spec.return_type, spec=spec,
                        comp_offset=off))
                    continue
            raise SiddhiAppCreationError(
                f"aggregation {definition.id!r} select item {name!r}: must "
                "be a group-by attribute or an aggregator call (the "
                "reference's last-value semantics for other attributes is "
                "not supported)")

        # --- output frame (the store-query surface) ---
        out_attrs = [Attribute(o.name, o.type) for o in self.outputs]
        out_attrs.append(Attribute(AGG_TIMESTAMP, AttributeType.LONG))
        self.output_attr_types = {a.name: a.type for a in out_attrs}
        self.output_definition = StreamDefinition(
            id=definition.id, attributes=tuple(out_attrs))
        self.output_codec = StreamCodec(self.output_definition,
                                        ctx.global_strings)
        # group attr name -> stored column dtype (stored under the INPUT
        # attribute name, so duplicates across outputs share storage)
        self._group_layout = {g: dtypes.device_dtype(attr_types[g])
                              for g in self.group_attrs}

        self.capacity = max(ctx.effective_group_capacity, 4096)
        self.state = tuple(self._init_store() for _ in self.durations)
        self._batches_since_check = 0
        #: retention per duration (@purge/@retentionPeriod), ms
        self.retention_ms = self._parse_retention(definition)

        # --- durable duration stores (@store on the aggregation): one
        # RecordStore per duration; flush_durable() writes the buckets
        # through, and construction rebuilds from any rows found
        # (reference: IncrementalExecutorsInitialiser)
        self._durable_stores = None
        #: rows held back at a capacity-truncated rebuild, re-merged at flush
        self._unrestored: dict = {}
        store_ann = next((a for a in (definition.annotations or ())
                          if a.name.lower() == "store"), None)
        if store_ann is not None:
            self._init_durable(store_ann)

        input_junction.subscribe(self)
        if self._durable_stores is not None:
            self._rebuild_from_durable()

    # ------------------------------------------------------------- durable

    def _init_durable(self, ann) -> None:
        props = {e.key: e.value for e in ann.elements if e.key}
        store_type = props.pop("type", None)
        if not store_type:
            raise SiddhiAppCreationError(
                f"aggregation {self.definition.id!r}: @store needs "
                "type='<registered store>'")
        factory = self.ctx.registry.require(ExtensionKind.STORE, "",
                                            store_type)
        self._durable_stores = {}
        attrs = [Attribute(AGG_TIMESTAMP, AttributeType.LONG)]
        attrs += [Attribute(g, self._group_attr_type(g))
                  for g in self.group_attrs]
        for ci in range(len(self._comp_meta)):
            attrs.append(Attribute(f"_c{ci}", AttributeType.DOUBLE))
        for dur in self.durations:
            td = TableDefinition(
                id=f"{self.definition.id}_{dur.value}",
                attributes=tuple(attrs))
            store = factory()
            store.init(td, dict(props), None)
            store.connect()
            self._durable_stores[dur] = store

    def _group_attr_type(self, name):
        for a in self.junction.definition.attributes:
            if a.name == name:
                return a.type
        raise DefinitionNotExistError(name)

    def export_rows(self) -> dict:
        """Decode every duration store into host bucket rows:
        {duration: [{AGG_TIMESTAMP, <groups...>, _c0.._cN}]}."""
        out = {}
        gtypes = {g: self._group_attr_type(g) for g in self.group_attrs}
        for d_idx, dur in enumerate(self.durations):
            st = self.state[d_idx]
            alive = st.alive.cpu().numpy()
            bts = st.bucket_ts.cpu().numpy()
            groups = {g: v.cpu().numpy() for g, v in st.group_cols.items()}
            comps = [c.cpu().numpy() for c in st.comps]
            rows = []
            for i in np.nonzero(alive)[0]:
                row = {AGG_TIMESTAMP: int(bts[i])}
                for g, arr in groups.items():
                    v = arr[i]
                    if gtypes[g] == AttributeType.STRING:
                        row[g] = self.ctx.global_strings.decode(int(v))
                    else:
                        row[g] = v.item()
                for ci, c in enumerate(comps):
                    row[f"_c{ci}"] = float(c[i])
                rows.append(row)
            out[dur] = rows
        return out

    def flush_durable(self) -> None:
        """Overwrite the durable duration tables with the current buckets.
        If the last rebuild truncated (more durable rows than device
        capacity), merge instead: an overwrite would erase the buckets
        that never fit."""
        if self._durable_stores is None:
            return
        exported = self.export_rows()
        for dur, store in self._durable_stores.items():
            tid = f"{self.definition.id}_{dur.value}"
            rows = exported[dur]
            held = self._unrestored.get(dur)
            if held:
                # held-back buckets re-join (device rows win on key
                # collisions); retention uses the stream clock
                def _k(r):
                    return (r[AGG_TIMESTAMP],
                            tuple(r[g] for g in self.group_attrs))
                merged = {_k(r): r for r in held}
                for r in rows:
                    merged[_k(r)] = r
                rows = list(merged.values())
                retention = self.retention_ms.get(dur)
                if retention is not None:
                    cutoff = (self.ctx.timestamp_generator.current_time()
                              - retention)
                    rows = [r for r in rows if r[AGG_TIMESTAMP] >= cutoff]
            store.delete(store.compile_condition(None, tid))
            if rows:
                store.add(rows)

    def close_durable(self) -> None:
        if self._durable_stores is None:
            return
        for store in self._durable_stores.values():
            store.disconnect()

    def _rebuild_from_durable(self) -> None:
        """Re-scatter durable rows into the device stores (the reference's
        IncrementalExecutorsInitialiser restart path)."""
        gtypes = {g: self._group_attr_type(g) for g in self.group_attrs}
        dev = self.ctx.device
        for d_idx, dur in enumerate(self.durations):
            store = self._durable_stores.get(dur)
            if store is None:
                continue
            rows = list(store.find(store.compile_condition(
                None, f"{self.definition.id}_{dur.value}")))
            if not rows:
                continue
            fit = int(0.7 * self.capacity)
            if len(rows) > fit:
                # restore the NEWEST buckets that fit; hold the rest
                # host-side so flush_durable never erases them
                rows.sort(key=lambda r: r[AGG_TIMESTAMP], reverse=True)
                self._unrestored[dur] = rows[fit:]
                rows = rows[:fit]
                warnings.warn(
                    f"aggregation {self.definition.id!r} [{dur.value}]: "
                    f"{len(self._unrestored[dur])} durable buckets exceed "
                    "device capacity on rebuild; oldest held host-side "
                    "(raise group_capacity)", stacklevel=2)
            n = len(rows)
            bts = np.asarray([r[AGG_TIMESTAMP] for r in rows], np.int64)
            gcols = {}
            for g in self.group_attrs:
                if gtypes[g] == AttributeType.STRING:
                    gcols[g] = np.asarray(
                        [self.ctx.global_strings.encode(r[g]) for r in rows],
                        np.int32)
                else:
                    gcols[g] = np.asarray([r[g] for r in rows],
                                          dtypes.numpy_dtype(gtypes[g]))
            comps = [np.asarray([r[f"_c{ci}"] for r in rows], np.float64)
                     for ci in range(len(self._comp_meta))]

            def dev_t(a):
                return torch.from_numpy(a).to(dev)

            new_store, n_restored = self._restore(
                self.state[d_idx], dev_t(bts),
                {g: dev_t(v) for g, v in gcols.items()},
                [dev_t(c) for c in comps])
            n_ok = int(n_restored)
            if n_ok < n:
                warnings.warn(
                    f"aggregation {self.definition.id!r} [{dur.value}]: only "
                    f"{n_ok}/{n} durable buckets fit the store capacity on "
                    "rebuild — raise group_capacity", stacklevel=2)
            self._replace_store(d_idx, new_store)

    def _restore(self, store: DurationStore, bts, gcols: dict, comps: list):
        """`_restore_fn`: scatter restored rows into one duration store (K3,
        K4, K13f set, in place). Returns (store, rows placed)."""
        K = self.capacity
        valid = torch.ones(bts.shape[0], dtype=torch.bool, device=bts.device)
        key = hash_columns([bts] + [gcols[g] for g in self.group_attrs],
                           counter="K3 aggregation")
        kt, ids, kres = key_lookup_or_insert(store.key_table, key, valid,
                                             counter="K4 aggregation")
        widx = slots_or_drop(ids, kres, K, valid)
        cols = [(store.bucket_ts, bts, "set")]
        cols += [(store.group_cols[g], gcols[g], "set")
                 for g in self.group_attrs]
        cols.append((store.alive, None, "true"))
        cols += [(store.comps[ci], comps[ci].to(comp.dtype), "set")
                 for ci, comp in enumerate(self._comp_meta)]
        bucket_scatter(widx, cols, counter="K13f restore")
        n_ok = (valid & kres).sum(dtype=torch.int32)
        return store._replace(key_table=kt), n_ok

    def ingest_global(self, batch: EventBatch, now: int) -> None:
        """Lane-sharded ingestion over a multi-host mesh: not ported."""
        raise SiddhiAppCreationError(
            f"aggregation {self.definition.id!r}: ingest_global: {_MESH}")

    @staticmethod
    def _parse_retention(definition) -> dict:
        """@purge(enable='true', @retentionPeriod(sec='120 min', min='24
        hours', ...)) (reference: core/aggregation/IncrementalDataPurger)."""
        out: dict[Duration, int] = {}
        ann = next((a for a in definition.annotations or ()
                    if a.name.lower() == "purge"), None)
        if ann is None or (ann.element("enable") or "true").lower() == \
                "false":
            return out
        rp = ann.nested_annotation("retentionPeriod")
        if rp is None:
            return out
        for e in rp.elements:
            if e.key:
                out[Duration.parse(e.key)] = parse_annotation_time(e.value)
        return out

    # ---------------------------------------------------------------- build

    @staticmethod
    def _infer_name(expr: Expression) -> str:
        if isinstance(expr, Variable):
            return expr.attribute
        if isinstance(expr, AttributeFunction):
            return expr.name
        raise SiddhiAppCreationError(
            "aggregation select items need `as` names for expressions")

    def _init_store(self) -> DurationStore:
        K = self.capacity
        dev = self.ctx.device
        return DurationStore(
            key_table=init_key_table(K, dev),
            bucket_ts=torch.zeros(K, dtype=torch.int64, device=dev),
            group_cols={g: torch.zeros(K, dtype=dt, device=dev)
                        for g, dt in self._group_layout.items()},
            comps=tuple(
                torch.zeros(K, dtype=c.dtype, device=dev) if c.op == "sum"
                else torch.full((K,), _monotone_identity(c), dtype=c.dtype,
                                device=dev)
                for c in self._comp_meta),
            alive=torch.zeros(K, dtype=torch.bool, device=dev),
        )

    def _ingest(self, state: tuple, batch: EventBatch, now: int) -> tuple:
        """`_make_ingest`: one batch into every duration store, in place.
        Makes no host synchronisation."""
        K = self.capacity
        scope = Scope()
        scope.add_frame(self.frame_ref, batch.cols, batch.ts, batch.valid,
                        default=True)
        scope.extras["now"] = now
        ts_src = (batch.cols[self.ts_attr] if self.ts_attr is not None
                  else batch.ts).to(torch.int64)
        B, dev = batch.ts.shape[0], batch.ts.device
        sign = torch.ones(B, dtype=torch.float32, device=dev)
        deltas = []
        for comp, arg in zip(self._comp_meta, self._comp_args):
            d = comp.delta(arg(scope) if arg is not None else None, sign)
            deltas.append(broadcast_to(d, (B,), dev).to(comp.dtype))
        new_state = []
        for d_idx, dur in enumerate(self.durations):
            store: DurationStore = state[d_idx]
            bucket = bucket_start(dur, ts_src)
            key = hash_columns(
                [bucket] + [batch.cols[g] for g in self.group_attrs],
                counter="K3 aggregation")
            kt, ids, kres = key_lookup_or_insert(
                store.key_table, key, batch.valid, counter="K4 aggregation")
            widx = slots_or_drop(ids, kres, K, batch.valid)
            cols = [(store.bucket_ts, bucket, "set")]
            cols += [(store.group_cols[g], batch.cols[g], "set")
                     for g in self.group_attrs]
            cols.append((store.alive, None, "true"))
            cols += [(store.comps[ci], deltas[ci], _SCATTER_OP[comp.op])
                     for ci, comp in enumerate(self._comp_meta)]
            bucket_scatter(widx, cols, counter="K13f ingest")
            new_state.append(store._replace(key_table=kt))
        return tuple(new_state)

    def _evict(self, store: DurationStore, cutoff: int) -> DurationStore:
        """`_make_evict`: a fresh store of the current capacity holding
        only the buckets at or after `cutoff`, re-hashed (K3, K4, K13f
        set)."""
        K = self.capacity
        keep = store.alive & (store.bucket_ts >= cutoff)
        keys = hash_columns(
            [store.bucket_ts] + [store.group_cols[g]
                                 for g in self.group_attrs],
            counter="K3 aggregation")
        fresh = self._init_store()
        kt, ids, kres = key_lookup_or_insert(fresh.key_table, keys, keep,
                                             counter="K4 aggregation")
        widx = slots_or_drop(ids, kres, K, keep)
        cols = [(fresh.bucket_ts, store.bucket_ts, "set")]
        cols += [(fresh.group_cols[g], store.group_cols[g], "set")
                 for g in self.group_attrs]
        cols.append((fresh.alive, None, "true"))
        cols += [(fresh.comps[ci], store.comps[ci], "set")
                 for ci in range(len(self._comp_meta))]
        bucket_scatter(widx, cols, counter="K13f evict")
        return fresh._replace(key_table=kt)

    def _replace_store(self, d_idx: int, store: DurationStore) -> None:
        state = list(self.state)
        state[d_idx] = store
        self.state = tuple(state)

    def _grow(self) -> None:
        """Double every duration store's capacity (one rehash each), taken
        when eviction cannot free slots: high group cardinality rather
        than bucket age."""
        self.capacity *= 2
        warnings.warn(
            f"aggregation {self.definition.id!r}: growing bucket stores to "
            f"{self.capacity} slots (set group_capacity higher to avoid the "
            "rehash)", stacklevel=2)
        # a cutoff far in the past keeps everything
        self.state = tuple(self._evict(store, -(1 << 62))
                           for store in self.state)

    def _maybe_evict(self, now: int) -> None:
        """Retention purge and capacity pressure: evict buckets older than
        the newest half when age explains the pressure, grow the stores
        when group cardinality does — never silently drop or corrupt.
        Host decisions: each store's live count crosses to the host, and
        its alive flags and buckets when there is retention or pressure."""
        K = self.capacity
        grow = False
        for d_idx, dur in enumerate(self.durations):
            store = self.state[d_idx]
            retention = self.retention_ms.get(dur)
            cutoff = (now - retention) if retention is not None else 0
            count = int(store.key_table.count)
            pressure = count > int(0.85 * K)
            if retention is None and not pressure:
                continue  # fast path: only the count crossed
            alive = store.alive.cpu().numpy()
            bts = store.bucket_ts.cpu().numpy()
            if pressure:
                live_b = np.sort(bts[alive])[::-1]
                pressure_cutoff = int(live_b[:K // 2][-1])
                would_keep = int(
                    (live_b >= max(cutoff, pressure_cutoff)).sum())
                if would_keep > int(0.7 * K):
                    grow = True  # eviction can't help: too many live groups
                else:
                    cutoff = max(cutoff, pressure_cutoff)
                    warnings.warn(
                        f"aggregation {self.definition.id!r} [{dur.value}]: "
                        "store at capacity; evicting buckets older than "
                        f"{pressure_cutoff} (raise group_capacity or add "
                        "@purge retention)", stacklevel=2)
            if cutoff > 0 and bool((alive & (bts < cutoff)).any()):
                self._replace_store(d_idx, self._evict(store, cutoff))
        if grow:
            self._grow()

    # -------------------------------------------------------------- runtime

    def on_batch(self, batch: EventBatch, now: int) -> None:
        cap = self.junction.batch_size
        if batch.capacity < cap:
            # shape-bucketed deliveries widen back (new lanes invalid)
            batch = batch.pad_to(cap)
        self.state = self._ingest(self.state, batch, now)
        self._batches_since_check += 1
        if self._batches_since_check >= 32:
            self._batches_since_check = 0
            self._maybe_evict(now)

    # ----------------------------------------------------------------- find

    def duration_index(self, per) -> int:
        if isinstance(per, Expression):
            if not isinstance(per, Constant):
                raise SiddhiAppCreationError(
                    "per must be a constant duration")
            per = per.value
        if isinstance(per, str):
            per = Duration.parse(per)
        if per not in self.durations:
            raise SiddhiAppCreationError(
                f"aggregation {self.definition.id!r} has no duration {per}; "
                f"available: {[d.value for d in self.durations]}")
        return self.durations.index(per)

    def store_contents(self, store: DurationStore, now,
                       within: Optional[tuple[int, int]] = None):
        """Output-frame view over one duration's store: (cols, ts, valid),
        the findable surface for store queries and joins (reference:
        AggregationRuntime.find)."""
        cols = {}
        for o in self.outputs:
            if o.is_group:
                cols[o.name] = store.group_cols[o.group_attr]
            else:
                parts = [store.comps[o.comp_offset + i]
                         for i in range(len(o.spec.components))]
                cols[o.name] = o.spec.finalize(parts)
        cols[AGG_TIMESTAMP] = store.bucket_ts
        valid = store.alive
        if within is not None:
            valid = valid & (store.bucket_ts >= within[0]) \
                & (store.bucket_ts < within[1])
        return cols, store.bucket_ts, valid

    def view(self, per, within_range=None) -> "_AggregationView":
        """Bind a `per` duration (and optional within bounds) into a
        store-like object that on-demand queries and joins probe."""
        d_idx = self.duration_index(per)
        within = None
        if within_range is not None:
            lo = parse_time_constant(_const_value(within_range[0]))
            if within_range[1] is None:
                # single-value within: the whole bucket holding the instant
                lo, hi = bucket_bounds(self.durations[d_idx], lo)
            else:
                hi = parse_time_constant(_const_value(within_range[1]))
            within = (lo, hi)
        return _AggregationView(self, d_idx, within)


def _monotone_identity(comp):
    integer = not comp.dtype.is_floating_point
    if comp.op == "min":
        return torch.iinfo(comp.dtype).max if integer else float("inf")
    return torch.iinfo(comp.dtype).min if integer else float("-inf")


def _const_value(expr):
    if isinstance(expr, Constant):
        return expr.value
    if isinstance(expr, (int, str)):
        return expr
    raise SiddhiAppCreationError(
        f"within bound must be a constant, got {expr!r}")


class _AggregationView:
    """Store adapter: quacks like a named window for OnDemandQueryRuntime
    and the join's build side (definition / attr_types / codec / state /
    contents)."""

    def __init__(self, runtime: AggregationRuntime, d_idx: int,
                 within: Optional[tuple[int, int]]) -> None:
        self.runtime = runtime
        self.d_idx = d_idx
        self.within = within
        self.definition = runtime.output_definition
        self.attr_types = dict(runtime.output_attr_types)
        self.codec = runtime.output_codec

    @property
    def state(self):
        return self.runtime.state[self.d_idx]

    def contents(self, store, now):
        return self.runtime.store_contents(store, now, self.within)
