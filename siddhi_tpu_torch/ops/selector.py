"""Compiled SELECT (counterpart of siddhi_tpu/ops/selector.py): the
projection path, the grouped path keyed by one string code, the hashed
grouped path (K3 -> K4 -> K5), aggregates without GROUP BY, custom
aggregators with their own state (distinctCount, hll:distinctCount),
monotone min/max/minForever/maxForever scans (K5b), sliding-window min/max
as range queries the query runtime computes (K8), HAVING, and ORDER BY /
LIMIT / OFFSET per chunk (K7 and K1 sort, K5b ranks). The set idioms
rewrite to distinctCount (`sizeOfSet(unionSet(createSet(x)))`), a raw
`unionSet(x)` output is materialised on the host from its pair table,
`UUID()` outputs are filled in on the host, and on-demand queries emit
one row per group (the last lane of each group slot, K13b).

Consumes window chunks (CURRENT / EXPIRED / RESET lanes) and produces the
output batch, reproducing per-event semantics: each aggregate component
updates per key with signed deltas and every lane emits its post-update
value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.event import EventBatch, EventType
from ..errors import SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..query_api.definition import AttributeType
from ..query_api.execution import OrderByOrder, OutputAttribute, Selector
from ..query_api.expression import (
    And,
    AttributeFunction,
    Compare,
    Expression,
    MathExpression,
    Not,
    Or,
    Variable,
)
from .aggregators import AggregatorFactory
from .expr_compile import CompiledExpr, Scope, TypeResolver, compile_expression
from .groupby import (
    KeyTable,
    grouped_scan,
    grouped_scan_fused,
    hash_columns,
    init_group_state,
    init_key_table,
    key_lookup_or_insert,
    running_count,
    ungrouped_scan,
    ungrouped_scan_fused,
)
from .search import (float64_sort_key, stable_partition_order,
                     stable_radix_argsort)
from .windows_extra import last_lane_per_slot

AGG_FRAME = "__agg__"
#: pseudo-column carrying each output lane's group slot (grouped snapshot
#: rate limiting); never part of the output schema
GROUP_SLOT_COL = "__slot__"


def _rewrite_set_idioms(expr: Expression) -> Expression:
    """`sizeOfSet(unionSet(createSet(x)))` (and without createSet) becomes
    an exact `distinctCount(x)`: the set is never materialised."""
    if isinstance(expr, AttributeFunction):
        if (not expr.namespace and expr.name == "sizeOfSet"
                and expr.parameters):
            inner = expr.parameters[0]
            if (isinstance(inner, AttributeFunction) and not inner.namespace
                    and inner.name == "unionSet" and inner.parameters):
                arg = inner.parameters[0]
                if (isinstance(arg, AttributeFunction) and not arg.namespace
                        and arg.name == "createSet" and arg.parameters):
                    arg = arg.parameters[0]
                return AttributeFunction("", "distinctCount",
                                         (_rewrite_set_idioms(arg),))
        return AttributeFunction(
            expr.namespace, expr.name,
            tuple(_rewrite_set_idioms(p) for p in expr.parameters))
    for name in ("left", "right", "expression"):
        sub = getattr(expr, name, None)
        if isinstance(sub, Expression):
            expr = dataclasses.replace(
                expr, **{name: _rewrite_set_idioms(sub)})
    return expr


def _rewrite_aggregators(expr: Expression, registry: Registry, found: list):
    """Replace aggregator calls with Variables into the __agg__ frame and
    collect (slot_name, node) into `found`."""
    if isinstance(expr, AttributeFunction):
        impl = registry.lookup(ExtensionKind.AGGREGATOR, expr.namespace,
                               expr.name)
        if impl is not None:
            slot_name = f"agg{len(found)}"
            found.append((slot_name, expr))
            return Variable(slot_name, stream_id=AGG_FRAME)
        return AttributeFunction(
            expr.namespace, expr.name,
            tuple(_rewrite_aggregators(p, registry, found)
                  for p in expr.parameters))
    if isinstance(expr, (MathExpression, Compare, And, Or)):
        return dataclasses.replace(
            expr, left=_rewrite_aggregators(expr.left, registry, found),
            right=_rewrite_aggregators(expr.right, registry, found))
    if isinstance(expr, Not):
        return dataclasses.replace(
            expr,
            expression=_rewrite_aggregators(expr.expression, registry, found))
    return expr


@dataclass
class SelectorState:
    """Selector state. `groups` holds, in aggregate order (sliding-window
    extrema hold none): one bare [K] value tensor per plain sum component
    (they share `shared_epoch`), a GroupState per monotone or forever
    component, or a custom aggregator's state; the key table of the hashed
    path; the RESET epoch counter."""

    groups: list
    key_table: Optional[KeyTable]
    epoch: torch.Tensor  # int32 scalar
    shared_epoch: Optional[torch.Tensor] = None  # int32[K]


class CompiledSelector:
    """Plans one Selector against an input frame layout."""

    def __init__(self, selector: Selector, resolver: TypeResolver,
                 registry: Registry, group_capacity: int,
                 select_all_attrs: Optional[list] = None,
                 sliding_window: bool = False,
                 emit_final_per_group: bool = False):
        self.group_capacity = group_capacity
        #: on-demand queries: one lane per group, its final aggregate,
        #: instead of every lane's running value
        self.emit_final_per_group = emit_final_per_group
        #: set by the query runtime when a grouped snapshot limiter needs
        #: each lane's group slot (GROUP_SLOT_COL)
        self.expose_group_slot = False
        attrs = selector.attributes
        if not attrs:
            if select_all_attrs is None:
                raise SiddhiAppCreationError(
                    "select * needs input attribute list")
            attrs = tuple(OutputAttribute(n, Variable(n))
                          for n, _ in select_all_attrs)
        #: raw `select unionSet(x) as s`: the device tracks an exact
        #: distinctCount; the query runtime materialises the live set on
        #: the host from its pair table. out name -> __agg__ slot
        self.host_set_slots: dict[str, str] = {}
        pre = []
        for a in attrs:
            e = _rewrite_set_idioms(a.expression)
            if (isinstance(e, AttributeFunction) and not e.namespace
                    and e.name == "unionSet" and e.parameters):
                arg = e.parameters[0]
                if (isinstance(arg, AttributeFunction) and not arg.namespace
                        and arg.name == "createSet" and arg.parameters):
                    arg = arg.parameters[0]
                if a.rename is None:
                    raise SiddhiAppCreationError(
                        "raw unionSet(...) output needs an `as` name")
                if selector.group_by:
                    raise SiddhiAppCreationError(
                        "raw unionSet(...) emission is ungrouped-only on "
                        "this engine (use sizeOfSet(unionSet(...)) for "
                        "grouped counts)")
                if compile_expression(arg, resolver,
                                      registry).type != AttributeType.STRING:
                    raise SiddhiAppCreationError(
                        "raw unionSet(...) emission needs a STRING argument "
                        "(host materialization reads the dictionary-code "
                        "table); use sizeOfSet(unionSet(...)) for counts "
                        "over other types")
                self.host_set_slots[a.rename] = ""  # agg slot filled below
                e = AttributeFunction("", "distinctCount", (arg,))
            pre.append((a.rename, e))
        agg_nodes: list = []
        rewritten = [(name, _rewrite_aggregators(e, registry, agg_nodes))
                     for name, e in pre]
        for name, e in rewritten:
            if name in self.host_set_slots:
                self.host_set_slots[name] = e.attribute
        #: outputs filled with a fresh uuid4 per event on the host; the
        #: device lanes carry a placeholder code
        self.host_uuid_slots: list[str] = [
            name or f"UUID{i}" for i, (name, e) in enumerate(rewritten)
            if (isinstance(e, AttributeFunction) and not e.namespace
                and e.name == "UUID")]

        self.agg_specs = []
        #: sliding-window true extrema: (slot, 'min'|'max', arg exprs); the
        #: query runtime computes them as range queries over the window's
        #: arrival order (K8) and hands them in as scope extras
        self.extrema_plan = []
        for slot_name, node in agg_nodes:
            factory = registry.require(ExtensionKind.AGGREGATOR,
                                       node.namespace, node.name)
            assert isinstance(factory, AggregatorFactory)
            args = [compile_expression(p, resolver, registry)
                    for p in node.parameters]
            spec = factory.make(tuple(a.type for a in args))
            if sliding_window and spec.extrema_op is not None:
                self.extrema_plan.append((slot_name, spec.extrema_op, args))
            self.agg_specs.append((slot_name, spec, args))
        self._extrema_slots = {s for s, _, _ in self.extrema_plan}
        # grouped extrema need the group hash of ring rows and chunk lanes
        # alike; one function, so the two can never diverge
        self.extrema_group_hash = None
        if self.extrema_plan and selector.group_by:
            gvars = [resolver.resolve(v) for v in selector.group_by]
            self.extrema_group_hash = lambda scope: hash_columns(
                [scope.col(ref, attr) for ref, attr, _ in gvars])

        frames = dict(resolver.frames)
        frames[AGG_FRAME] = {slot: spec.return_type
                             for slot, spec, _ in self.agg_specs}
        self.resolver = TypeResolver(frames, resolver.default_frame,
                                     resolver.codecs,
                                     resolver.set_projections)
        self.out_exprs: list[tuple[str, CompiledExpr]] = [
            (name, CompiledExpr(_uuid_placeholder, AttributeType.STRING)
             if name in self.host_uuid_slots
             else compile_expression(e, self.resolver, registry))
            for name, e in rewritten]
        self.out_types = {name: ce.type for name, ce in self.out_exprs}
        for name in self.host_set_slots:
            # the lane carries the exact distinct count: downstream
            # consumers read the set-size projection as LONG
            self.out_types[name] = AttributeType.LONG

        self.group_vars = [resolver.resolve(v) for v in selector.group_by]
        self.use_string_code = (len(self.group_vars) == 1
                                and self.group_vars[0][2] == AttributeType.STRING)
        self.needs_key_table = bool(self.group_vars) and not self.use_string_code

        out_frames = dict(frames)
        out_frames["__out__"] = dict(self.out_types)
        out_resolver = TypeResolver(out_frames, "__out__", resolver.codecs,
                                    resolver.set_projections)
        self.having = (compile_expression(selector.having, out_resolver,
                                          registry)
                       if selector.having is not None else None)
        self.order_by = [(out_resolver.resolve(ob.variable), ob.order)
                         for ob in selector.order_by]
        self.limit = selector.limit
        self.offset = selector.offset

    def init_state(self, device) -> SelectorState:
        K = self.group_capacity if self.group_vars else 1
        groups = []
        any_fused = False
        for slot_name, spec, _ in self.agg_specs:
            if slot_name in self._extrema_slots:
                continue  # computed by the query runtime; no state
            if spec.custom_scan is not None:
                groups.append(spec.init_custom(
                    self.group_capacity, device,
                    grouped=bool(self.group_vars)))
                continue
            for comp in spec.components:
                if comp.fused:
                    groups.append(torch.zeros(K, dtype=comp.dtype,
                                              device=device))
                    any_fused = True
                else:
                    groups.append(init_group_state(K, comp.dtype, device))
        return SelectorState(
            groups=groups,
            key_table=(init_key_table(K, device) if self.needs_key_table
                       else None),
            epoch=torch.zeros((), dtype=torch.int32, device=device),
            shared_epoch=(torch.zeros(K, dtype=torch.int32, device=device)
                          if any_fused else None))

    def union_set_values(self, sstate: SelectorState, out_name: str,
                         string_table) -> set:
        """The live value set behind a raw-unionSet output (the ungrouped
        string path's per-code pair counts), decoded through the app's
        string table: one readback."""
        agg_slot = self.host_set_slots[out_name]
        off = 0
        state = None
        for slot_name, spec, _ in self.agg_specs:
            if slot_name in self._extrema_slots:
                continue
            if slot_name == agg_slot:
                state = sstate.groups[off]
                break
            off += 1 if spec.custom_scan is not None else len(
                spec.components)
        assert state is not None, f"no state for set slot {out_name!r}"
        pairs = state[0]  # (pair GroupState[P], distinct GroupState[1])
        live = (pairs.epoch == sstate.epoch) & (pairs.values > 0)
        codes = torch.nonzero(live).flatten().cpu().tolist()
        return {string_table.decode(int(c)) for c in codes}

    def step(self, state: SelectorState, chunk: EventBatch,
             scope: Scope) -> tuple[SelectorState, EventBatch]:
        L = chunk.capacity
        dev = chunk.ts.device
        valid, types = chunk.valid, chunk.types
        is_current = types == int(EventType.CURRENT)
        is_expired = types == int(EventType.EXPIRED)
        is_reset = valid & (types == int(EventType.RESET))
        data_valid = valid & (is_current | is_expired)

        key_table = state.key_table
        if self.group_vars and self.use_string_code:
            ref, attr, _ = self.group_vars[0]
            slots = scope.col(ref, attr).to(torch.int32).contiguous()
        elif self.group_vars:
            key_cols = [scope.col(ref, attr) for ref, attr, _ in self.group_vars]
            key_table, slots, kres = key_lookup_or_insert(
                key_table, hash_columns(key_cols), data_valid)
            # unresolved lanes (key table exhausted) take the sentinel slot
            # so they never alias group 0
            slots = torch.where(kres, slots, self.group_capacity).to(
                torch.int32)
        else:
            slots = torch.zeros(L, dtype=torch.int32, device=dev)

        groups, shared_epoch = list(state.groups), state.shared_epoch
        agg_values: dict[str, torch.Tensor] = {}
        if self.agg_specs:
            sign = torch.where(is_expired, -1, 1).to(torch.int32)
            no_reset = torch.zeros_like(is_reset)
            grouped = bool(self.group_vars)
            results: dict[int, torch.Tensor] = {}
            pending = []
            fused_idx, fused_deltas = [], []
            gi = 0
            for slot_name, spec, args in self.agg_specs:
                if slot_name in self._extrema_slots:
                    # per-lane window extrema from the query runtime (K8)
                    agg_values[slot_name] = scope.extras[
                        f"extrema:{slot_name}"]
                    continue
                arg_vals = [a(scope) for a in args] if args else [None]
                if spec.custom_scan is not None:
                    groups[gi], results[gi] = spec.custom_scan(
                        state.groups[gi], slots, arg_vals, sign, data_valid,
                        is_reset, state.epoch, grouped=grouped)
                    pending.append((slot_name, spec, [gi]))
                    gi += 1
                    continue
                comp_gis = []
                for comp in spec.components:
                    deltas = comp.delta(arg_vals[0], sign).contiguous()
                    if comp.fused:
                        fused_idx.append(gi)
                        fused_deltas.append(deltas)
                    else:
                        # monotone: EXPIRED lanes are ignored, and a
                        # forever component never resets
                        lane_valid = (valid & is_current
                                      if comp.ignore_removal else data_valid)
                        resets = no_reset if comp.ignore_reset else is_reset
                        if grouped:
                            groups[gi], results[gi] = grouped_scan(
                                state.groups[gi], slots, deltas, lane_valid,
                                resets, state.epoch, op=comp.op)
                        else:
                            groups[gi], results[gi] = ungrouped_scan(
                                state.groups[gi], deltas, lane_valid, resets,
                                state.epoch, op=comp.op)
                    comp_gis.append(gi)
                    gi += 1
                pending.append((slot_name, spec, comp_gis))
            if fused_idx:
                fused_vals = [state.groups[i] for i in fused_idx]
                if grouped:
                    fused_vals, shared_epoch, outs = grouped_scan_fused(
                        fused_vals, shared_epoch, slots, fused_deltas,
                        data_valid, is_reset, state.epoch)
                else:
                    fused_vals, shared_epoch, outs = ungrouped_scan_fused(
                        fused_vals, shared_epoch, fused_deltas, data_valid,
                        is_reset, state.epoch)
                for i, v, o in zip(fused_idx, fused_vals, outs):
                    groups[i] = v
                    results[i] = o
            for slot_name, spec, comp_gis in pending:
                agg_values[slot_name] = spec.finalize(
                    [results[i] for i in comp_gis])
            scope.frames[AGG_FRAME] = agg_values
            scope.valids[AGG_FRAME] = data_valid
            scope.ts[AGG_FRAME] = chunk.ts

        new_epoch = state.epoch + is_reset.sum(dtype=torch.int32)

        out_cols = {}
        for name, ce in self.out_exprs:
            v = ce(scope)
            if v.dim() == 0:  # constant projection: broadcast to the lanes
                v = torch.full((L,), v.item(), dtype=v.dtype, device=dev)
            out_cols[name] = v
        if self.expose_group_slot:
            # grouped snapshot limiters retain one row per group: each
            # lane's group slot rides through order / limit as a column
            out_cols[GROUP_SLOT_COL] = slots
        out_valid = data_valid
        if self.emit_final_per_group and self.agg_specs:
            # keep only the last lane of each group (its running aggregate
            # is the group's final value), before HAVING judges it
            K = self.group_capacity if self.group_vars else 1
            in_range = out_valid & (slots >= 0) & (slots < K)
            last = last_lane_per_slot(torch.where(in_range, slots, K), K,
                                      counter="K13b final per group")
            idx = torch.arange(L, dtype=torch.int32, device=dev)
            out_valid = out_valid & (
                idx == last[torch.clamp(slots, 0, K - 1).long()])
        if self.having is not None:
            scope.frames["__out__"] = out_cols
            scope.valids["__out__"] = out_valid
            scope.ts["__out__"] = chunk.ts
            out_valid = out_valid & self.having(scope)
        out = EventBatch(ts=chunk.ts, cols=out_cols, valid=out_valid,
                         types=types)
        # order by / offset / limit apply per chunk, like the reference
        if self.order_by:
            out = self._order_chunk(out)
        if self.offset is not None or self.limit is not None:
            out = self._limit_chunk(out)
        return SelectorState(groups, key_table, new_epoch, shared_epoch), out

    def _order_chunk(self, out: EventBatch) -> EventBatch:
        """The JAX `_order_chunk`: per key, last key first, a stable argsort
        of the float64 keys (DESC negated before the cast, `~` on BOOL;
        invalid lanes +inf) through `float64_sort_key` (K7), then a stable
        partition with the valid lanes first (K1). A STRING key orders by
        its intern code, as the JAX package's int32 code column does."""
        perm = torch.arange(out.capacity, device=out.ts.device)
        for (_, attr, _), order in reversed(self.order_by):
            col = out.cols[attr]
            if order == OrderByOrder.DESC:
                col = ~col if col.dtype == torch.bool else -col
            if col.dtype == torch.float32:
                # XLA's float32 -> float64 cast flushes subnormals to zero
                col = torch.where(col.abs() < torch.finfo(col.dtype).tiny,
                                  0.0, col)
            k = torch.where(out.valid[perm], col[perm].to(torch.float64),
                            float("inf"))
            perm = perm[stable_radix_argsort(float64_sort_key(k),
                                             counter="K7 order by").long()]
        perm = perm[stable_partition_order(out.valid[perm],
                                           counter="K1 order by").long()]
        return EventBatch(ts=out.ts[perm],
                          cols={k: v[perm] for k, v in out.cols.items()},
                          valid=out.valid[perm], types=out.types[perm])

    def _limit_chunk(self, out: EventBatch) -> EventBatch:
        """The JAX `_limit_chunk`: each valid lane's rank among the valid
        lanes (a running count, K5b) against OFFSET and LIMIT."""
        counts, _ = running_count(out.valid, counter="K5b limit")
        rank = counts - 1
        keep = out.valid
        if self.offset is not None:
            keep = keep & (rank >= self.offset)
            rank = rank - self.offset
        if self.limit is not None:
            keep = keep & (rank < self.limit)
        return dataclasses.replace(out, valid=keep)


def _uuid_placeholder(s: Scope) -> torch.Tensor:
    """A UUID() output's device lanes: code 0 until the host fills in a
    uuid4 per event."""
    ts = s.ts[s.default_frame]
    return torch.zeros(ts.shape, dtype=torch.int32, device=ts.device)
