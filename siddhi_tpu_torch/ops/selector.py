"""Compiled SELECT (counterpart of siddhi_tpu/ops/selector.py; this slice
ports the projection path, the grouped path keyed by one string code, the
hashed grouped path (K3 -> K4 -> K5), aggregates without GROUP BY, custom
aggregators with their own state (distinctCount), and HAVING). ORDER BY /
LIMIT / OFFSET raise "not yet ported".

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
from ..query_api.execution import OutputAttribute, Selector
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
    grouped_scan_fused,
    hash_columns,
    init_key_table,
    key_lookup_or_insert,
    ungrouped_scan_fused,
)

AGG_FRAME = "__agg__"


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
    """Selector state: per aggregate, in select order, one [K] value tensor
    per sum component (they share `shared_epoch`) or a custom aggregator's
    state tuple; the key table of the hashed path; the RESET epoch
    counter."""

    groups: list
    key_table: Optional[KeyTable]
    epoch: torch.Tensor  # int32 scalar
    shared_epoch: Optional[torch.Tensor] = None  # int32[K]


class CompiledSelector:
    """Plans one Selector against an input frame layout."""

    def __init__(self, selector: Selector, resolver: TypeResolver,
                 registry: Registry, group_capacity: int,
                 select_all_attrs: Optional[list] = None):
        if selector.order_by or selector.limit is not None \
                or selector.offset is not None:
            raise SiddhiAppCreationError(
                "order by / limit / offset are not yet ported to "
                "siddhi_tpu_torch")
        self.group_capacity = group_capacity
        attrs = selector.attributes
        if not attrs:
            if select_all_attrs is None:
                raise SiddhiAppCreationError(
                    "select * needs input attribute list")
            attrs = tuple(OutputAttribute(n, Variable(n))
                          for n, _ in select_all_attrs)
        agg_nodes: list = []
        rewritten = [(a.rename, _rewrite_aggregators(a.expression, registry,
                                                     agg_nodes))
                     for a in attrs]

        self.agg_specs = []
        for slot_name, node in agg_nodes:
            factory = registry.require(ExtensionKind.AGGREGATOR,
                                       node.namespace, node.name)
            assert isinstance(factory, AggregatorFactory)
            args = [compile_expression(p, resolver, registry)
                    for p in node.parameters]
            spec = factory.make(tuple(a.type for a in args))
            self.agg_specs.append((slot_name, spec, args))

        frames = dict(resolver.frames)
        frames[AGG_FRAME] = {slot: spec.return_type
                             for slot, spec, _ in self.agg_specs}
        self.resolver = TypeResolver(frames, resolver.default_frame,
                                     resolver.codecs)
        self.out_exprs: list[tuple[str, CompiledExpr]] = [
            (name, compile_expression(e, self.resolver, registry))
            for name, e in rewritten]
        self.out_types = {name: ce.type for name, ce in self.out_exprs}

        self.group_vars = [resolver.resolve(v) for v in selector.group_by]
        self.use_string_code = (len(self.group_vars) == 1
                                and self.group_vars[0][2] == AttributeType.STRING)
        self.needs_key_table = bool(self.group_vars) and not self.use_string_code

        out_frames = dict(frames)
        out_frames["__out__"] = dict(self.out_types)
        out_resolver = TypeResolver(out_frames, "__out__", resolver.codecs)
        self.having = (compile_expression(selector.having, out_resolver,
                                          registry)
                       if selector.having is not None else None)

    def init_state(self, device) -> SelectorState:
        K = self.group_capacity if self.group_vars else 1
        groups = []
        any_fused = False
        for _, spec, _ in self.agg_specs:
            if spec.custom_scan is not None:
                groups.append(spec.init_custom(
                    self.group_capacity, device,
                    grouped=bool(self.group_vars)))
                continue
            for comp in spec.components:
                groups.append(torch.zeros(K, dtype=comp.dtype, device=device))
                any_fused = True
        return SelectorState(
            groups=groups,
            key_table=(init_key_table(K, device) if self.needs_key_table
                       else None),
            epoch=torch.zeros((), dtype=torch.int32, device=device),
            shared_epoch=(torch.zeros(K, dtype=torch.int32, device=device)
                          if any_fused else None))

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
            results: dict[int, torch.Tensor] = {}
            pending = []
            fused_idx, fused_deltas = [], []
            gi = 0
            for slot_name, spec, args in self.agg_specs:
                arg_vals = [a(scope) for a in args] if args else [None]
                if spec.custom_scan is not None:
                    groups[gi], results[gi] = spec.custom_scan(
                        state.groups[gi], slots, arg_vals, sign, data_valid,
                        is_reset, state.epoch, grouped=bool(self.group_vars))
                    pending.append((slot_name, spec, [gi]))
                    gi += 1
                    continue
                comp_gis = []
                for comp in spec.components:
                    fused_idx.append(gi)
                    fused_deltas.append(comp.delta(arg_vals[0],
                                                   sign).contiguous())
                    comp_gis.append(gi)
                    gi += 1
                pending.append((slot_name, spec, comp_gis))
            if fused_idx:
                fused_vals = [state.groups[i] for i in fused_idx]
                if self.group_vars:
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
        out_valid = data_valid
        if self.having is not None:
            scope.frames["__out__"] = out_cols
            scope.valids["__out__"] = out_valid
            scope.ts["__out__"] = chunk.ts
            out_valid = out_valid & self.having(scope)
        out = EventBatch(ts=chunk.ts, cols=out_cols, valid=out_valid,
                         types=types)
        return SelectorState(groups, key_table, new_epoch, shared_epoch), out
