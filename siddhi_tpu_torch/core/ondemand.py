"""On-demand (pull) queries against tables, named windows and aggregations
(counterpart of siddhi_tpu/core/ondemand.py).

`OnDemandQueryRuntime` serves `from T [on cond] select ...`: the store's
rows form one CURRENT chunk, the ON condition masks it, and the selector
runs with `emit_final_per_group`, so aggregates give one row per group,
their final value (the last lane of each group slot, K13b). A named
window is read through its `contents(state, now)`, and so is an
aggregation, as a view that the app runtime has bound to one duration and
its `within` range (core/aggregation.py). `OnDemandCrudRuntime`
serves the write forms through the table output executor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import SiddhiAppCreationError
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.selector import CompiledSelector
from ..query_api.definition import Attribute, AttributeType, StreamDefinition
from ..query_api.execution import OnDemandQuery, OutputAction, OutputStream
from ..query_api.expression import Constant
from .event import Event, EventBatch, StreamCodec
from .table import InMemoryTable, TableOutputExecutor, TableState


class OnDemandQueryRuntime:
    """A compiled pull query over one store (a table or a named window)."""

    def __init__(self, odq: OnDemandQuery, table, ctx, registry) -> None:
        self.odq = odq
        self.table = table
        self.is_window = not isinstance(table, InMemoryTable)
        tid = table.definition.id
        tsp = set(getattr(table, "set_projection_attrs", ()) or ())
        resolver = TypeResolver({tid: dict(table.attr_types)}, tid,
                                {tid: table.codec},
                                {tid: tsp} if tsp else None)
        self.cond = None
        if odq.on_condition is not None:
            self.cond = compile_expression(odq.on_condition, resolver,
                                           registry)
            if self.cond.type != AttributeType.BOOL:
                raise SiddhiAppCreationError("ON condition must be boolean")
        self.selector = CompiledSelector(
            odq.selector, resolver, registry, ctx.effective_group_capacity,
            select_all_attrs=list(table.attr_types.items()),
            emit_final_per_group=True)
        if odq.within_range is not None or odq.per is not None:
            # within/per apply to aggregation stores only
            raise SiddhiAppCreationError(
                f"within/per are not applicable to table {tid!r} "
                "(only to aggregation stores)")
        self.output_definition = StreamDefinition(
            id=f"{tid}_find", attributes=tuple(
                Attribute(n, t) for n, t in self.selector.out_types.items()))
        self.output_codec = StreamCodec(self.output_definition,
                                        ctx.global_strings)

    def run(self, tstate, now: int) -> EventBatch:
        tid = self.table.definition.id
        if self.is_window:
            cols, ts, valid = self.table.contents(tstate, now)
            tstate = TableState(cols=cols, ts=ts, valid=valid)
        C = tstate.ts.shape[0]
        scope = Scope()
        scope.add_frame(tid, tstate.cols, tstate.ts, tstate.valid,
                        default=True)
        scope.extras["now"] = now
        valid = tstate.valid
        if self.cond is not None:
            valid = valid & self.cond(scope)
        chunk = EventBatch(ts=tstate.ts, cols=tstate.cols, valid=valid,
                           types=torch.zeros(C, dtype=torch.int8,
                                             device=tstate.ts.device))
        scope.valids[tid] = valid
        sel = self.selector
        _, out = sel.step(sel.init_state(tstate.ts.device), chunk, scope)
        return out

    def execute(self, now: int = 0) -> list[Event]:
        return self.run(self.table.state, now).to_host_events(
            self.output_codec)


def eval_standalone_insert_row(selector, registry, definition) -> dict:
    """`select <constants> insert into T`: the select list evaluated once,
    its names checked against the table schema; {attr: python value}."""
    empty = TypeResolver({"__out__": {}}, "__out__", {"__out__": None})
    scope = Scope()
    scope.add_frame("__out__", {}, torch.zeros(1, dtype=torch.int64),
                    torch.ones(1, dtype=torch.bool), default=True)
    by_name = {}
    for oa in selector.attributes:
        name = oa.rename or getattr(oa.expression, "attribute", None)
        if name is None:
            raise SiddhiAppCreationError(
                "standalone insert select items need `as` names")
        ce = compile_expression(oa.expression, empty, registry)
        val = ce(scope)
        by_name[name] = (val if isinstance(val, str)
                         else np.asarray(val).reshape(()).item())
    schema = [a.name for a in definition.attributes]
    unknown = set(by_name) - set(schema)
    missing = set(schema) - set(by_name)
    if unknown or missing:
        raise SiddhiAppCreationError(
            f"insert into {definition.id!r}: select list must name every "
            f"table attribute exactly (missing {sorted(missing)}, unknown "
            f"{sorted(unknown)})")
    return by_name


class OnDemandCrudRuntime:
    """The write forms:

      delete T on <cond>
      update T set T.a = <expr>, ... [on <cond>]
      select <constants> update or insert into T [set ...] on <cond>
      select <constants> insert into T
      from Store ... select ... insert into T

    The conditional forms run the table output executor on one lane (their
    conditions and SETs read only the table frame and constants)."""

    def __init__(self, odq: OnDemandQuery, target: InMemoryTable, ctx,
                 registry, source_store=None) -> None:
        self.odq = odq
        self.target = target
        self.action = odq.action
        self.select_runtime = None
        self._out_batch = None
        self._const_row = None
        self.executor = None
        if self.action == OutputAction.INSERT:
            if odq.input_store_id is None:
                by_name = eval_standalone_insert_row(
                    odq.selector, registry, target.definition)
                self._const_row = tuple(
                    by_name[a.name] for a in target.definition.attributes)
                return
            # a select over the source store, its rows inserted
            sel_odq = dataclasses.replace(odq, action=OutputAction.RETURN,
                                          target_id=None)
            self.select_runtime = OnDemandQueryRuntime(
                sel_odq, source_store, ctx, registry)
            return

        dev = ctx.device
        out_types: dict = {}
        out_cols: dict = {}
        if self.action == OutputAction.UPDATE_OR_INSERT:
            # the select list gives the row to insert on no match: constants
            # evaluated once into a one-lane output frame
            empty = TypeResolver({"__out__": {}}, "__out__",
                                 {"__out__": None})
            scope = Scope()
            scope.add_frame("__out__", {}, torch.zeros(1, dtype=torch.int64),
                            torch.ones(1, dtype=torch.bool), default=True)
            for oa in odq.selector.attributes:
                ce = compile_expression(oa.expression, empty, registry)
                name = oa.rename or getattr(oa.expression, "attribute", None)
                if name is None:
                    raise SiddhiAppCreationError(
                        "update-or-insert select items need `as` names")
                out_types[name] = ce.type
                val = ce(scope)
                if isinstance(val, str):  # a bare string constant: intern
                    out_cols[name] = torch.full(
                        (1,), ctx.global_strings.encode(val),
                        dtype=torch.int32, device=dev)
                else:
                    out_cols[name] = torch.broadcast_to(
                        torch.as_tensor(val), (1,)).to(dev)
        out_def = StreamDefinition(id="__out__", attributes=tuple(
            Attribute(n, t) for n, t in out_types.items()))
        out_codec = StreamCodec(out_def, ctx.global_strings)
        out_stream = OutputStream(
            action=self.action, target_id=target.definition.id,
            # a bare `update T set ...` applies to every row
            on_condition=odq.on_condition or Constant(True, "bool"),
            set_attributes=odq.set_attributes)
        self.executor = TableOutputExecutor(target, out_stream, out_types,
                                            out_codec, registry)
        self._out_batch = EventBatch(
            ts=torch.zeros(1, dtype=torch.int64, device=dev), cols=out_cols,
            valid=torch.ones(1, dtype=torch.bool, device=dev),
            types=torch.zeros(1, dtype=torch.int8, device=dev))

    def execute(self, now: int = 0) -> list[Event]:
        if self._const_row is not None:
            self.target.insert_rows([self._const_row], timestamp=now)
            return []
        if self.select_runtime is not None:
            events = self.select_runtime.execute(now)
            self.target.insert_rows([tuple(e.data) for e in events],
                                    timestamp=now)
            return events
        self.executor.apply(self._out_batch)
        return []
