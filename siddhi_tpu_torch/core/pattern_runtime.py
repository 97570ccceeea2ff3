"""Pattern / sequence NFA runtime (counterpart of
siddhi_tpu/core/pattern_runtime.py; reference: core/query/input/stream/state/
— StreamPreStateProcessor.java:46 and the Logical/Count processors).

Per pattern position p there is a fixed-capacity pending table of partial
matches waiting for position p's event (`PendingTable`, ops/pattern.py):
captured frames, start_ts, last_seq, armed_ts, valid. A micro-batch on a
stream junction is matched against every position fed by that stream in
ascending position order, so chains inside one batch complete as the
reference's per-event walk would. For each pending entry the first
qualifying arrival consumes it (K11a, `first_match`): the leg condition,
`arr_seq > last_seq` (pattern) or `arr_seq == last_seq + 1` (sequence:
strict contiguity, a non-matching next arrival kills the entry) and
`within`. Advanced entries are inserted into the next position's free
slots (K11b, `pending_insert`), or emitted past the last position.
`every` re-arms position 0 permanently; a non-every pattern consumes the
start state with its first match. Counts `<m:n>` expand at plan time into
n positions, optional beyond m, with epsilon edges past optional ones.

Positions are plain, logical (and/or), counts, absent (`not X for t`,
killed by a matching X inside its period, completed with an empty frame
when the period passes: `absent_scan`, K11c; heartbeats drive it), the
logical absent (`not X and Y`, with or without a timer) and the leading
absent (`not X for t -> ...`, armed at build or, in playback, at the first
observed instant). `every` re-arms the head over one element, or a whole
group `every ( ... )` one iteration at a time (a gate on the arrival seq);
a mid-pattern `-> every B` keeps its entries armed and advances up to
`pattern_sticky_passes` arrivals per batch, and a mid-pattern group latches
its context entry while an iteration is in flight and releases it on
completion (`release_origin`, K11e). Matches past a pass bound are counted
into `dropped` (`match_count`, K11d). Sequences across several streams run
off a merged junction that taps every source at send time, so strict
contiguity sees the true send order.

A step makes no host synchronisation: `active0`, the drop counter and
every mask stay on the device; the drop counter is read every 64 steps.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..errors import DefinitionNotExistError, SiddhiAppCreationError
from ..extension.registry import Registry
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.join import split_conjuncts
from ..ops.pattern import (BIGSEQ, MAX_EQ, PendingTable, absent_scan,
                           first_match, match_count, match_index,
                           pending_insert,
                           release_origin)
from ..ops.selector import CompiledSelector
from ..query_api.definition import Attribute, AttributeType, StreamDefinition
from ..query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    EveryStateElement,
    LogicalStateElement,
    NextStateElement,
    Query,
    SingleInputStream,
    StateInputStream,
    StateType,
    StreamStateElement,
)
from ..query_api.expression import (Compare, CompareOp, Expression, IsNull,
                                    Variable)
from . import dtypes
from .context import SiddhiAppContext
from .event import EventBatch, StreamCodec
from .query_runtime import QueryCallback, QueryRuntime, output_definition
from .stream import Receiver, StreamJunction

#: steps between two reads of the dropped-partial-match counter
_DROP_CHECK_EVERY = 64

#: junction key for the merged multi-stream sequence step
MERGED_SID = "#merged"

#: column types an equality may compare in the K11a kernel
_EQ_TYPES = (AttributeType.INT, AttributeType.LONG, AttributeType.STRING,
             AttributeType.BOOL)


@dataclass
class _Leg:
    """One stream condition (a logical position has two)."""

    ref: str
    stream_id: str
    filters: tuple  # Expression ASTs


@dataclass
class _Position:
    index: int
    kind: str  # 'normal' | 'absent' | 'logical' | 'notand'
    legs: list  # [_Leg] (1 normal/absent, 2 logical)
    logical_op: Optional[str] = None  # 'and' | 'or'
    wait_ms: Optional[int] = None  # absent
    optional: bool = False  # count occurrences beyond min_count
    #: mid-pattern `every` (`A -> every B`)
    sticky: bool = False

    @property
    def ref(self) -> str:
        return self.legs[0].ref


def _unwrap_chain(elem):
    """EveryStateElement.state may hold a nested ('chain', state, within).
    Returns (inner_element, group_within_ms)."""
    if isinstance(elem, tuple) and elem and elem[0] in ("chain", "seq"):
        return elem[1], elem[2]
    return elem, None


@dataclass
class _EveryGroup:
    """A grouped `every ( ... )`: positions [head, end] form one
    iteration."""

    head: int
    end: int
    within_ms: Optional[int] = None


class _PatternPlan:
    """Flattens the state AST into a linear position list (the JAX
    package's planner, with its errors)."""

    def __init__(self, sis: StateInputStream, ctx) -> None:
        self.every = False
        self.positions: list[_Position] = []
        self.is_sequence = sis.state_type == StateType.SEQUENCE
        self.within_ms = sis.within_ms
        #: base ref -> expanded refs of a count group
        self.count_groups: dict[str, list[str]] = {}
        #: (start_pos, end_pos) spans of zero-minimum count groups, in order
        self.zero_min_spans: list[tuple[int, int]] = []
        #: head every-group (None when the head `every` wraps one element)
        self.head_group: Optional[_EveryGroup] = None
        #: mid-pattern grouped everys, in position order
        self.mid_groups: list[_EveryGroup] = []

        chain = self._linearize(sis.state, top=True)
        first = chain[0]
        if isinstance(first, EveryStateElement):
            self.every = True
            inner, gw = _unwrap_chain(first.state)
            inner_list = self._linearize(inner)
            for e in inner_list:
                self._add_element(e, ctx)
            if len(inner_list) > 1 or gw is not None:
                if self.is_sequence:
                    raise SiddhiAppCreationError(
                        "grouped `every ( ... )` inside a SEQUENCE is not "
                        "supported; use a pattern (`->`) instead")
                self.head_group = _EveryGroup(
                    0, len(self.positions) - 1, gw)
            chain = chain[1:]
        for e in chain:
            if isinstance(e, EveryStateElement):
                inner, gw = _unwrap_chain(e.state)
                inner_list = self._linearize(inner)
                if (len(inner_list) == 1 and gw is None
                        and isinstance(inner_list[0],
                                       (StreamStateElement,
                                        AbsentStreamStateElement))):
                    self._add_element(inner_list[0], ctx)
                    self.positions[-1].sticky = True
                    continue
                if gw is not None:
                    raise SiddhiAppCreationError(
                        "`within` scoped inside a MID-pattern `every (...)` "
                        "is not supported; apply within to the whole "
                        "pattern")
                if self.is_sequence:
                    raise SiddhiAppCreationError(
                        "mid-sequence `every` is not supported (strict "
                        "contiguity and re-arming conflict); use a pattern "
                        "(`->`) instead")
                head = len(self.positions)
                if head == 0:
                    raise SiddhiAppCreationError(
                        "`every` on the first element is the head form — "
                        "write `from every ...`")
                for el in inner_list:
                    self._add_element(el, ctx)
                end = len(self.positions) - 1
                for p in self.positions[head:end + 1]:
                    if p.kind != "normal" or p.optional:
                        raise SiddhiAppCreationError(
                            "mid-pattern `every ( ... )` groups support "
                            "plain stream elements only in this build")
                self.mid_groups.append(_EveryGroup(head, end, None))
                continue
            self._add_element(e, ctx)
        if not self.positions:
            raise SiddhiAppCreationError("empty pattern")
        if self.positions[0].kind == "notand":
            raise SiddhiAppCreationError(
                "logical absent (`not X and Y`) as the first pattern element "
                "is not yet supported")
        if self.is_sequence and any(p.kind == "notand"
                                    for p in self.positions):
            raise SiddhiAppCreationError(
                "logical absent (`not X and Y`) inside a SEQUENCE is not "
                "supported (strict contiguity and an open-ended absence "
                "conflict); use a pattern (`->`) instead")
        if self.is_sequence and any(p.sticky for p in self.positions):
            raise SiddhiAppCreationError(
                "mid-sequence `every` is not supported (strict contiguity "
                "and re-arming conflict); use a pattern (`->`) instead")
        if self.positions[0].sticky:
            raise SiddhiAppCreationError(
                "`every` on the first element is the head form — write "
                "`from every e1=... -> ...`")

    def _linearize(self, state, top: bool = False) -> list:
        if isinstance(state, tuple) and state and state[0] in ("chain", "seq"):
            _tag, inner, within_ms = state
            if within_ms is not None:
                if not top:
                    raise SiddhiAppCreationError(
                        "`within` on a partial pattern group is not "
                        "supported; apply within to the whole pattern")
                if self.within_ms is not None and self.within_ms != within_ms:
                    raise SiddhiAppCreationError(
                        "conflicting `within` scopes")
                self.within_ms = within_ms
            return self._linearize(inner, top=top)
        if isinstance(state, NextStateElement):
            return (self._linearize(state.state)
                    + self._linearize(state.next))
        return [state]

    def _ref_of(self, stream: SingleInputStream, fallback: str) -> str:
        return stream.alias or fallback

    def _add_element(self, e, ctx) -> None:
        i = len(self.positions)
        if isinstance(e, StreamStateElement):
            s = e.stream
            ref = self._ref_of(s, f"_p{i}")
            self.positions.append(_Position(
                i, "normal",
                [_Leg(ref, s.stream_id, tuple(s.handlers.filters))]))
        elif isinstance(e, AbsentStreamStateElement):
            s = e.stream
            if e.waiting_time_ms is None:
                raise SiddhiAppCreationError(
                    "absent patterns need `for <time>` in this build")
            ref = self._ref_of(s, f"_p{i}")
            self.positions.append(_Position(
                i, "absent",
                [_Leg(ref, s.stream_id, tuple(s.handlers.filters))],
                wait_ms=e.waiting_time_ms))
        elif isinstance(e, LogicalStateElement):
            l, r = e.left, e.right
            absent = next((s for s in (l, r)
                           if isinstance(s, AbsentStreamStateElement)), None)
            if absent is not None:
                partner = r if absent is l else l
                if not isinstance(partner, StreamStateElement) or \
                        isinstance(partner, AbsentStreamStateElement):
                    raise SiddhiAppCreationError(
                        "logical absent needs exactly one `not` side and one "
                        "plain stream side")
                if e.logical_type != "and":
                    raise SiddhiAppCreationError(
                        "`not X or Y` is not supported in this build; "
                        "use `not X and Y` or split the query")
                aref = self._ref_of(absent.stream, f"_p{i}a")
                pref = self._ref_of(partner.stream, f"_p{i}b")
                self.positions.append(_Position(
                    i, "notand",
                    [_Leg(aref, absent.stream.stream_id,
                          tuple(absent.stream.handlers.filters)),
                     _Leg(pref, partner.stream.stream_id,
                          tuple(partner.stream.handlers.filters))],
                    wait_ms=absent.waiting_time_ms))
                return
            if not (isinstance(l, StreamStateElement)
                    and isinstance(r, StreamStateElement)):
                raise SiddhiAppCreationError(
                    "logical patterns combine two plain stream conditions")
            lref = self._ref_of(l.stream, f"_p{i}a")
            rref = self._ref_of(r.stream, f"_p{i}b")
            self.positions.append(_Position(
                i, "logical",
                [_Leg(lref, l.stream.stream_id,
                      tuple(l.stream.handlers.filters)),
                 _Leg(rref, r.stream.stream_id,
                      tuple(r.stream.handlers.filters))],
                logical_op=e.logical_type))
        elif isinstance(e, CountStateElement):
            s = e.element.stream
            base = self._ref_of(s, f"_p{len(self.positions)}")
            lo = e.min_count
            hi = e.max_count
            if hi == CountStateElement.ANY:
                # unbounded counts expand to lo + pattern_unbounded_count_extra
                # positions, a documented divergence from the reference's
                # unbounded accumulation (CountPreStateProcessor.java)
                hi = lo + dtypes.config.pattern_unbounded_count_extra
                warnings.warn(
                    f"unbounded pattern count `{base}<{lo}:>` is expanded "
                    f"to at most {hi} occurrences "
                    "(config.pattern_unbounded_count_extra beyond the "
                    "minimum); occurrences past that are NOT captured — "
                    "raise siddhi_tpu_torch.core.dtypes.config."
                    "pattern_unbounded_count_extra if your matches repeat "
                    "further", stacklevel=2)
            if lo < 0 or hi < max(lo, 1):
                raise SiddhiAppCreationError(f"bad count range <{lo}:{hi}>")
            refs = []
            span_start = len(self.positions)
            for k in range(hi):
                idx = len(self.positions)
                ref = f"{base}[{k}]"
                refs.append(ref)
                self.positions.append(_Position(
                    idx, "normal",
                    [_Leg(ref, s.stream_id, tuple(s.handlers.filters))],
                    optional=(lo == 0) or k >= lo))
            self.count_groups[base] = refs
            if lo == 0:
                self.zero_min_spans.append(
                    (span_start, len(self.positions) - 1))
        else:
            raise SiddhiAppCreationError(
                f"unsupported pattern element {type(e).__name__}")


class _RefRewriter:
    """Rewrites e1[0].attr / e1[last].attr / bare count refs onto expanded
    position frames."""

    def __init__(self, count_groups: dict[str, list[str]]):
        self.groups = count_groups

    def rewrite(self, expr):
        if expr is None:
            return None
        if isinstance(expr, Variable):
            sid = expr.stream_id
            if sid in self.groups:
                refs = self.groups[sid]
                if expr.is_last:
                    # e1[last].attr = the newest CAPTURED occurrence: an
                    # ifThenElse chain over frame validity, newest first
                    from ..query_api.expression import AttributeFunction, Not
                    out = Variable(expr.attribute, stream_id=refs[0])
                    for ref in refs[1:]:
                        out = AttributeFunction("", "ifThenElse", (
                            Not(IsNull(stream_id=ref)),
                            Variable(expr.attribute, stream_id=ref),
                            out))
                    return out
                elif expr.stream_index is not None:
                    if expr.stream_index >= len(refs):
                        raise SiddhiAppCreationError(
                            f"{sid}[{expr.stream_index}] exceeds count bound")
                    new_sid = refs[expr.stream_index]
                else:
                    new_sid = refs[0]
                return Variable(expr.attribute, stream_id=new_sid)
            return expr
        kwargs = {}
        for a in ("left", "right", "expression"):
            sub = getattr(expr, a, None)
            if isinstance(sub, Expression):
                kwargs[a] = self.rewrite(sub)
        if hasattr(expr, "parameters") and getattr(expr, "parameters", None):
            return dataclasses.replace(expr, parameters=tuple(
                self.rewrite(p) for p in expr.parameters))
        if kwargs:
            return dataclasses.replace(expr, **kwargs)
        return expr


class PatternState(NamedTuple):
    pending: tuple  # PendingTable per position 1..S-1 (position 0 implicit)
    #: bool 0-d: start state armed (non-every; a head every-group's gate
    #: open)
    active0: torch.Tensor
    seq: torch.Tensor  # int64 0-d: global arrival counter
    sel_state: object
    #: int64 0-d lifetime partial matches dropped (pending-table overflow,
    #: matches past pattern_sticky_passes in one batch)
    dropped: torch.Tensor
    #: int64 0-d leading-absent arming instant (-1 in playback until the
    #: first observed instant); -2^62 without a leading absent
    armed0_ts: torch.Tensor
    #: int64 0-d head every-group gate: the next iteration starts only
    #: with an arrival seq >= gate0_seq
    gate0_seq: torch.Tensor


def _refs_in(expr, resolver: TypeResolver) -> set:
    """Frame refs an expression reads: its variables' frames and the
    frames of stream null checks (`e2 is null`)."""
    out: set = set()

    def walk(e):
        if isinstance(e, Variable):
            ref, _, _ = resolver.resolve(e)
            out.add(ref if ref is not None else resolver.default_frame)
            return
        if isinstance(e, IsNull) and e.stream_id is not None:
            # compiled as the frame's validity; the bare variable it also
            # carries is not read
            out.add(e.stream_id)
            return
        for a in ("left", "right", "expression"):
            sub = getattr(e, a, None)
            if isinstance(sub, Expression):
                walk(sub)
        for p in getattr(e, "parameters", ()) or ():
            if isinstance(p, Expression):
                walk(p)

    walk(expr)
    return out


class PatternQueryRuntime:
    """Runtime for one pattern/sequence query."""

    def __init__(self, query: Query, ctx: SiddhiAppContext, junctions: dict,
                 registry: Registry, name: str,
                 tables: Optional[dict] = None) -> None:
        assert isinstance(query.input_stream, StateInputStream)
        sis: StateInputStream = query.input_stream
        self.query = query
        self.ctx = ctx
        self.name = name
        self.callbacks: list[QueryCallback] = []
        self.output_junction: Optional[StreamJunction] = None
        #: set by the app runtime for delete / update / update-or-insert
        self.table_executor = None
        self.tables = tables or {}
        #: the running step's `now`, for currentTimeMillis()
        self._now = 0
        self.P = dtypes.config.pattern_pending_capacity
        self._steps_run = 0
        self._drop_warned = False

        self.plan = _PatternPlan(sis, ctx)
        plan = self.plan
        # Multi-stream sequences: strict contiguity needs ONE arrival order
        # across the participating streams. Those queries run off a merged
        # junction: the source junctions are tapped at send time, so the
        # true per-event send order survives micro-batching; the merged
        # batch carries a stream tag and each stream's columns under
        # "<sid>::<attr>" names.
        self.merged_mode = plan.is_sequence and len(
            {leg.stream_id for pos in plan.positions for leg in pos.legs}) > 1
        self.merged_junction: Optional[StreamJunction] = None
        self._tag_codes: dict[str, int] = {}

        # --- junctions / frames / codecs ---
        self.junctions: dict[str, StreamJunction] = {}
        frames: dict[str, dict] = {}
        codecs: dict[str, StreamCodec] = {}
        self.ref_types: dict[str, dict] = {}
        for pos in plan.positions:
            for leg in pos.legs:
                j = junctions.get(leg.stream_id)
                if j is None:
                    raise DefinitionNotExistError(
                        f"stream {leg.stream_id!r} is not defined")
                self.junctions[leg.stream_id] = j
                attr_types = {a.name: a.type for a in j.definition.attributes
                              if a.type != AttributeType.OBJECT}
                frames[leg.ref] = attr_types
                codecs[leg.ref] = j.codec
                self.ref_types[leg.ref] = attr_types
        if self.merged_mode:
            self._build_merged_junction()

        # bare stream names resolve when unambiguous
        sid_count: dict[str, int] = {}
        for pos in plan.positions:
            for leg in pos.legs:
                sid_count[leg.stream_id] = sid_count.get(leg.stream_id, 0) + 1
        for sid, n in sid_count.items():
            if n == 1 and sid not in frames:
                for pos in plan.positions:
                    for leg in pos.legs:
                        if leg.stream_id == sid:
                            frames[sid] = frames[leg.ref]
                            codecs[sid] = codecs[leg.ref]

        rewriter = _RefRewriter(plan.count_groups)
        # unionSet-projection provenance per leg frame
        set_projections = {}
        for pos in plan.positions:
            for leg in pos.legs:
                sp = {a.name for a in
                      self.junctions[leg.stream_id].definition.attributes
                      if getattr(a, "set_projection", False)}
                if sp:
                    set_projections[leg.ref] = sp
        self.resolver = TypeResolver(frames, plan.positions[0].legs[0].ref,
                                     codecs, set_projections)

        # --- per-leg conditions (unqualified attrs resolve to the leg's own
        # arrival frame, like the reference's per-state meta) ---
        for pos in plan.positions:
            for leg in pos.legs:
                leg_resolver = TypeResolver(frames, leg.ref, codecs,
                                            set_projections)
                conds = [rewriter.rewrite(f) for f in leg.filters]
                leg.compiled = [compile_expression(c, leg_resolver, registry)
                                for c in conds]
                self._split_leg(pos, leg, conds, leg_resolver, registry)

        # --- selector over all captured frames ---
        select_all = []
        seen = set()
        for pos in plan.positions:
            for leg in pos.legs:
                for n, t in self.ref_types[leg.ref].items():
                    if n not in seen:
                        seen.add(n)
                        select_all.append((n, t))
        sel = query.selector
        sel = dataclasses.replace(
            sel,
            attributes=tuple(dataclasses.replace(
                a, expression=rewriter.rewrite(a.expression))
                for a in sel.attributes),
            having=rewriter.rewrite(sel.having),
            group_by=tuple(rewriter.rewrite(g) for g in sel.group_by))
        self.selector = CompiledSelector(
            sel, self.resolver, registry, ctx.effective_group_capacity,
            select_all_attrs=select_all)
        self.output_definition = output_definition(
            query.output_stream.target_id or f"{name}_out", self.selector)
        self.output_codec = StreamCodec(self.output_definition,
                                        ctx.global_strings)

        # --- state & steps (one per junction, or the merged one, and the
        # heartbeat's) ---
        self.state = self.init_state()
        feeds = [MERGED_SID] if self.merged_mode else list(self.junctions)
        self._steps = {sid: self._make_step(sid) for sid in feeds}
        self._heartbeat_step = self._make_step(None)
        self.has_time_semantics = (
            plan.within_ms is not None
            or (plan.head_group is not None
                and plan.head_group.within_ms is not None)
            or any(p.kind == "absent"
                   or (p.kind == "notand" and p.wait_ms is not None)
                   for p in plan.positions))

    # ---------------------------------------------------------- merged stream

    def _build_merged_junction(self) -> None:
        """One tagged union junction over the sequence's source streams, fed
        by send-order taps so strict contiguity sees the true interleave."""
        participants = []
        for pos in self.plan.positions:
            for leg in pos.legs:
                if leg.stream_id not in participants:
                    participants.append(leg.stream_id)
        self._tag_codes = {sid: i for i, sid in enumerate(participants)}
        attrs = [Attribute("_tag", AttributeType.INT)]
        slots: dict[str, tuple[int, list[int]]] = {}
        pad_of = {AttributeType.STRING: "", AttributeType.BOOL: False}
        pads: list = []
        for sid in participants:
            src_idx = []
            base = len(attrs) - 1  # offset into the padded tail
            for i, a in enumerate(self.junctions[sid].definition.attributes):
                if a.type == AttributeType.OBJECT:
                    continue
                attrs.append(Attribute(f"{sid}::{a.name}", a.type))
                src_idx.append(i)
                pads.append(pad_of.get(a.type, 0))
            slots[sid] = (base, src_idx)
        self.merged_junction = StreamJunction(
            StreamDefinition(id=f"#seq:{self.name}", attributes=tuple(attrs)),
            self.ctx)
        pads = tuple(pads)
        merged = self.merged_junction
        for sid in participants:
            code = self._tag_codes[sid]
            base, src_idx = slots[sid]

            def tap(ts, data, code=code, base=base, src_idx=src_idx):
                tail = list(pads)
                for k, i in enumerate(src_idx):
                    tail[base + k] = data[i]
                merged.stage_row(ts, (code, *tail))

            self.junctions[sid].taps.append(tap)

    def _leg_batch(self, batch: EventBatch, leg: _Leg) -> EventBatch:
        """The leg's view of a step's batch: the batch itself, or on the
        merged sequence step its stream's lanes (tag-masked) with the
        columns de-prefixed."""
        if not self.merged_mode:
            return batch
        code = self._tag_codes[leg.stream_id]
        cols = {a: batch.cols[f"{leg.stream_id}::{a}"]
                for a in self.ref_types[leg.ref]}
        return EventBatch(ts=batch.ts, cols=cols,
                          valid=batch.valid & (batch.cols["_tag"] == code),
                          types=batch.types)

    def _split_leg(self, pos: _Position, leg: _Leg, conds: list,
                   resolver: TypeResolver, registry: Registry) -> None:
        """Split the leg condition for the [B, P] kernels: equalities
        between an arrival column and a captured column of one integral,
        string-code or bool type (`leg.eq`: (arrival attr, captured ref,
        captured attr)), the conjuncts over the arrival alone (`leg.lane`)
        and the rest (`leg.resid`, evaluated as [B, T] mask tiles)."""
        leg.eq, leg.lane, leg.resid = [], [], []
        if pos.index == 0:
            return
        captured = {r for r in self._captured_refs(pos.index) if r != leg.ref}
        arrival = {leg.ref}
        if leg.stream_id not in captured:
            arrival.add(leg.stream_id)

        def side(v: Variable):
            ref, attr, t = resolver.resolve(v)
            ref = ref if ref is not None else leg.ref
            if ref in arrival:
                return "arrival", ref, attr, t
            if ref in captured:
                return "captured", ref, attr, t
            return None

        for cond in conds:
            for conj in split_conjuncts(cond):
                if (len(leg.eq) < MAX_EQ and isinstance(conj, Compare)
                        and conj.op == CompareOp.EQUAL
                        and isinstance(conj.left, Variable)
                        and isinstance(conj.right, Variable)):
                    a, b = side(conj.left), side(conj.right)
                    if a is not None and b is not None and a[0] != b[0] \
                            and a[3] == b[3] and a[3] in _EQ_TYPES:
                        arr, cap = (a, b) if a[0] == "arrival" else (b, a)
                        leg.eq.append((arr[2], cap[1], cap[2]))
                        continue
                ce = compile_expression(conj, resolver, registry)
                if _refs_in(conj, resolver) <= arrival:
                    leg.lane.append(ce)
                else:
                    leg.resid.append(ce)

    # ------------------------------------------------------------------ state

    def _captured_refs(self, pos_index: int) -> list[str]:
        """Frame refs captured before reaching position pos_index (all legs
        of earlier positions; a logical or timed logical-absent position
        also captures its own)."""
        refs = []
        for pos in self.plan.positions[:pos_index]:
            for leg in pos.legs:
                refs.append(leg.ref)
        pos = self.plan.positions[pos_index]
        if pos.kind == "logical" or (pos.kind == "notand"
                                     and pos.wait_ms is not None):
            for leg in pos.legs:
                refs.append(leg.ref)
        return refs

    def _zero_frame(self, ref: str, W: int, dev):
        """(columns, validity, timestamps) of an absent frame, W lanes."""
        return ({n: torch.zeros(W, dtype=dtypes.device_dtype(t), device=dev)
                 for n, t in self.ref_types[ref].items()},
                torch.zeros(W, dtype=torch.bool, device=dev),
                torch.zeros(W, dtype=dtypes.TS_DTYPE, device=dev))

    def _empty_pending(self, pos_index: int) -> PendingTable:
        P = self.P
        dev = self.ctx.device
        frames, fvalid, fts = {}, {}, {}
        for ref in self._captured_refs(pos_index):
            frames[ref], fvalid[ref], fts[ref] = self._zero_frame(ref, P, dev)
        return PendingTable(
            frames=frames, frame_valid=fvalid, frame_ts=fts,
            start_ts=torch.zeros(P, dtype=dtypes.TS_DTYPE, device=dev),
            last_seq=torch.zeros(P, dtype=torch.int64, device=dev),
            armed_ts=torch.zeros(P, dtype=dtypes.TS_DTYPE, device=dev),
            valid=torch.zeros(P, dtype=torch.bool, device=dev),
            leg_done=torch.zeros((P, 2), dtype=torch.bool, device=dev),
            origin=torch.full((P,), -1, dtype=torch.int32, device=dev))

    def init_state(self) -> PatternState:
        S = len(self.plan.positions)
        dev = self.ctx.device
        tg = self.ctx.timestamp_generator
        # a leading absent arms at runtime build; in playback lazily, at
        # the first observed instant (-1 until then)
        armed0 = ((-1 if tg.playback else tg.current_time())
                  if self.plan.positions[0].kind == "absent" else -(2 ** 62))

        def scalar(v, dt):
            return torch.tensor(v, dtype=dt, device=dev)

        return PatternState(
            pending=tuple(self._empty_pending(p) for p in range(1, S)),
            active0=scalar(True, torch.bool),
            seq=scalar(0, torch.int64),
            sel_state=self.selector.init_state(dev),
            dropped=scalar(0, torch.int64),
            armed0_ts=scalar(armed0, torch.int64),
            gate0_seq=scalar(0, torch.int64))

    # ------------------------------------------------------------------- step

    @staticmethod
    def _arrival_scope(leg: _Leg, batch: EventBatch, lanes_2d: bool) -> Scope:
        scope = Scope()
        cols = ({k: v[:, None] for k, v in batch.cols.items()} if lanes_2d
                else batch.cols)
        ts = batch.ts[:, None] if lanes_2d else batch.ts
        valid = batch.valid[:, None] if lanes_2d else batch.valid
        scope.add_frame(leg.ref, cols, ts, valid, default=True)
        # bare stream name alias
        scope.frames.setdefault(leg.stream_id, cols)
        scope.valids.setdefault(leg.stream_id, valid)
        scope.ts.setdefault(leg.stream_id, ts)
        return scope

    def _lane_cond(self, leg: _Leg, batch: EventBatch, exprs) -> torch.Tensor:
        """bool[B]: the batch's valid lanes under conditions over the
        arrival alone."""
        scope = self._arrival_scope(leg, batch, lanes_2d=False)
        scope.extras["now"] = self._now
        m = batch.valid
        for ce in exprs:
            m = m & ce(scope)
        return m

    def _leg_inputs(self, leg: _Leg, batch: EventBatch, pend: PendingTable):
        """The leg's condition against `pend` as the [B, P] kernels take it,
        on the leg's view of the batch: (equality pairs, lane mask,
        residual mask tiles or None), as the JAX step's `_leg_cond`."""
        leg_b = self._leg_batch(batch, leg)
        eq_pairs = [(leg_b.cols[a], pend.frames[ref][c])
                    for a, ref, c in leg.eq]
        residual = None
        if leg.resid:
            def residual(p0, p1):
                scope = self._arrival_scope(leg, leg_b, lanes_2d=True)
                scope.extras["now"] = self._now
                for ref, cols in pend.frames.items():
                    if ref == leg.ref:
                        # a logical position captures its OWN legs in the
                        # table; the leg's frame stays the arriving event
                        continue
                    scope.add_frame(ref,
                                    {n: c[p0:p1] for n, c in cols.items()},
                                    pend.frame_ts[ref][p0:p1],
                                    pend.frame_valid[ref][p0:p1])
                m = None
                for ce in leg.resid:
                    r = ce(scope)
                    m = r if m is None else m & r
                return m
        return eq_pairs, self._lane_cond(leg, leg_b, leg.lane), residual

    @staticmethod
    def _leg_index(indexes: Optional[dict], leg: _Leg, batch: EventBatch,
                   arr_seq: torch.Tensor, lane_ok: torch.Tensor, eq_pairs,
                   counter: str):
        """The leg's index of the batch (`match_index`), which depends on
        the batch side alone: built by the step's first call on the leg
        (its gather counts under that call's `counter`) and kept in the
        step's own `indexes`, keyed by the leg's ref, for the others. None
        without `indexes`: the call builds its own."""
        if indexes is None:
            return None
        if leg.ref not in indexes:
            indexes[leg.ref] = match_index(
                arr_seq, batch.ts, lane_ok, [a for a, _ in eq_pairs],
                counter)
        return indexes[leg.ref]

    def _match(self, leg: _Leg, batch: EventBatch, pend: PendingTable,
               arr_seq: torch.Tensor, last_seq: torch.Tensor, seq0,
               sequence: bool, within: Optional[int],
               live: Optional[torch.Tensor] = None,
               indexes: Optional[dict] = None):
        """K11a over one leg and one pending table (`live` narrows the
        entries, default `pend.valid`): (b_star, matched, killed), as the
        JAX step's mask (`_leg_cond` + `:1197-1226`). Pattern mode probes
        the leg's index of the step's `indexes`."""
        eq_pairs, lane_ok, residual = self._leg_inputs(leg, batch, pend)
        index = None if sequence else self._leg_index(
            indexes, leg, batch, arr_seq, lane_ok, eq_pairs, "K11a")
        return first_match(
            arr_seq, batch.ts, batch.valid, lane_ok, eq_pairs,
            pend.valid if live is None else live, last_seq, pend.start_ts,
            within, sequence, seq0=seq0, residual=residual, index=index)

    def _absent(self, leg: _Leg, batch: EventBatch, pend: PendingTable,
                arr_seq: torch.Tensor, deadline: Optional[torch.Tensor],
                indexes: Optional[dict] = None):
        """K11c over an absent leg: (first kill seq, any before the
        deadline, any at or after it) per entry."""
        eq_pairs, lane_ok, residual = self._leg_inputs(leg, batch, pend)
        return absent_scan(arr_seq, batch.ts, lane_ok, eq_pairs, pend.valid,
                           pend.last_seq, deadline, residual=residual,
                           index=self._leg_index(indexes, leg, batch,
                                                 arr_seq, lane_ok, eq_pairs,
                                                 "K11c"))

    def _count(self, leg: _Leg, batch: EventBatch, pend: PendingTable,
               arr_seq: torch.Tensor, within: Optional[int],
               indexes: Optional[dict] = None) -> torch.Tensor:
        """K11d: the (lane, entry) pairs that still qualify, int64 0-d."""
        eq_pairs, lane_ok, residual = self._leg_inputs(leg, batch, pend)
        return match_count(arr_seq, batch.ts, lane_ok, eq_pairs, pend.valid,
                           pend.last_seq, pend.start_ts, within,
                           residual=residual,
                           index=self._leg_index(indexes, leg, batch,
                                                 arr_seq, lane_ok, eq_pairs,
                                                 "K11d"))

    def _make_step(self, junction_sid: Optional[str]):
        plan = self.plan
        S = len(plan.positions)
        P = self.P
        within = plan.within_ms
        is_seq = plan.is_sequence
        every = plan.every
        sticky_passes = dtypes.config.pattern_sticky_passes
        hg = plan.head_group
        mid_heads = {g.head: g for g in plan.mid_groups}
        merged = junction_sid == MERGED_SID
        # positions where a NEW match may begin: 0, plus the position after
        # each leading zero-minimum count group (`A*, B`); every-groups
        # exclude themselves
        startable = {0}
        _idx = 0
        for _s0, _e0 in plan.zero_min_spans:
            if _s0 != _idx:
                break
            _idx = _e0 + 1
            if _idx < S and not (
                    (hg is not None and _idx <= hg.end)
                    or any(g.head <= _idx <= g.end for g in plan.mid_groups)):
                startable.add(_idx)

        def fed(leg: _Leg) -> bool:
            return junction_sid is not None and (
                merged or leg.stream_id == junction_sid)

        def step(state: PatternState, batch: EventBatch, now: int):
            self._now = now
            pending = list(state.pending)
            active0_box = [state.active0]
            gate0_box = [state.gate0_seq]
            armed0_out = [state.armed0_ts]
            gate_ctx = {"active0": active0_box, "gate0": gate0_box}
            B = batch.ts.shape[0]
            dev = batch.ts.device

            valid64 = batch.valid.to(torch.int64)
            n_valid = valid64.sum()
            # arrival sequence per lane (valid lanes, in lane order)
            lane_rank = torch.cumsum(valid64, 0) - 1
            arr_seq = torch.where(batch.valid, state.seq + lane_rank, BIGSEQ)

            out_blocks = []  # (frames, fvalid, fts, ts, valid)
            drop_acc = [state.dropped]
            #: each leg's index of this batch, built once for the step's
            #: K11a, K11c and K11d calls on the leg; dropped with the step
            indexes = {}

            def with_frame(pend: PendingTable, ref: str, frame):
                """pend's captured frames with `ref` set to frame
                (columns, validity, timestamps)."""
                frames, fvalid, fts = (dict(pend.frames),
                                       dict(pend.frame_valid),
                                       dict(pend.frame_ts))
                frames[ref], fvalid[ref], fts[ref] = frame
                return frames, fvalid, fts

            def advance(target, frames, fvalid, fts, start_ts, last_seq,
                        armed_ts, valid, origin=None):
                self._advance(pending, out_blocks, target, frames, fvalid,
                              fts, start_ts, last_seq, armed_ts, valid,
                              drop_acc, origin, gate_ctx)

            def expire(pend: PendingTable, pos_index: int) -> PendingTable:
                in_head = hg is not None and hg.head < pos_index <= hg.end
                gw = hg.within_ms if in_head else None
                if within is None and gw is None:
                    return pend
                ok = pend.valid
                if within is not None:
                    ok = ok & (now - pend.start_ts <= within)
                if gw is not None:
                    # within scoped INSIDE `every (...)` bounds each
                    # iteration (start_ts = the iteration's first capture)
                    ok = ok & (now - pend.start_ts <= gw)
                died = pend.valid & ~ok
                if in_head:
                    # the in-flight head iteration expired: re-arm the gate
                    active0_box[0] = active0_box[0] | died.any()
                for g in plan.mid_groups:
                    if g.head < pos_index <= g.end:
                        # a died iteration releases its origin context
                        # entry's busy latch (its seq watermark stays)
                        pending[g.head - 1] = release_origin(
                            pending[g.head - 1], died, pend.origin,
                            torch.full_like(pend.last_seq, -BIGSEQ))
                return pend._replace(valid=ok)

            # in place: expire() may clear busy latches on EARLIER tables
            for i in range(len(pending)):
                pending[i] = expire(pending[i], i + 1)

            def begin_at(pi: int, pos: _Position):
                """Start NEW match entries at position pi (0, or a
                startable position past leading zero-min optionals)."""
                leg = pos.legs[0]
                leg_b = self._leg_batch(batch, leg)
                m = self._lane_cond(leg, leg_b, leg.compiled)
                gated = hg is not None and pi == 0
                if not every or gated:
                    # non-every: only the first match consumes the start
                    # state; a grouped head `every`: the gate admits one
                    # iteration at a time, the first qualifying arrival past
                    # the previous completion. A one-hot of that lane, on
                    # the device
                    a0 = active0_box[0]
                    if gated:
                        m = m & (arr_seq >= gate0_box[0])
                    mseq = torch.where(m, arr_seq, BIGSEQ)
                    only = torch.arange(B, device=dev) == torch.argmin(mseq)
                    m = m & only & a0
                    active0_box[0] = a0 & ~m.any()
                frames = {leg.ref: dict(leg_b.cols)}
                fvalid = {leg.ref: m}
                fts = {leg.ref: batch.ts}
                for pos_e in plan.positions[:pi]:  # skipped zero-min refs
                    for lg in pos_e.legs:
                        frames[lg.ref], fvalid[lg.ref], fts[lg.ref] = \
                            self._zero_frame(lg.ref, B, dev)
                advance(pi + 1, frames, fvalid, fts, batch.ts, arr_seq,
                        batch.ts, m)

            def joint_kill(pi: int, pos: _Position):
                # strict kill JOINTLY over both legs of a logical sequence
                # position (the next arrival may match EITHER remaining
                # leg): K11a per leg in sequence mode gives, at the next
                # lane, whether it exists and whether the leg holds there
                pend = pending[pi - 1]
                q_any = torch.zeros_like(pend.valid)
                nxt = torch.zeros_like(pend.valid)
                for lj, lg in enumerate(pos.legs):
                    _, ok, bad = self._match(lg, batch, pend, arr_seq,
                                                pend.last_seq, state.seq,
                                                True, None)
                    q_any = q_any | (ok & ~pend.leg_done[:, lj])
                    nxt = nxt | ok | bad
                killed = nxt & ~q_any & pend.valid
                pending[pi - 1] = pend._replace(valid=pend.valid & ~killed)

            def absent_position(pi: int, pos: _Position):
                # `not X for t` after position 0: a matching X inside the
                # period kills the entry; the deadline passing completes it
                # with an empty frame (time-driven: every step, heartbeats
                # included)
                pend = pending[pi - 1]
                leg = pos.legs[0]
                deadline = pend.armed_ts + pos.wait_ms
                due = pend.valid & (now >= deadline)
                late = None
                if fed(leg):
                    _, killed, late = self._absent(leg, batch, pend, arr_seq,
                                                   deadline, indexes)
                    pend = pend._replace(valid=pend.valid & ~killed)
                    due = due & ~killed
                advance(pi + 1, *with_frame(pend, leg.ref,
                                            self._zero_frame(leg.ref, P, dev)),
                        torch.where(pend.valid, pend.start_ts, 0),
                        pend.last_seq, deadline, due, pend.origin)
                if pos.sticky:
                    # `-> every not X for t`: one fire per elapsed quiet
                    # period, re-armed for the next; a matching arrival
                    # consumes the arming for good, in the current period
                    # (killed above) or past its deadline (`late`: the
                    # completed period still fired)
                    pend = pend._replace(
                        armed_ts=torch.where(due, deadline, pend.armed_ts),
                        valid=pend.valid if late is None
                        else pend.valid & ~late)
                else:
                    pend = pend._replace(valid=pend.valid & ~due)
                pending[pi - 1] = pend

            def timed_notand(pi: int, pos: _Position):
                # `not X for t and Y`: an X inside [armed, armed + t) kills
                # the entry; Y is captured before or after the deadline; the
                # match fires at max(armed + t, Y's ts) once both hold
                a_leg, p_leg = pos.legs
                pend = pending[pi - 1]
                deadline = pend.armed_ts + pos.wait_ms
                if fed(a_leg):
                    _, killed, _ = self._absent(a_leg, batch, pend, arr_seq,
                                                deadline, indexes)
                    pend = pend._replace(valid=pend.valid & ~killed)
                if fed(p_leg):
                    b_star, matched, _ = self._match(
                        p_leg, batch, pend, arr_seq, pend.last_seq,
                        state.seq, False, within,
                        live=pend.valid & ~pend.leg_done[:, 1],
                        indexes=indexes)
                    leg_b = self._leg_batch(batch, p_leg)
                    frames, fvalid, fts = with_frame(pend, p_leg.ref, (
                        {n: torch.where(matched, v[b_star],
                                        pend.frames[p_leg.ref][n])
                         for n, v in leg_b.cols.items()},
                        pend.frame_valid[p_leg.ref] | matched,
                        torch.where(matched, batch.ts[b_star],
                                    pend.frame_ts[p_leg.ref])))
                    leg_done = pend.leg_done.clone()
                    leg_done[:, 1] |= matched
                    pend = pend._replace(
                        frames=frames, frame_valid=fvalid, frame_ts=fts,
                        leg_done=leg_done,
                        last_seq=torch.where(
                            matched,
                            torch.maximum(arr_seq[b_star], pend.last_seq),
                            pend.last_seq))
                due = pend.valid & pend.leg_done[:, 1] & (now >= deadline)
                pending[pi - 1] = pend._replace(valid=pend.valid & ~due)
                advance(pi + 1, *with_frame(pend, a_leg.ref, self._zero_frame(
                            a_leg.ref, P, dev)),
                        torch.where(due, pend.start_ts, 0), pend.last_seq,
                        torch.maximum(deadline, pend.frame_ts[p_leg.ref]),
                        due, pend.origin)

            def leading_absent(pos: _Position):
                # `not X for t -> ...`: the armed period passing quiet
                # advances an empty-frame entry to position 1; a matching
                # arrival before the deadline kills the arming. Playback
                # arms lazily at the first observed instant. Arrivals in
                # the batch of the elapse may match position 1 whatever
                # their order inside it (batch granularity)
                leg = pos.legs[0]
                first_ts = torch.where(batch.valid, batch.ts,
                                       2 ** 62).amin()
                armed0 = torch.where(state.armed0_ts >= 0, state.armed0_ts,
                                     first_ts.clamp(max=now))
                deadline = armed0 + pos.wait_ms
                km_any = km_late = torch.zeros((), dtype=torch.bool,
                                               device=dev)
                kill_ts = torch.full((), -(2 ** 62), dtype=torch.int64,
                                     device=dev)
                if fed(leg):
                    km_all = self._lane_cond(leg, self._leg_batch(batch, leg),
                                             leg.compiled)
                    early = batch.ts < deadline
                    km_any = (km_all & early).any()
                    # a match past the deadline breaks the NEXT period (the
                    # completed one still fires below)
                    km_late = (km_all & ~early).any()
                    kill_ts = torch.where(km_all, batch.ts,
                                          -(2 ** 62)).amax()
                due = active0_box[0] & ~km_any & (now >= deadline)
                frames, fvalid, fts = self._zero_frame(leg.ref, 1, dev)
                d1 = deadline.reshape(1)
                advance(1, {leg.ref: frames}, {leg.ref: fvalid},
                        {leg.ref: fts}, d1, (state.seq - 1).reshape(1), d1,
                        due.reshape(1))
                if every:
                    # `every not X for t -> ...`: re-arm at each fired
                    # boundary; a matching arrival restarts the measurement
                    # from its own timestamp
                    armed0 = torch.where(km_any | km_late, kill_ts,
                                         torch.where(due, deadline, armed0))
                else:
                    active0_box[0] = active0_box[0] & ~km_any & ~due
                armed0_out[0] = armed0

            def notand(pi: int, pos: _Position):
                # `not X and Y` with no timer: an X earlier than the first
                # qualifying Y kills the entry, a Y earlier than any X
                # advances it with the absent frame empty
                pend = pending[pi - 1]
                a_leg, p_leg = pos.legs
                kseq = torch.full((P,), BIGSEQ, dtype=torch.int64,
                                  device=dev)
                if fed(a_leg):
                    kseq, _, _ = self._absent(a_leg, batch, pend, arr_seq,
                                              None, indexes)
                if not fed(p_leg):
                    killed = pend.valid & (kseq < BIGSEQ)
                    pending[pi - 1] = pend._replace(valid=pend.valid & ~killed)
                    return
                b_star, matched, _ = self._match(
                    p_leg, batch, pend, arr_seq, pend.last_seq, state.seq,
                    False, within, indexes=indexes)
                leg_b = self._leg_batch(batch, p_leg)
                pseq = torch.where(matched, arr_seq[b_star], BIGSEQ)
                advanced = pend.valid & (pseq < kseq)
                killed = pend.valid & (kseq < BIGSEQ) & ~advanced
                frames, fvalid, fts = with_frame(pend, p_leg.ref, (
                    {n: v[b_star] for n, v in leg_b.cols.items()}, advanced,
                    batch.ts[b_star]))
                frames[a_leg.ref], fvalid[a_leg.ref], fts[a_leg.ref] = \
                    self._zero_frame(a_leg.ref, P, dev)
                pending[pi - 1] = pend._replace(
                    valid=pend.valid & ~(advanced | killed))
                advance(pi + 1, frames, fvalid, fts,
                        torch.where(advanced, pend.start_ts, 0),
                        torch.where(advanced,
                                    torch.maximum(pseq, pend.last_seq),
                                    pend.last_seq),
                        batch.ts[b_star], advanced, pend.origin)

            def stream_position(pi: int, pos: _Position):
                if (pi in startable and pos.kind == "normal"
                        and fed(pos.legs[0])):
                    # zero-occurrence leading optionals: this arrival may
                    # BEGIN a match here
                    begin_at(pi, pos)
                logical = pos.kind == "logical"
                #: ordering snapshot for pattern-mode logical legs
                pend0 = pending[pi - 1]
                mid_g = mid_heads.get(pi)
                leg_iters = list(enumerate(pos.legs))
                if is_seq and logical:
                    # two passes: the second leg's arrival becomes reachable
                    # (last_seq + 1) only after the first leg matched
                    leg_iters = leg_iters * 2
                if pos.sticky:
                    # mid-pattern `every`: each pass advances one more
                    # qualifying arrival per entry; the rest are counted
                    # into `dropped` below
                    leg_iters = leg_iters * sticky_passes
                for li, leg in leg_iters:
                    if is_seq and logical:
                        joint_kill(pi, pos)
                    if not fed(leg):
                        continue
                    pend = pending[pi - 1]
                    ref_seq = (pend0.last_seq if logical and not is_seq
                               else pend.last_seq)
                    # a mid every-group head with an iteration in flight
                    # (busy latch) does not start another
                    live = (pend.valid & ~pend.leg_done[:, 0]
                            if mid_g is not None else None)
                    b_star, matched, killed = self._match(
                        leg, batch, pend, arr_seq, ref_seq, state.seq,
                        is_seq, within, live, indexes)
                    leg_b = self._leg_batch(batch, leg)
                    if is_seq and not logical:
                        # strict: the next arrival not matching kills
                        pend = pend._replace(valid=pend.valid & ~killed)

                    cap = {n: v[b_star] for n, v in leg_b.cols.items()}
                    cap_ts = batch.ts[b_star]
                    seq_b = torch.maximum(arr_seq[b_star], pend.last_seq)

                    if logical:
                        other = 1 - li
                        # logical positions keep their legs in their own
                        # pending table (both legs are captured refs)
                        new_frames = dict(pend.frames)
                        new_fvalid = dict(pend.frame_valid)
                        new_fts = dict(pend.frame_ts)
                        new_frames[leg.ref] = {
                            n: torch.where(matched, cap[n],
                                           pend.frames[leg.ref][n])
                            for n in cap}
                        new_fvalid[leg.ref] = (pend.frame_valid[leg.ref]
                                               | matched)
                        new_fts[leg.ref] = torch.where(
                            matched, cap_ts, pend.frame_ts[leg.ref])
                        complete = (
                            matched if pos.logical_op == "or"
                            else (matched & pend.leg_done[:, other]))
                        leg_done = pend.leg_done.clone()
                        leg_done[:, li] = leg_done[:, li] | matched
                        pend = pend._replace(
                            frames=new_frames, frame_valid=new_fvalid,
                            frame_ts=new_fts, leg_done=leg_done,
                            last_seq=torch.where(matched, seq_b,
                                                 pend.last_seq))
                        adv_valid = complete
                        ins_frames = pend.frames
                        ins_fvalid = pend.frame_valid
                        ins_fts = pend.frame_ts
                        comp_ts = torch.where(matched, cap_ts, pend.armed_ts)
                        pending[pi - 1] = pend._replace(
                            valid=pend.valid & ~complete)
                        seq_b = torch.maximum(arr_seq[b_star], pend.last_seq)
                    else:
                        # carry captured frames + the new arrival frame into
                        # the advance; pend's own structure is untouched
                        ins_frames, ins_fvalid, ins_fts = with_frame(
                            pend, leg.ref, (cap, matched, cap_ts))
                        adv_valid = matched
                        comp_ts = cap_ts
                        last_seq = torch.where(matched, seq_b, pend.last_seq)
                        if pos.sticky:
                            # the entry stays armed; the bumped last_seq
                            # lets the next pass advance the NEXT arrival
                            pending[pi - 1] = pend._replace(last_seq=last_seq)
                        elif mid_g is not None:
                            # the group-head context entry stays armed but
                            # busy-latched until this iteration completes
                            leg_done = pend.leg_done.clone()
                            leg_done[:, 0] |= matched
                            pending[pi - 1] = pend._replace(
                                leg_done=leg_done, last_seq=last_seq)
                        else:
                            pending[pi - 1] = pend._replace(
                                valid=pend.valid & ~matched)

                    advance(pi + 1, ins_frames, ins_fvalid, ins_fts,
                            torch.where(adv_valid, pend.start_ts, 0),
                            torch.where(adv_valid, seq_b, pend.last_seq),
                            comp_ts, adv_valid,
                            torch.arange(P, dtype=torch.int32, device=dev)
                            if mid_g is not None else pend.origin)

                if pos.sticky and fed(pos.legs[0]):
                    # qualifying arrivals past the per-batch pass bound:
                    # counted as dropped (K11d)
                    drop_acc[0] = drop_acc[0] + self._count(
                        pos.legs[0], batch, pending[pi - 1], arr_seq, within,
                        indexes)

            def process_position(pi: int):
                pos = plan.positions[pi]
                if pos.kind == "absent":
                    if pi == 0:
                        leading_absent(pos)
                    else:
                        absent_position(pi, pos)
                    return
                if pos.kind == "notand" and pos.wait_ms is not None:
                    timed_notand(pi, pos)
                    return
                if not any(fed(leg) for leg in pos.legs):
                    return
                if pi == 0:
                    if pos.kind == "logical":
                        raise SiddhiAppCreationError(
                            "logical conditions at the first pattern "
                            "position are not yet supported")
                    if fed(pos.legs[0]):
                        begin_at(pi, pos)
                elif pos.kind == "notand":
                    notand(pi, pos)
                else:
                    stream_position(pi, pos)

            pi = 0
            while pi < S:
                g = hg if (hg is not None and pi == hg.head) else \
                    mid_heads.get(pi)
                if g is None:
                    process_position(pi)
                    pi += 1
                    continue
                # an every-group: several passes, so iterations chain start
                # -> complete -> re-arm -> start within one batch
                for _ in range(sticky_passes):
                    for pj in range(g.head, g.end + 1):
                        process_position(pj)
                # iteration starts past the pass bound are lost for this
                # batch: counted into `dropped`
                leg0 = plan.positions[g.head].legs[0]
                if fed(leg0):
                    if g is hg:
                        m_left = self._lane_cond(
                            leg0, self._leg_batch(batch, leg0),
                            leg0.compiled) & (arr_seq >= gate0_box[0])
                        # the in-flight iteration's own start is not a
                        # leftover (gate closed: one started)
                        cnt = (m_left.sum(dtype=torch.int64)
                               - (~active0_box[0]).to(torch.int64))
                        drop_acc[0] = drop_acc[0] + cnt.clamp(min=0)
                    else:
                        drop_acc[0] = drop_acc[0] + self._count(
                            leg0, batch, pending[g.head - 1], arr_seq,
                            within, indexes)
                pi = g.end + 1

            new_sel, out = self._emit(state.sel_state, out_blocks, dev)
            return PatternState(
                pending=tuple(pending), active0=active0_box[0],
                seq=state.seq + n_valid, sel_state=new_sel,
                dropped=drop_acc[0], armed0_ts=armed0_out[0],
                gate0_seq=gate0_box[0]), out

        return step

    # ------------------------------------------------------- pending inserts

    def _advance(self, pending: list, out_blocks: list, target_pos: int,
                 frames, fvalid, fts, start_ts, last_seq, armed_ts,
                 valid, drop_acc, origin=None, gate_ctx=None) -> None:
        """Move completed entries to `target_pos` (insert into its waiting
        table, or emit past the last position). Optional count positions
        add an epsilon edge: entries also advance past them at once (the
        epsilon copy and the stay-behind copy are independent entries, a
        documented divergence of the JAX package).

        `origin` carries the spawning context slot of mid every-group
        iteration entries (None: -1); `gate_ctx` lets a crossing of an
        every-group's end re-arm it (the head gate scalars, the mid busy
        latches through K11e)."""
        plan = self.plan
        S = len(plan.positions)
        hg = plan.head_group
        while True:
            if gate_ctx is not None:
                if hg is not None and target_pos == hg.end + 1:
                    # head every-group completion: re-open the gate for
                    # arrivals past the completing event
                    any_c = valid.any()
                    mx = torch.where(valid, last_seq, -BIGSEQ).amax() + 1
                    gate0 = gate_ctx["gate0"][0]
                    gate_ctx["active0"][0] = gate_ctx["active0"][0] | any_c
                    gate_ctx["gate0"][0] = torch.where(
                        any_c, torch.maximum(gate0, mx), gate0)
                for g in plan.mid_groups:
                    if target_pos == g.end + 1 and origin is not None:
                        # mid every-group completion: release the origin
                        # context entries (busy latch, seq watermark)
                        pending[g.head - 1] = release_origin(
                            pending[g.head - 1], valid, origin, last_seq)
                        origin = None
            if target_pos >= S:
                out_blocks.append((frames, fvalid, fts, armed_ts, valid))
                return
            pending[target_pos - 1], n_drop = pending_insert(
                pending[target_pos - 1], frames, fvalid, fts, start_ts,
                last_seq, armed_ts, valid, origin)
            drop_acc[0] = drop_acc[0] + n_drop
            if not plan.positions[target_pos].optional:
                return
            target_pos += 1

    # ------------------------------------------------------------------ emit

    def _emit(self, sel_state, out_blocks, dev):
        """One frame scope over the step's completion blocks, in the order
        they were appended (within a block: lane order — pending-slot order
        for blocks from a later position), then the selector."""
        all_refs = [leg.ref for pos in self.plan.positions
                    for leg in pos.legs]
        if not out_blocks:
            out_blocks = [({}, {}, {},
                           torch.zeros(1, dtype=dtypes.TS_DTYPE, device=dev),
                           torch.zeros(1, dtype=torch.bool, device=dev))]
        scope = Scope()
        tss = torch.cat([b[3] for b in out_blocks])
        valids = torch.cat([b[4] for b in out_blocks])
        for ref in all_refs:
            cols_parts, valid_parts, ts_parts = [], [], []
            for frames, fvalid, fts, ts, v in out_blocks:
                if ref in frames:
                    cols_parts.append(frames[ref])
                    valid_parts.append(fvalid[ref] & v)
                    ts_parts.append(fts[ref])
                else:
                    cols, fv, ft = self._zero_frame(ref, ts.shape[0], dev)
                    cols_parts.append(cols)
                    valid_parts.append(fv)
                    ts_parts.append(ft)
            fv = torch.cat(valid_parts)
            # zero missing frames so projections emit nulls
            cols = {n: torch.where(fv, torch.cat([c[n] for c in cols_parts]),
                                   torch.zeros((), dtype=dtypes.device_dtype(
                                       t), device=dev))
                    for n, t in self.ref_types[ref].items()}
            scope.add_frame(ref, cols, torch.cat(ts_parts), fv,
                            default=(ref == all_refs[0]))
        self._alias_bare_streams(scope)
        scope.extras["now"] = self._now
        chunk = EventBatch(ts=tss, cols={}, valid=valids,
                           types=torch.zeros(tss.shape[0], dtype=torch.int8,
                                             device=dev))
        return self.selector.step(sel_state, chunk, scope)

    def _alias_bare_streams(self, scope: Scope) -> None:
        """Let unambiguous bare stream names resolve to their frame."""
        sid_refs: dict[str, list[str]] = {}
        for pos in self.plan.positions:
            for leg in pos.legs:
                sid_refs.setdefault(leg.stream_id, []).append(leg.ref)
        for sid, refs in sid_refs.items():
            if len(refs) == 1 and sid not in scope.frames:
                ref = refs[0]
                scope.frames[sid] = scope.frames[ref]
                scope.valids[sid] = scope.valids[ref]
                scope.ts[sid] = scope.ts[ref]

    # ---------------------------------------------------------------- runtime

    def on_junction_batch(self, sid: str, batch: EventBatch, now: int) -> None:
        t0 = time.perf_counter_ns()
        self.state, out = self._steps[sid](self.state, batch, now)
        self._distribute(out, now)
        self._after_step()
        self.ctx.statistics.track_latency(self.name,
                                          time.perf_counter_ns() - t0)

    def heartbeat(self, now: int) -> None:
        """Expire `within` entries with no data (an empty batch)."""
        if not self.has_time_semantics:
            return
        j = next(iter(self.junctions.values()))
        empty = EventBatch.empty(j.definition,
                                 dtypes.bucket_capacity(0, j.batch_size),
                                 self.ctx.device)
        self.state, out = self._heartbeat_step(self.state, empty, now)
        self._distribute(out, now)
        self._after_step()

    def _after_step(self) -> None:
        """Every 64 steps, read the dropped-partial-match counter and warn
        once, with the JAX package's overflow text, if it is positive."""
        self._steps_run += 1
        if self._drop_warned or self._steps_run % _DROP_CHECK_EVERY:
            return
        n = int(self.state.dropped)
        if n > 0:
            warnings.warn(
                f"query:{self.name}.pattern_pending_dropped: {n} rows "
                "exceeded a fixed device capacity and were dropped/"
                "overwritten — results may be missing rows; raise the "
                "relevant capacity (see Statistics.report()['overflow'])",
                stacklevel=2)
            self._drop_warned = True

    def _selector_state(self):
        return self.state.sel_state

    _distribute = QueryRuntime._distribute
    _intern_uuid_columns = QueryRuntime._intern_uuid_columns

    def add_callback(self, cb: QueryCallback) -> None:
        self.callbacks.append(cb)


class _PatternSideReceiver(Receiver):
    def __init__(self, runtime: PatternQueryRuntime, sid: str):
        self.runtime = runtime
        self.sid = sid

    def on_batch(self, batch: EventBatch, now: int) -> None:
        self.runtime.on_junction_batch(self.sid, batch, now)
