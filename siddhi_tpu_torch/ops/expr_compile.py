"""Expression AST -> column functions over torch tensors (counterpart of
siddhi_tpu/ops/expr_compile.py): variables, constants, comparisons,
arithmetic, and/or/not, `is null`, `expr in Table` with its index plan,
the registry's scalar functions (ops/builtin_functions.py) and the
planner-resolved `eventTimestamp`, `currentTimeMillis` and `sizeOfSet`
over a forwarded unionSet column.

Every node gets a static AttributeType; math promotes int<long<float<double
and comparisons across numeric types promote before comparing, as in the
reference package. Constants evaluate to 0-d CPU tensors, which torch
broadcasts against tensors on any device without a copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core import dtypes
from ..core.dtypes import NULL_CODE
from ..core.event import StreamCodec
from ..errors import SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..query_api.definition import AttributeType
from ..query_api.expression import (
    And,
    AttributeFunction,
    Compare,
    CompareOp,
    Constant,
    Expression,
    In,
    IsNull,
    MathExpression,
    MathOp,
    Not,
    Or,
    Variable,
)


class Scope:
    """Column environment: maps (stream_ref, attr) -> tensor[B], plus the
    timestamps and validity of each frame, and what the runtime hands to
    the compiled functions (`extras`): the step's `now` (a Python int),
    sliding extrema, and the table states, indexes and membership probes
    of `in` conditions."""

    def __init__(self) -> None:
        self.frames: dict[str, dict] = {}
        self.valids: dict[str, torch.Tensor] = {}
        self.ts: dict[str, torch.Tensor] = {}
        self.extras: dict[str, object] = {}
        self.default_frame: Optional[str] = None

    def add_frame(self, ref: str, cols: dict, ts: torch.Tensor,
                  valid: torch.Tensor, default: bool = False) -> None:
        self.frames[ref] = cols
        self.ts[ref] = ts
        self.valids[ref] = valid
        if default or self.default_frame is None:
            self.default_frame = ref

    def col(self, ref: Optional[str], attr: str) -> torch.Tensor:
        if ref is not None:
            return self.frames[ref][attr]
        if self.default_frame and attr in self.frames[self.default_frame]:
            return self.frames[self.default_frame][attr]
        hits = [f for f in self.frames.values() if attr in f]
        if len(hits) != 1:
            raise KeyError(attr)
        return hits[0][attr]


@dataclass
class ScalarFunction:
    """SPI for scalar functions: `make(arg_types)` returns (fn,
    return_type); fn maps the argument tensors to the result tensor."""

    make: Callable


@dataclass
class CompiledExpr:
    """A typed column function."""

    fn: Callable[[Scope], torch.Tensor]
    type: AttributeType

    def __call__(self, scope: Scope) -> torch.Tensor:
        return self.fn(scope)


class TypeResolver:
    """Resolves Variable -> (frame_ref, attr, AttributeType)."""

    def __init__(self, frames: dict, default_frame: Optional[str] = None,
                 codecs: Optional[dict] = None,
                 set_projections: Optional[dict] = None) -> None:
        self.frames = frames
        self.default_frame = default_frame or (next(iter(frames)) if frames
                                               else None)
        self.codecs: dict[str, StreamCodec] = codecs or {}
        #: frame ref -> attributes carrying a forwarded unionSet set-size
        #: projection: the only columns sizeOfSet() reads downstream
        self.set_projections: dict = set_projections or {}

    def is_set_projection(self, frame_ref: Optional[str], attr: str) -> bool:
        ref = frame_ref or self.default_frame
        return attr in self.set_projections.get(ref, ())

    def resolve(self, v: Variable):
        if v.stream_id is not None:
            frame = self.frames.get(v.stream_id)
            if frame is None or v.attribute not in frame:
                raise SiddhiAppCreationError(
                    f"unknown attribute {v.stream_id}.{v.attribute}")
            return v.stream_id, v.attribute, frame[v.attribute]
        if self.default_frame and v.attribute in self.frames[self.default_frame]:
            return None, v.attribute, self.frames[self.default_frame][v.attribute]
        hits = [(ref, f[v.attribute]) for ref, f in self.frames.items()
                if v.attribute in f]
        if len(hits) == 1:
            return hits[0][0], v.attribute, hits[0][1]
        raise SiddhiAppCreationError(
            f"attribute {v.attribute!r} is "
            f"{'ambiguous' if hits else 'undefined'}")

    def string_code(self, frame_ref: Optional[str], attr: str, s: str) -> int:
        """Intern a string constant so device comparison is code equality."""
        ref = frame_ref or self.default_frame
        codec = self.codecs.get(ref)
        if codec is None or attr not in codec.string_tables:
            raise SiddhiAppCreationError(
                f"no string table for {ref}.{attr}; string comparison "
                "unsupported here")
        return codec.string_tables[attr].encode(s)


_CONST_TYPES = {
    "int": AttributeType.INT, "long": AttributeType.LONG,
    "float": AttributeType.FLOAT, "double": AttributeType.DOUBLE,
    "bool": AttributeType.BOOL, "string": AttributeType.STRING,
    "time": AttributeType.LONG,
}


def compile_expression(expr: Expression, resolver: TypeResolver,
                       registry: Registry) -> CompiledExpr:
    """Recursively compile an AST node into a CompiledExpr."""
    if isinstance(expr, Constant):
        t = _CONST_TYPES[expr.type_name]
        if t == AttributeType.STRING:
            # bare string constant: comparisons intern it (_compile_compare)
            return CompiledExpr(lambda s, v=expr.value: v, t)
        const = torch.tensor(expr.value, dtype=dtypes.device_dtype(t))
        return CompiledExpr(lambda s, c=const: c, t)

    if isinstance(expr, Variable):
        ref, attr, t = resolver.resolve(expr)
        return CompiledExpr(lambda s, r=ref, a=attr: s.col(r, a), t)

    if isinstance(expr, MathExpression):
        return _compile_math(expr, resolver, registry)

    if isinstance(expr, Compare):
        return _compile_compare(expr, resolver, registry)

    if isinstance(expr, (And, Or)):
        l = compile_expression(expr.left, resolver, registry)
        r = compile_expression(expr.right, resolver, registry)
        _require_bool(l, r)
        if isinstance(expr, And):
            return CompiledExpr(lambda s: l(s) & r(s), AttributeType.BOOL)
        return CompiledExpr(lambda s: l(s) | r(s), AttributeType.BOOL)

    if isinstance(expr, Not):
        e = compile_expression(expr.expression, resolver, registry)
        _require_bool(e)
        return CompiledExpr(lambda s: ~e(s), AttributeType.BOOL)

    if isinstance(expr, IsNull):
        return _compile_is_null(expr, resolver, registry)

    if isinstance(expr, In):
        return _compile_in(expr, resolver, registry)

    if isinstance(expr, AttributeFunction):
        return _compile_function(expr, resolver, registry)

    raise SiddhiAppCreationError(
        f"cannot compile expression node {type(expr).__name__}")


def _require_bool(*exprs: CompiledExpr) -> None:
    for e in exprs:
        if e.type != AttributeType.BOOL:
            raise SiddhiAppCreationError(
                f"logical operator requires bool operands, got {e.type}")


def _cast(x: torch.Tensor, t: AttributeType) -> torch.Tensor:
    return x.to(dtypes.device_dtype(t))


def _compile_math(expr: MathExpression, resolver: TypeResolver,
                  registry: Registry) -> CompiledExpr:
    l = compile_expression(expr.left, resolver, registry)
    r = compile_expression(expr.right, resolver, registry)
    out_t = dtypes.promote(l.type, r.type)
    integral = out_t in (AttributeType.INT, AttributeType.LONG)
    if expr.op == MathOp.DIVIDE:
        if integral:
            # Java integer division truncates toward zero; x/0 lanes are 0
            def div(s):
                a, b = _cast(l(s), out_t), _cast(r(s), out_t)
                q = torch.div(a, torch.where(b != 0, b, 1),
                              rounding_mode="trunc")
                return torch.where(b != 0, q, 0)
            return CompiledExpr(div, out_t)
        return CompiledExpr(lambda s: _cast(l(s), out_t) / _cast(r(s), out_t),
                            out_t)
    if expr.op == MathOp.MOD:
        # Java % truncates toward zero (torch.fmod), unlike floored remainder
        if integral:
            def mod(s):
                a, b = _cast(l(s), out_t), _cast(r(s), out_t)
                m = torch.fmod(a, torch.where(b != 0, b, 1))
                return torch.where(b != 0, m, 0)
            return CompiledExpr(mod, out_t)
        return CompiledExpr(
            lambda s: torch.fmod(_cast(l(s), out_t), _cast(r(s), out_t)),
            out_t)
    ops = {MathOp.ADD: torch.add, MathOp.SUBTRACT: torch.sub,
           MathOp.MULTIPLY: torch.mul}
    op = ops[expr.op]
    return CompiledExpr(lambda s: op(_cast(l(s), out_t), _cast(r(s), out_t)),
                        out_t)


_CMP = {
    CompareOp.EQUAL: torch.eq,
    CompareOp.NOT_EQUAL: torch.ne,
    CompareOp.GREATER_THAN: torch.gt,
    CompareOp.GREATER_THAN_EQUAL: torch.ge,
    CompareOp.LESS_THAN: torch.lt,
    CompareOp.LESS_THAN_EQUAL: torch.le,
}


def _compile_compare(expr: Compare, resolver: TypeResolver,
                     registry: Registry) -> CompiledExpr:
    lc, rc = expr.left, expr.right
    l_str_const = isinstance(lc, Constant) and lc.type_name == "string"
    r_str_const = isinstance(rc, Constant) and rc.type_name == "string"
    op = _CMP[expr.op]
    if l_str_const or r_str_const:
        var_side, const_side = (rc, lc) if l_str_const else (lc, rc)
        if not isinstance(var_side, Variable):
            raise SiddhiAppCreationError(
                "string comparison requires an attribute on one side")
        ref, attr, t = resolver.resolve(var_side)
        if t != AttributeType.STRING:
            raise SiddhiAppCreationError(
                f"cannot compare {t} with string constant")
        if expr.op not in (CompareOp.EQUAL, CompareOp.NOT_EQUAL):
            raise SiddhiAppCreationError(
                "string constants support only ==/!= on device")
        code = resolver.string_code(ref, attr, const_side.value)
        return CompiledExpr(lambda s, c=code: op(s.col(ref, attr), c),
                            AttributeType.BOOL)

    l = compile_expression(lc, resolver, registry)
    r = compile_expression(rc, resolver, registry)
    if l.type == AttributeType.STRING and r.type == AttributeType.STRING:
        if expr.op not in (CompareOp.EQUAL, CompareOp.NOT_EQUAL):
            raise SiddhiAppCreationError(
                "string ordering comparisons unsupported on device")
        return CompiledExpr(lambda s: op(l(s), r(s)), AttributeType.BOOL)
    if l.type == AttributeType.BOOL or r.type == AttributeType.BOOL:
        if l.type != r.type:
            raise SiddhiAppCreationError(
                f"cannot compare {l.type} with {r.type}")
        return CompiledExpr(lambda s: op(l(s), r(s)), AttributeType.BOOL)
    out_t = dtypes.promote(l.type, r.type)
    return CompiledExpr(lambda s: op(_cast(l(s), out_t), _cast(r(s), out_t)),
                        AttributeType.BOOL)


def _compile_is_null(expr: IsNull, resolver: TypeResolver,
                     registry: Registry) -> CompiledExpr:
    if expr.stream_id is not None:
        sid = expr.stream_id
        return CompiledExpr(lambda s: ~s.valids[sid], AttributeType.BOOL)
    inner = expr.expression
    if isinstance(inner, Variable):
        ref, attr, t = resolver.resolve(inner)
        if t == AttributeType.STRING:
            return CompiledExpr(lambda s: s.col(ref, attr) == NULL_CODE,
                                AttributeType.BOOL)
        # numeric columns carry no per-attribute null on device; null only
        # arises from invalid frames
        if ref is not None:
            return CompiledExpr(
                lambda s: ~s.valids[ref] if ref in s.valids
                else torch.zeros_like(s.col(ref, attr), dtype=torch.bool),
                AttributeType.BOOL)
        return CompiledExpr(
            lambda s: torch.zeros_like(s.col(ref, attr), dtype=torch.bool),
            AttributeType.BOOL)
    e = compile_expression(inner, resolver, registry)
    return CompiledExpr(lambda s: torch.zeros_like(e(s), dtype=torch.bool),
                        AttributeType.BOOL)


def _compile_in(expr: In, resolver: TypeResolver,
                registry: Registry) -> CompiledExpr:
    """`expr in T`: the query runtime puts a membership probe under
    scope.extras['in:<T>']. A single `T.attr == <stream expr>` of one type
    on both sides also carries an index plan, which the probe answers from
    the table's sorted index when the attribute is indexed."""
    inner = (compile_expression(expr.expression, resolver, registry)
             if expr.expression else None)
    source = expr.source_id

    eq_plan = None
    e = expr.expression
    if isinstance(e, Compare) and e.op == CompareOp.EQUAL:
        for tside, sside in ((e.left, e.right), (e.right, e.left)):
            if not (isinstance(tside, Variable)
                    and tside.stream_id == source):
                continue
            if _references_frame(sside, source, resolver):
                continue
            if isinstance(sside, Constant) and sside.type_name == "string":
                # interned against the table attribute's string table
                try:
                    code = resolver.string_code(source, tside.attribute,
                                                sside.value)
                except SiddhiAppCreationError:
                    break

                def const_code(s, c=code):
                    ts = s.ts[s.default_frame]
                    return torch.full(ts.shape, c, dtype=torch.int32,
                                      device=ts.device)

                sc = CompiledExpr(const_code, AttributeType.STRING)
            else:
                try:
                    sc = compile_expression(sside, resolver, registry)
                except SiddhiAppCreationError:
                    break
            # the sorted-copy probe compares in the table column's dtype:
            # mixed-type compares keep the exhaustive path, which promotes
            try:
                _, _, t_type = resolver.resolve(tside)
            except Exception:
                break
            if sc.type != t_type:
                break
            eq_plan = (tside.attribute, sc)
            break

    def fn(s: Scope):
        probe = s.extras.get(f"in:{source}")
        if probe is None:
            raise SiddhiAppCreationError(
                f"`in {source}` used outside a table-aware context")
        return probe(s, inner, eq_plan)

    return CompiledExpr(fn, AttributeType.BOOL)


#: key columns one equality launch compares (csrc/k13_keys.cuh MAX_KEYS)
MAX_EQUALITY_KEYS = 4
#: planner built-ins that read the default frame's context, not columns
_CONTEXT_FUNCTIONS = ("eventTimestamp", "currentTimeMillis")


def _frames_read(e: Expression, resolver: TypeResolver) -> Optional[set]:
    """The frames an elementwise expression of variables, constants,
    arithmetic and functions of arguments reads (an unqualified variable
    counts for the frame it resolves to); None for any other node."""
    if isinstance(e, Constant):
        return set()
    if isinstance(e, Variable):
        try:
            ref, _, _ = resolver.resolve(e)
        except SiddhiAppCreationError:
            return None
        return {ref or resolver.default_frame}
    if isinstance(e, MathExpression):
        parts = (e.left, e.right)
    elif (isinstance(e, AttributeFunction) and e.parameters
          and (e.namespace or e.name not in _CONTEXT_FUNCTIONS)):
        parts = e.parameters
    else:
        return None
    out: set = set()
    for p_ in parts:
        f = _frames_read(p_, resolver)
        if f is None:
            return None
        out |= f
    return out


def equality_key_plan(cond: Expression, table_ref: str, out_refs,
                      resolver: TypeResolver, registry: Registry):
    """The key columns of an ON condition that is a conjunction of at most
    MAX_EQUALITY_KEYS `==` compares, each between a side that reads only
    the table frame and a side that reads none of it and at least one
    output frame (`out_refs`), both of one type: [(table side, output
    side)] as CompiledExprs, or None for any other condition. As the `in`
    index plan, a mixed-type compare declines (the compiled `==` promotes
    it)."""
    conj, stack = [], [cond]
    while stack:
        e = stack.pop()
        if isinstance(e, And):
            stack += [e.right, e.left]
        else:
            conj.append(e)
    if len(conj) > MAX_EQUALITY_KEYS:
        return None
    plan = []
    for e in conj:
        if not (isinstance(e, Compare) and e.op == CompareOp.EQUAL):
            return None
        for tside, oside in ((e.left, e.right), (e.right, e.left)):
            ft = _frames_read(tside, resolver)
            fo = _frames_read(oside, resolver)
            if ft == {table_ref} and fo and fo <= set(out_refs):
                break
        else:
            return None
        try:
            tc = compile_expression(tside, resolver, registry)
            oc = compile_expression(oside, resolver, registry)
        except SiddhiAppCreationError:
            return None
        if tc.type != oc.type:
            return None
        plan.append((tc, oc))
    return plan


def _references_frame(e: Expression, frame: str,
                      resolver: TypeResolver) -> bool:
    if isinstance(e, Variable):
        if e.stream_id is not None:
            return e.stream_id == frame
        # an unqualified variable may resolve to the table frame
        try:
            ref, _, _ = resolver.resolve(e)
        except Exception:
            return True  # unresolvable: decline the plan
        return ref == frame
    for attr in ("left", "right", "expression"):
        sub = getattr(e, attr, None)
        if isinstance(sub, Expression) and _references_frame(sub, frame,
                                                             resolver):
            return True
    for p_ in getattr(e, "parameters", ()) or ():
        if isinstance(p_, Expression) and _references_frame(p_, frame,
                                                            resolver):
            return True
    return False


def _compile_function(expr: AttributeFunction, resolver: TypeResolver,
                      registry: Registry) -> CompiledExpr:
    # planner-resolved built-ins: they read the batch context, not columns
    if not expr.namespace and expr.name == "eventTimestamp":
        if expr.parameters:
            sid = expr.parameters[0]
            if isinstance(sid, Variable):
                return CompiledExpr(lambda s, r=sid.attribute: s.ts[r],
                                    AttributeType.LONG)
        return CompiledExpr(lambda s: s.ts[s.default_frame],
                            AttributeType.LONG)
    if not expr.namespace and expr.name == "currentTimeMillis":
        def now(s):
            ts = s.ts[s.default_frame]
            return torch.full(ts.shape, int(s.extras["now"]),
                              dtype=torch.int64, device=ts.device)
        return CompiledExpr(now, AttributeType.LONG)
    # sizeOfSet over a forwarded raw-unionSet column: the lane carries the
    # exact distinct count (a LONG set-size projection); accepted only with
    # unionSet provenance, an ordinary LONG column raises
    if (not expr.namespace and expr.name == "sizeOfSet"
            and len(expr.parameters) == 1
            and isinstance(expr.parameters[0], Variable)):
        v = expr.parameters[0]
        ref, attr, t = resolver.resolve(v)
        if t == AttributeType.LONG and resolver.is_set_projection(ref, attr):
            dt = dtypes.device_dtype(AttributeType.LONG)
            return CompiledExpr(
                lambda s, r=ref, a=attr, d=dt: s.col(r, a).to(d),
                AttributeType.LONG)
        raise SiddhiAppCreationError(
            f"sizeOfSet({v.attribute}): the column does not carry a "
            "unionSet set-size projection — only a forwarded `select "
            "unionSet(x) as s` output (auto-defined stream or insert-into "
            "table) is readable by sizeOfSet downstream; an ordinary "
            f"{t.value} attribute would silently forward its value")

    args = tuple(compile_expression(p, resolver, registry)
                 for p in expr.parameters)
    impl = registry.lookup(ExtensionKind.FUNCTION, expr.namespace, expr.name)
    if impl is None:
        raise SiddhiAppCreationError(
            f"no function extension {expr.full_name!r} "
            f"(aggregators are valid only in SELECT)")
    assert isinstance(impl, ScalarFunction)
    fn, ret_t = impl.make(tuple(a.type for a in args))
    return CompiledExpr(lambda s: fn(*(a(s) for a in args)), ret_t)
