"""Expression AST -> column functions over torch tensors (counterpart of
siddhi_tpu/ops/expr_compile.py; this slice ports variables, constants,
comparisons, arithmetic, and/or/not, `is null` and the one function the
pattern rewrite needs, `ifThenElse`).

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
from ..extension.registry import Registry
from ..query_api.definition import AttributeType
from ..query_api.expression import (
    And,
    AttributeFunction,
    Compare,
    CompareOp,
    Constant,
    Expression,
    IsNull,
    MathExpression,
    MathOp,
    Not,
    Or,
    Variable,
)


class Scope:
    """Column environment: maps (stream_ref, attr) -> tensor[B], plus the
    timestamps and validity of each frame, and per-lane values the query
    runtime hands to the selector (`extras`, e.g. sliding extrema)."""

    def __init__(self) -> None:
        self.frames: dict[str, dict] = {}
        self.valids: dict[str, torch.Tensor] = {}
        self.ts: dict[str, torch.Tensor] = {}
        self.extras: dict[str, torch.Tensor] = {}
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
class CompiledExpr:
    """A typed column function."""

    fn: Callable[[Scope], torch.Tensor]
    type: AttributeType

    def __call__(self, scope: Scope) -> torch.Tensor:
        return self.fn(scope)


class TypeResolver:
    """Resolves Variable -> (frame_ref, attr, AttributeType)."""

    def __init__(self, frames: dict, default_frame: Optional[str] = None,
                 codecs: Optional[dict] = None) -> None:
        self.frames = frames
        self.default_frame = default_frame or (next(iter(frames)) if frames
                                               else None)
        self.codecs: dict[str, StreamCodec] = codecs or {}

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

    if (isinstance(expr, AttributeFunction) and not expr.namespace
            and expr.name == "ifThenElse"):
        return _compile_if_then_else(expr, resolver, registry)

    raise SiddhiAppCreationError(
        f"expression node {type(expr).__name__} is not yet ported to "
        "siddhi_tpu_torch")


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


def _compile_if_then_else(expr: AttributeFunction, resolver: TypeResolver,
                          registry: Registry) -> CompiledExpr:
    """`ifThenElse(cond, a, b)`, as siddhi_tpu/ops/builtin_functions.py
    types it: numeric branches promote, other branches must share a type.
    Patterns compile `e1[last].attr` to a chain of these."""
    args = [compile_expression(p, resolver, registry)
            for p in expr.parameters]
    if len(args) != 3 or args[0].type != AttributeType.BOOL:
        raise SiddhiAppCreationError("ifThenElse(bool, then, else)")
    c, a, b = args
    if a.type != b.type:
        if dtypes.is_numeric(a.type) and dtypes.is_numeric(b.type):
            out_t = dtypes.promote(a.type, b.type)
        else:
            raise SiddhiAppCreationError(
                "ifThenElse branches must share a type")
    else:
        out_t = a.type
    return CompiledExpr(
        lambda s: torch.where(c(s), _cast(torch.as_tensor(a(s)), out_t),
                              _cast(torch.as_tensor(b(s)), out_t)), out_t)


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
