"""Record stores: the store half of siddhi_tpu/io/record_table.py.

An external store plugs in under `@store(type='name')` as a host-side
`RecordStore` registered with `ExtensionKind.STORE` (reference:
core/table/record/AbstractRecordTable.java). Conditions reach it through
`StoreConditionVisitor`, the compile-once visitor walk of the reference,
so a SQL store can emit a WHERE clause; `PredicateVisitor` is the built-in
fallback that compiles to a Python row predicate. `InMemoryRecordStore`
(a list of row dicts) is registered as `inMemory`.

In the port the stores back the durable duration tables of an incremental
aggregation (`@store` on `define aggregation`, core/aggregation.py). The
record-table runtime itself (`@store` and `@cache` on `define table`, its
output executor, on-demand CRUD and the join and `in` store fallbacks) is
not yet ported; `define table` with `@store` is refused.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ..errors import SiddhiAppCreationError
from ..query_api.definition import TableDefinition
from ..query_api.expression import (
    And,
    Compare,
    CompareOp,
    Constant,
    Expression,
    IsNull,
    Not,
    Or,
    Variable,
)

# --------------------------------------------------------------- visitor SPI


class StoreConditionVisitor:
    """Compile-time walk of an ON condition (reference:
    core/util/collection/expression ExpressionVisitor contract). Stores
    override to build native query syntax; every method receives plain AST
    leaves."""

    def begin_and(self): ...
    def end_and(self): ...
    def begin_or(self): ...
    def end_or(self): ...
    def begin_not(self): ...
    def end_not(self): ...
    def begin_compare(self, op: CompareOp): ...
    def end_compare(self, op: CompareOp): ...
    def visit_constant(self, value, type_name: Optional[str]): ...
    def visit_attribute(self, name: str): ...
    def visit_stream_value(self, name: str):
        """A value from the probing stream (parameterized at lookup time)."""

    def visit_is_null(self, name: str): ...

    def result(self):
        raise NotImplementedError


def walk_condition(expr: Optional[Expression], visitor: StoreConditionVisitor,
                   table_id: str):
    """Drive a visitor over the condition AST. Attributes of the table visit
    as visit_attribute; everything else (stream references) as
    visit_stream_value placeholders."""
    if expr is None:
        return visitor.result()

    def walk(e: Expression):
        if isinstance(e, And):
            visitor.begin_and()
            walk(e.left)
            walk(e.right)
            visitor.end_and()
        elif isinstance(e, Or):
            visitor.begin_or()
            walk(e.left)
            walk(e.right)
            visitor.end_or()
        elif isinstance(e, Not):
            visitor.begin_not()
            walk(e.expression)
            visitor.end_not()
        elif isinstance(e, Compare):
            visitor.begin_compare(e.op)
            walk(e.left)
            walk(e.right)
            visitor.end_compare(e.op)
        elif isinstance(e, IsNull):
            if isinstance(e.expression, Variable):
                visitor.visit_is_null(e.expression.attribute)
            else:
                raise SiddhiAppCreationError(
                    "record-store isNull supports attribute operands only")
        elif isinstance(e, Constant):
            visitor.visit_constant(e.value, e.type_name)
        elif isinstance(e, Variable):
            if e.stream_id in (None, table_id):
                visitor.visit_attribute(e.attribute)
            else:
                visitor.visit_stream_value(f"{e.stream_id}.{e.attribute}")
        else:
            raise SiddhiAppCreationError(
                f"record-store conditions do not support "
                f"{type(e).__name__} (math/functions evaluate on device "
                "tables only)")

    walk(expr)
    return visitor.result()


class PredicateVisitor(StoreConditionVisitor):
    """Fallback compiler: condition -> Python predicate over row dicts.
    Used by InMemoryRecordStore and any adapter without native pushdown."""

    _OPS = {
        CompareOp.EQUAL: lambda a, b: a == b,
        CompareOp.NOT_EQUAL: lambda a, b: a != b,
        CompareOp.GREATER_THAN: lambda a, b: a > b,
        CompareOp.GREATER_THAN_EQUAL: lambda a, b: a >= b,
        CompareOp.LESS_THAN: lambda a, b: a < b,
        CompareOp.LESS_THAN_EQUAL: lambda a, b: a <= b,
    }

    def __init__(self):
        self._stack: list = []

    def begin_and(self): pass

    def end_and(self):
        r, l = self._stack.pop(), self._stack.pop()
        self._stack.append(lambda row, l=l, r=r: l(row) and r(row))

    def begin_or(self): pass

    def end_or(self):
        r, l = self._stack.pop(), self._stack.pop()
        self._stack.append(lambda row, l=l, r=r: l(row) or r(row))

    def begin_not(self): pass

    def end_not(self):
        e = self._stack.pop()
        self._stack.append(lambda row, e=e: not e(row))

    def begin_compare(self, op): pass

    def end_compare(self, op):
        rhs, lhs = self._stack.pop(), self._stack.pop()
        fn = self._OPS[op]
        self._stack.append(
            lambda row, lhs=lhs, rhs=rhs, fn=fn: fn(lhs(row), rhs(row)))

    def visit_constant(self, value, type_name):
        self._stack.append(lambda row, v=value: v)

    def visit_attribute(self, name):
        self._stack.append(lambda row, n=name: row.get(n))

    def visit_stream_value(self, name):
        raise SiddhiAppCreationError(
            "record-store on-demand conditions cannot reference stream "
            "attributes; join record tables through their @cache instead")

    def visit_is_null(self, name):
        self._stack.append(lambda row, n=name: row.get(n) is None)

    def result(self) -> Callable:
        if not self._stack:
            return lambda row: True
        assert len(self._stack) == 1
        return self._stack[0]


class ParamPredicateVisitor(PredicateVisitor):
    """PredicateVisitor variant whose compiled form takes (row, params):
    stream-value placeholders (`probe.attr`) read from `params` at call
    time. Backs the GENERAL cache-miss store fallback — computed-key and
    non-equi probe conditions (reference:
    AbstractQueryableRecordTable.java:207-238 compiles every condition
    against the store with streamVariable parameters)."""

    def end_and(self):
        r, l = self._stack.pop(), self._stack.pop()
        self._stack.append(lambda row, p, l=l, r=r: l(row, p) and r(row, p))

    def end_or(self):
        r, l = self._stack.pop(), self._stack.pop()
        self._stack.append(lambda row, p, l=l, r=r: l(row, p) or r(row, p))

    def end_not(self):
        e = self._stack.pop()
        self._stack.append(lambda row, p, e=e: not e(row, p))

    def end_compare(self, op):
        rhs, lhs = self._stack.pop(), self._stack.pop()
        fn = self._OPS[op]

        def cmp(row, p, lhs=lhs, rhs=rhs, fn=fn):
            a, b = lhs(row, p), rhs(row, p)
            if a is None or b is None:
                return False
            return fn(a, b)

        self._stack.append(cmp)

    def visit_constant(self, value, type_name):
        self._stack.append(lambda row, p, v=value: v)

    def visit_attribute(self, name):
        self._stack.append(lambda row, p, n=name: row.get(n))

    def visit_stream_value(self, name):
        self._stack.append(lambda row, p, n=name: p.get(n))

    def visit_is_null(self, name):
        self._stack.append(lambda row, p, n=name: row.get(n) is None)

    def result(self) -> Callable:
        if not self._stack:
            return lambda row, p: True
        assert len(self._stack) == 1
        return self._stack[0]


# ------------------------------------------------------------------ store SPI


class RecordStore:
    """External-store adapter SPI (reference: AbstractRecordTable). One
    instance per `define table ... @store(type='x', key='val', ...)`.

    Rows cross the SPI as plain dicts keyed by attribute name (decoded host
    values, strings as str). `compile_condition` may return any handle the
    adapter's find/delete/update understand."""

    def init(self, definition: TableDefinition, properties: dict,
             config_reader=None) -> None:
        self.definition = definition
        self.properties = properties

    def connect(self) -> None: ...
    def disconnect(self) -> None: ...

    def compile_condition(self, expr: Optional[Expression], table_id: str):
        return walk_condition(expr, PredicateVisitor(), table_id)

    def add(self, rows: list[dict]) -> None:
        raise NotImplementedError

    def find(self, compiled) -> Iterable[dict]:
        raise NotImplementedError

    def delete(self, compiled) -> int:
        raise NotImplementedError

    def update(self, compiled, updater: Callable[[dict], dict]) -> int:
        raise NotImplementedError

    def update_or_add(self, compiled, updater: Callable[[dict], dict],
                      rows: list[dict]) -> int:
        n = self.update(compiled, updater)
        if n == 0:
            self.add(rows)
        return n


class InMemoryRecordStore(RecordStore):
    """Reference-shaped demo adapter (the role of the reference's test
    stores): list-of-dicts backend, predicate-compiled conditions."""

    def init(self, definition, properties, config_reader=None):
        super().init(definition, properties, config_reader)
        self.rows: list[dict] = []

    def add(self, rows):
        self.rows.extend(dict(r) for r in rows)

    def find(self, compiled):
        return [dict(r) for r in self.rows if compiled(r)]

    def delete(self, compiled):
        before = len(self.rows)
        self.rows = [r for r in self.rows if not compiled(r)]
        return before - len(self.rows)

    def update(self, compiled, updater):
        n = 0
        for i, r in enumerate(self.rows):
            if compiled(r):
                self.rows[i] = updater(dict(r))
                n += 1
        return n


def register_all() -> None:
    from ..extension.registry import GLOBAL, ExtensionKind
    GLOBAL.register(ExtensionKind.STORE, "", "inMemory", InMemoryRecordStore)


register_all()
