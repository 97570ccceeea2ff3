"""Built-in scalar functions (counterpart of
siddhi_tpu/ops/builtin_functions.py). Each registers a ScalarFunction whose
`make` receives the static argument types and returns a torch function and
its return type, as the reference selects one monomorphic executor at
parse time. `eventTimestamp`, `currentTimeMillis` and `sizeOfSet` over a
forwarded unionSet column are resolved by the planner
(ops/expr_compile.py `_compile_function`); `UUID()` and the set idioms by
the selector (ops/selector.py)."""

from __future__ import annotations

import torch

from ..core import dtypes
from ..core.dtypes import NULL_CODE
from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind
from ..query_api.definition import AttributeType
from .expr_compile import ScalarFunction

_T = AttributeType


def _register(name: str, make, namespace: str = "") -> None:
    GLOBAL.register(ExtensionKind.FUNCTION, namespace, name,
                    ScalarFunction(make))


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


# -- type conversion ---------------------------------------------------------

_NAME_TO_TYPE = {
    "int": _T.INT, "long": _T.LONG, "float": _T.FLOAT, "double": _T.DOUBLE,
    "bool": _T.BOOL, "string": _T.STRING,
}


def _convert(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """`x.astype(dt)` as XLA converts: a float into an integer type
    truncates and saturates, and NaN becomes 0."""
    if x.dtype.is_floating_point and not dt.is_floating_point \
            and dt != torch.bool:
        info = torch.iinfo(dt)
        r = torch.nan_to_num(torch.trunc(x), nan=0.0, posinf=0.0,
                             neginf=0.0)
        # 2^(bits-1) is exact in every float type
        hi = float(2 ** (info.bits - 1))
        inside = torch.where((r >= -hi) & (r < hi), r, 0.0).to(dt)
        return torch.where(x >= hi, info.max,
                           torch.where(x < -hi, info.min, inside))
    return x.to(dt)


def _make_convert(arg_types):
    # convert(x, 'type'): the target is a string constant, which reaches fn
    # as a host string
    if len(arg_types) != 2:
        raise SiddhiAppCreationError("convert(value, 'type') takes 2 args")

    def fn(x, target):
        t = _NAME_TO_TYPE[str(target).lower()]
        if t == _T.STRING or arg_types[0] == _T.STRING:
            raise SiddhiAppCreationError(
                "string conversion is host-side only")
        return _convert(_tensor(x), dtypes.device_dtype(t))

    # the JAX package reports DOUBLE whatever the target: the constant is
    # known only when fn runs
    return fn, _T.DOUBLE


def _make_cast(arg_types):
    return _make_convert(arg_types)


def _make_if_then_else(arg_types):
    if len(arg_types) != 3 or arg_types[0] != _T.BOOL:
        raise SiddhiAppCreationError("ifThenElse(bool, then, else)")
    if arg_types[1] != arg_types[2]:
        if dtypes.is_numeric(arg_types[1]) and dtypes.is_numeric(
                arg_types[2]):
            out_t = dtypes.promote(arg_types[1], arg_types[2])
        else:
            raise SiddhiAppCreationError(
                "ifThenElse branches must share a type")
    else:
        out_t = arg_types[1]
    dt = dtypes.device_dtype(out_t)
    return (lambda c, a, b: torch.where(c, _tensor(a).to(dt),
                                        _tensor(b).to(dt))), out_t


def _make_coalesce(arg_types):
    # numeric columns carry no per-attribute null on the device, so
    # coalesce over numerics returns the first argument; over strings it
    # picks the first non-null code
    t0 = arg_types[0]
    if all(t == _T.STRING for t in arg_types):
        def fn(*args):
            out = args[-1]
            for a in reversed(args[:-1]):
                out = torch.where(a != NULL_CODE, a, out)
            return out
        return fn, _T.STRING
    out_t = t0
    for t in arg_types[1:]:
        out_t = dtypes.promote(out_t, t)
    return (lambda *args: args[0].to(dtypes.device_dtype(out_t))), out_t


def _make_default(arg_types):
    if arg_types[0] == _T.STRING:
        return (lambda a, d: torch.where(a != NULL_CODE, a, d)), _T.STRING
    return (lambda a, d: a), arg_types[0]


def _make_minmax(reducer):
    def make(arg_types):
        out_t = arg_types[0]
        for t in arg_types[1:]:
            out_t = dtypes.promote(out_t, t)
        dt = dtypes.device_dtype(out_t)

        def fn(*args):
            out = args[0].to(dt)
            for a in args[1:]:
                out = reducer(out, a.to(dt))
            return out

        return fn, out_t

    return make


def _make_instance_of(target: AttributeType):
    def make(arg_types):
        result = arg_types[0] == target

        def fn(x, r=result):
            if not isinstance(x, torch.Tensor):  # a string constant
                return torch.tensor(r)
            return torch.full(x.shape, r, dtype=torch.bool, device=x.device)

        return fn, _T.BOOL
    return make


def _make_math_unary(tfn, out=_T.DOUBLE):
    def make(arg_types):
        dt = dtypes.device_dtype(out)
        return (lambda x: tfn(x.to(dt))), out
    return make


def _make_uuid(arg_types):
    """UUID(): a fresh uuid4 per event, substituted at the host boundary
    (the selector's host_uuid_slots); reached only when UUID() is not a
    top-level SELECT attribute."""
    raise SiddhiAppCreationError(
        "UUID() is only supported as a top-level SELECT attribute "
        "(host-boundary substitution); it cannot feed other expressions")


def _make_create_set(arg_types):
    raise SiddhiAppCreationError(
        "createSet() produces a host-opaque set object; on this engine only "
        "the sizeOfSet(unionSet(createSet(x))) composition is supported — "
        "it compiles to an exact distinct count on device")


def _make_size_of_set(arg_types):
    # a provenance-marked column is resolved by the planner before this
    # factory: reaching it means the argument is an arbitrary expression
    raise SiddhiAppCreationError(
        "sizeOfSet() over an arbitrary expression is not supported; "
        "sizeOfSet(unionSet(...)) compiles to an exact distinct count, and "
        "a forwarded `select unionSet(x) as s` column carries a "
        "provenance-marked set-size projection (LONG) that sizeOfSet reads "
        "directly")


def register_all() -> None:
    _register("UUID", _make_uuid)
    _register("createSet", _make_create_set)
    _register("sizeOfSet", _make_size_of_set)
    _register("convert", _make_convert)
    _register("cast", _make_cast)
    _register("ifThenElse", _make_if_then_else)
    _register("coalesce", _make_coalesce)
    _register("default", _make_default)
    _register("maximum", _make_minmax(torch.maximum))
    _register("minimum", _make_minmax(torch.minimum))
    _register("instanceOfInteger", _make_instance_of(_T.INT))
    _register("instanceOfLong", _make_instance_of(_T.LONG))
    _register("instanceOfFloat", _make_instance_of(_T.FLOAT))
    _register("instanceOfDouble", _make_instance_of(_T.DOUBLE))
    _register("instanceOfBoolean", _make_instance_of(_T.BOOL))
    _register("instanceOfString", _make_instance_of(_T.STRING))
    # the math namespace (a subset of siddhi-execution-math)
    _register("abs", _make_math_unary(torch.abs), "math")
    _register("sqrt", _make_math_unary(torch.sqrt), "math")
    _register("log", _make_math_unary(torch.log), "math")
    _register("exp", _make_math_unary(torch.exp), "math")
    _register("floor", _make_math_unary(torch.floor), "math")
    _register("ceil", _make_math_unary(torch.ceil), "math")
    _register("round", _make_math_unary(torch.round), "math")
    _register("sin", _make_math_unary(torch.sin), "math")
    _register("cos", _make_math_unary(torch.cos), "math")
    _register("power", _make_minmax(torch.pow), "math")


register_all()
