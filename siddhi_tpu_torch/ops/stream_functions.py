"""Stream functions: N-in / M-out batch transforms in FROM chains
(counterpart of siddhi_tpu/ops/stream_functions.py).

Reference: core/query/processor/stream/StreamFunctionProcessor.java (the
extension SPI appending computed attributes to each event; e.g.
Pol2CartStreamFunctionProcessor, LogStreamProcessor). Here a stream
function maps whole columnar batches — `apply(*arg_columns) -> {new_attr:
column}` — inside the query's step, appending columns to the frame.
Elementwise torch work: no kernel of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind
from ..query_api.definition import AttributeType


@dataclass
class StreamFunctionSpec:
    """Compiled stream function: `apply(*arg_cols) -> {name: col}`;
    `new_attrs` extends the stream schema."""

    apply: Callable
    new_attrs: list  # [(name, AttributeType)]


@dataclass
class StreamFunctionFactory:
    """SPI: make(arg_types: tuple[AttributeType]) -> StreamFunctionSpec."""

    make: Callable


def _make_pol2cart(arg_types):
    """pol2Cart(theta, rho [, z]) -> x, y [, z], theta in degrees (reference:
    Pol2CartStreamFunctionProcessor.java). The arithmetic runs in the
    arguments' promoted type, as jnp's does (a float32 theta stays float32,
    an integer one is float64); the query casts x and y to DOUBLE."""
    if len(arg_types) < 2:
        raise SiddhiAppCreationError("pol2Cart needs (theta, rho)")

    def apply(theta, rho, *z):
        if not theta.dtype.is_floating_point:
            theta = theta.to(torch.float64)
        rad = torch.deg2rad(theta)
        out = {"x": rho * torch.cos(rad), "y": rho * torch.sin(rad)}
        if z:
            out["z"] = z[0]
        return out

    new = [("x", AttributeType.DOUBLE), ("y", AttributeType.DOUBLE)]
    if len(arg_types) > 2:
        new.append(("z", AttributeType.DOUBLE))
    return StreamFunctionSpec(apply, new)


def _make_log(arg_types):
    """log(...): the reference's LogStreamProcessor prints events; a device
    batch cannot print per event, so this is a pass-through marker (host
    logging happens at callbacks)."""

    def apply(*args):
        return {}

    return StreamFunctionSpec(apply, [])


def register_all() -> None:
    GLOBAL.register(ExtensionKind.STREAM_FUNCTION, "", "pol2Cart",
                    StreamFunctionFactory(_make_pol2cart))
    GLOBAL.register(ExtensionKind.STREAM_FUNCTION, "", "log",
                    StreamFunctionFactory(_make_log))


register_all()
