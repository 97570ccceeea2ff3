"""Attribute-type → torch dtype mapping (counterpart of siddhi_tpu/core/dtypes.py).

The dtype policy is the reference package's, so both packages hold the same
values bit for bit where the types are integral:

- INT  -> int32
- LONG -> int64 (timestamps are int64 milliseconds too)
- FLOAT -> float32
- DOUBLE -> float32 by default (`config.double_dtype`); the numeric-parity
  contract of the reference package (tests/test_numeric_parity.py) states
  the tolerance this costs
- BOOL -> bool
- STRING -> int32 dictionary codes; code 0 is null
- OBJECT -> host only, no device dtype
"""

from __future__ import annotations

import numpy as np
import torch

from ..query_api.definition import AttributeType

#: sentinel string code for null
NULL_CODE = 0

#: timestamp dtype — milliseconds since epoch
TS_DTYPE = torch.int64


class _Config:
    double_dtype = torch.float32
    #: default micro-batch capacity per stream (events)
    default_batch_size = 8192
    #: default sliding-window ring capacity when not statically inferable
    default_window_capacity = 1 << 16
    #: default max distinct group-by keys tracked on device per query
    default_group_capacity = 1 << 20
    #: max matched build rows per probe event in joins (static join fan-out)
    join_max_matches = 16
    #: compacted pair-block width as a multiple of the probe batch size;
    #: total matches per step beyond factor*B are dropped (bounded fan-out)
    join_pair_cap_factor = 4


config = _Config()


#: smallest lane bucket a junction pads a partial batch to
MIN_BUCKET = 16


def bucket_capacity(n: int, cap: int) -> int:
    """Smallest power-of-two lane bucket holding `n` rows (n == 0 -> the
    smallest bucket, n >= cap -> cap). Junctions pad partial batches to it;
    a query whose window bakes in its batch capacity pads back to `cap`."""
    if n >= cap:
        return cap
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, cap)


def device_dtype(t: AttributeType) -> torch.dtype:
    if t == AttributeType.INT:
        return torch.int32
    if t == AttributeType.LONG:
        return torch.int64
    if t == AttributeType.FLOAT:
        return torch.float32
    if t == AttributeType.DOUBLE:
        return config.double_dtype
    if t == AttributeType.BOOL:
        return torch.bool
    if t == AttributeType.STRING:
        return torch.int32  # dictionary codes
    raise ValueError(f"attribute type {t} has no device dtype (OBJECT is host-only)")


_NP = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
       torch.float64: np.float64, torch.bool: np.bool_, torch.int8: np.int8}


def numpy_dtype(t: AttributeType) -> np.dtype:
    return np.dtype(_NP[device_dtype(t)])


def null_value(t: AttributeType):
    """Fill value used in padded/invalid lanes."""
    if t in (AttributeType.INT, AttributeType.LONG, AttributeType.STRING):
        return 0
    if t in (AttributeType.FLOAT, AttributeType.DOUBLE):
        return 0.0
    if t == AttributeType.BOOL:
        return False
    return None


def is_numeric(t: AttributeType) -> bool:
    return t in (AttributeType.INT, AttributeType.LONG, AttributeType.FLOAT,
                 AttributeType.DOUBLE)


#: promotion lattice for binary math: int < long < float < double
_RANK = {
    AttributeType.INT: 0,
    AttributeType.LONG: 1,
    AttributeType.FLOAT: 2,
    AttributeType.DOUBLE: 3,
}


def promote(a: AttributeType, b: AttributeType) -> AttributeType:
    if not (is_numeric(a) and is_numeric(b)):
        raise TypeError(f"cannot apply arithmetic to {a}/{b}")
    return a if _RANK[a] >= _RANK[b] else b
