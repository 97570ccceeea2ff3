"""Carry a running app's state from the JAX package into the port.

The JAX query state, after `jax.device_get`, is a tuple (window state,
selector state, limiter state) of NamedTuples and dataclasses holding numpy
arrays; a join query's is (left window, right window, left multimap, right
multimap, selector state). The functions here take that state — or the same fields as plain
dicts — and load it into a port runtime built from the same app text, so
the next batches continue where the JAX runtime stopped. They read fields
by name and import nothing of the JAX package.

    load_app_state(torch_rt, {name: jax_state}, jax_strings)
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch

from .core.app_runtime import SiddhiAppRuntime
from .core.join_runtime import JoinQueryRuntime
from .core.query_runtime import QueryRuntime
from .ops.groupby import GroupState, KeyTable
from .ops.join import MultimapState
from .ops.selector import SelectorState
from .ops.windows import BatchState, SlidingState


def _field(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True)).to(dtype=like.dtype,
                                                    device=like.device)
    if t.shape != like.shape:
        raise ValueError(f"state shape {tuple(t.shape)} does not match the "
                         f"port's {tuple(like.shape)}")
    return t


def _ring(a, like: torch.Tensor) -> torch.Tensor:
    """A JAX ring [C] into the port's ring [C + 1] (spare row last)."""
    a = np.asarray(a)
    out = like.clone()
    out[:-1] = _tensor(a, like[:-1])
    out[-1] = 0
    return out


def window_state(window_np, like):
    if like == ():  # pass-through window
        return ()
    if isinstance(like, SlidingState):
        # JAX's uint32 ring words, bit for bit, as the port's int32 words
        ring = np.ascontiguousarray(_field(window_np, "ring")).view(np.int32)
        return SlidingState(
            ring=_tensor(ring, like.ring),
            **{f: _tensor(_field(window_np, f), getattr(like, f))
               for f in SlidingState._fields if f != "ring"})
    if not isinstance(like, BatchState):
        raise ValueError(f"window state {type(like).__name__} is not "
                         "ported by interop")
    return BatchState(
        ring_cols={k: _ring(_field(window_np, "ring_cols")[k], v)
                   for k, v in like.ring_cols.items()},
        ring_ts=_ring(_field(window_np, "ring_ts"), like.ring_ts),
        **{f: _tensor(_field(window_np, f), getattr(like, f))
           for f in BatchState._fields if f not in ("ring_cols", "ring_ts")})


def _group(g_np, like):
    """One aggregate's state: a sum component's [K] values, or a custom
    aggregator's tuple of KeyTable / GroupState (distinctCount)."""
    if isinstance(like, (KeyTable, GroupState)):
        return type(like)(*[_tensor(_field(g_np, f), getattr(like, f))
                            for f in like._fields])
    if isinstance(like, tuple):
        if len(g_np) != len(like):
            raise ValueError(f"aggregate state of {len(g_np)} parts, the "
                             f"port's has {len(like)}")
        return tuple(_group(a, b) for a, b in zip(g_np, like))
    return _tensor(g_np, like)


def selector_state(sel_np, like: SelectorState) -> SelectorState:
    groups = _field(sel_np, "groups")
    if len(groups) != len(like.groups):
        raise ValueError(f"{len(groups)} aggregate components in the state, "
                         f"the port's query has {len(like.groups)}")
    kt_np = _field(sel_np, "key_table")
    if (kt_np is None) != (like.key_table is None):
        raise ValueError("key table present on one side only")
    kt = None
    if kt_np is not None:
        kt = KeyTable(*[_tensor(_field(kt_np, f), getattr(like.key_table, f))
                        for f in KeyTable._fields])
    shared = _field(sel_np, "shared_epoch")
    return SelectorState(
        groups=[_group(g, lg) for g, lg in zip(groups, like.groups)],
        key_table=kt,
        epoch=_tensor(_field(sel_np, "epoch"), like.epoch),
        shared_epoch=(None if shared is None
                      else _tensor(shared, like.shared_epoch)))


def load_query_state(qr: QueryRuntime, state) -> None:
    """Load one query's (window, selector, limiter) state."""
    w_np, s_np, r_np = state
    w_like, s_like, r_like = qr.state
    if len(r_np) or r_like != ():
        raise ValueError("only the pass-through rate limiter is ported")
    qr.state = (window_state(w_np, w_like), selector_state(s_np, s_like), ())


def multimap_state(mm_np, like):
    """A join side's multimap: heads and nexts as they are, the u32 hash and
    arrival-tag arrays bit for bit as the port's int32 patterns."""
    if like == ():
        return ()
    return MultimapState(**{
        f: _tensor(np.ascontiguousarray(_field(mm_np, f)).view(np.int32),
                   getattr(like, f))
        for f in MultimapState._fields})


def load_join_state(jr: JoinQueryRuntime, state) -> None:
    """Load one join query's (left window, right window, left multimap,
    right multimap, selector) state."""
    wl, wr, mml, mmr, sel = state
    lwl, lwr, lmml, lmmr, lsel = jr.state
    jr.state = (window_state(wl, lwl), window_state(wr, lwr),
                multimap_state(mml, lmml), multimap_state(mmr, lmmr),
                selector_state(sel, lsel))


def load_strings(rt: SiddhiAppRuntime, strings: Sequence[Optional[str]]) -> None:
    """Load the app-global string table (code i -> strings[i], 0 = null)."""
    rt.ctx.global_strings.restore(strings)


def load_app_state(rt: SiddhiAppRuntime, query_states: dict,
                   strings: Sequence[Optional[str]]) -> None:
    """Load every named query's state and the string table."""
    for name, state in query_states.items():
        qr = rt.query_runtimes[name]
        if isinstance(qr, JoinQueryRuntime):
            load_join_state(qr, state)
        else:
            load_query_state(qr, state)
    load_strings(rt, strings)
