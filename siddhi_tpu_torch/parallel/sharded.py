"""A partition's key-slot path on one device (counterpart of
`PartitionedQueryStep` and `stack_states` of
siddhi_tpu/parallel/sharded.py, one shard).

The JAX step keeps `n_slots` copies of the inner query's state stacked on a
leading axis and vmaps the query over them, each slot on the lanes of its
key. The port's query step launches its kernels through ctypes and cannot
be vmapped, so the slot axis is a list of states, one deep copy a slot,
and a step runs the query once a slot, every slot on every batch with the
same `now`, as the vmap does. One launch a kernel for all slots (a stacked
slot axis) is later work (ROADMAP.md). Sharding the slots across devices
(`ShardedQueryStep`, `shard_owned`, `merge_shard_outputs`) waits for
ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch

from ..core.event import EventBatch
from ..ops.groupby import (DenseKeyTable, dense_key_lookup_or_insert,
                           init_dense_key_table)


def stack_states(state, n_slots: int) -> list:
    """n_slots independent copies of one (empty) state: the slot axis."""
    return [copy.deepcopy(state) for _ in range(n_slots)]


def concat_batches(batches: Sequence[EventBatch]) -> EventBatch:
    """The batches' lanes one after another, in order."""
    return EventBatch(
        ts=torch.cat([b.ts for b in batches]),
        cols={k: torch.cat([b.cols[k] for b in batches])
              for k in batches[0].cols},
        valid=torch.cat([b.valid for b in batches]),
        types=torch.cat([b.types for b in batches]))


class PartitionedQueryStep:
    """`partition with (key of Stream)` on one device: a key-slot axis in
    state.

    Wraps a query step `(state, batch, now) -> (state', out)`; a key maps
    to a slot through a DenseKeyTable (K4b) in first-appearance order, so
    every key has isolated window, selector and limiter state, the
    reference's per-key query runtimes (PartitionStreamReceiver.java:82-141).
    An all-invalid batch is a heartbeat: every slot steps with `now`. The
    output is the slots' outputs one after another, `[n_slots * C]` lanes
    ordered by slot (the keys' first appearance)."""

    def __init__(self, step_fn: Callable, mesh: Sequence[torch.device],
                 n_slots: int,
                 key_fn: Callable[[EventBatch], torch.Tensor]) -> None:
        self.mesh = tuple(mesh)
        if len(self.mesh) != 1:
            raise ValueError("the key-slot path runs on one device")
        self.n_slots = n_slots
        self.step_fn = step_fn
        self.key_fn = key_fn

    def init_state(self, single_state):
        """The slot states (copies of the template) and an empty key
        table."""
        return (stack_states(single_state, self.n_slots),
                init_dense_key_table(self.n_slots, self.mesh[0]))

    def __call__(self, states: list, key_table: DenseKeyTable,
                 batch: EventBatch, now: int):
        keys = self.key_fn(batch)
        key_table, slots = dense_key_lookup_or_insert(key_table, keys,
                                                      batch.valid)
        new_states, outs = [], []
        for j, state in enumerate(states):
            state, out = self.step_fn(state, batch.where_valid(slots == j),
                                      now)
            new_states.append(state)
            outs.append(out)
        return new_states, key_table, concat_batches(outs)
