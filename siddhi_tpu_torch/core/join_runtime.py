"""Join query runtime (counterpart of siddhi_tpu/core/join_runtime.py; this
slice ports joins whose sides are streams, with or without a window and
with filters: inner, left, right and full outer joins, `unidirectional`,
`within` and self-joins with aliases).

One runtime serves `from L#w() join R#w() on cond`. Each side keeps its own
window; a batch arriving on a triggering side is appended to its own window
and probed against the other side's current contents. A sliding-window
build side with equality keys is probed through its multimap (K10),
maintained as rows append; other build sides through the sort-merge or the
cross probe (ops/join.py). Within one micro-batch of a self-join the
direction that probes first does not see the batch itself, as in the JAX
package. Table, named-window and aggregation sides are not yet ported.

A step makes no host synchronisation: the dropped-pair counter
accumulates on the device and is read every 64 steps.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import torch

from ..errors import DefinitionNotExistError, SiddhiAppCreationError
from ..extension.registry import ExtensionKind, Registry
from ..ops.expr_compile import Scope, TypeResolver, compile_expression
from ..ops.join import (_hash_exprs, compact_pairs, multimap_append,
                        multimap_buckets, multimap_init, plan_join,
                        probe_cross, probe_equi, probe_equi_mm)
from ..ops.selector import CompiledSelector
from ..ops.window_factories import WindowFactory
from ..ops.windows import (PassThroughWindow, SlidingWindow, WindowOp,
                           _unpack_rows, _words_to, make_layout,
                           window_has_time_semantics)
from ..query_api.definition import Attribute, AttributeType, StreamDefinition
from ..query_api.execution import (EventTrigger, JoinInputStream, JoinType,
                                   Query, SingleInputStream)
from . import dtypes
from .context import SiddhiAppContext
from .event import EventBatch, EventType, StreamCodec
from .query_runtime import QueryCallback, QueryRuntime, eval_constant
from .stream import Receiver, StreamJunction

#: steps between two reads of the dropped-pair counter
_DROP_CHECK_EVERY = 64


class _Side:
    """One join side: a stream (junction + window)."""

    def __init__(self, ins: SingleInputStream, registry: Registry,
                 junctions: dict) -> None:
        self.ref = ins.reference_id  # alias or stream id
        self.junction: Optional[StreamJunction] = junctions.get(ins.stream_id)
        if self.junction is None:
            raise DefinitionNotExistError(
                f"stream {ins.stream_id!r} is not defined")
        h = ins.handlers
        if (h.pre_window_functions or h.post_window_functions
                or h.post_window_filters):
            raise SiddhiAppCreationError(
                "stream functions and post-window filters on join sides are "
                "not yet ported to siddhi_tpu_torch")
        self.codec = self.junction.codec
        self.attr_types = {
            a.name: a.type for a in self.junction.definition.attributes
            if a.type != AttributeType.OBJECT}
        layout = make_layout(self.attr_types)
        batch_cap = self.junction.batch_size
        wh = h.window
        if wh is not None:
            factory = registry.require(ExtensionKind.WINDOW, wh.namespace,
                                       wh.name)
            assert isinstance(factory, WindowFactory)
            params = [eval_constant(p) for p in wh.parameters]
            registry.validate_params(ExtensionKind.WINDOW, wh.namespace,
                                     wh.name, params, what="window")
            self.window: WindowOp = factory.make(layout, batch_cap, params,
                                                 True)
        else:
            self.window = PassThroughWindow(layout, batch_cap)
        self.handlers = h
        self.filters: list = []
        #: bucket count of this side's multimap (None: no multimap), and the
        #: key expressions it hashes — those of the plan probing into it
        self.mm_buckets: Optional[int] = None
        self.mm_build_keys: list = []


class JoinQueryRuntime:
    def __init__(self, query: Query, ctx: SiddhiAppContext, junctions: dict,
                 registry: Registry, name: str) -> None:
        assert isinstance(query.input_stream, JoinInputStream)
        jis: JoinInputStream = query.input_stream
        if jis.per is not None:
            raise SiddhiAppCreationError(
                "aggregation joins are not yet ported to siddhi_tpu_torch")
        self.query = query
        self.ctx = ctx
        self.name = name
        self.callbacks: list[QueryCallback] = []
        self.output_junction: Optional[StreamJunction] = None
        self._dropped_dev: Optional[torch.Tensor] = None
        self._drop_checks = 0
        self._drop_warned = False
        self.k_max = dtypes.config.join_max_matches

        self.left = _Side(jis.left, registry, junctions)
        self.right = _Side(jis.right, registry, junctions)
        if self.left.ref == self.right.ref:
            raise SiddhiAppCreationError(
                "self-joins need an alias: `from S as a join S as b ...`")
        self.join_type = jis.join_type
        self.trigger = jis.trigger
        self.within_ms = jis.within_ms

        frames = {self.left.ref: self.left.attr_types,
                  self.right.ref: self.right.attr_types}
        codecs = {self.left.ref: self.left.codec,
                  self.right.ref: self.right.codec}
        self.resolver = TypeResolver(frames, self.left.ref, codecs)
        for side in (self.left, self.right):
            side.filters = [compile_expression(f, self.resolver, registry)
                            for f in side.handlers.filters]

        # one plan per probe direction
        self.plan_from_left = plan_join(jis.on, self.left.ref,
                                        self.right.ref, self.resolver,
                                        registry)
        self.plan_from_right = plan_join(jis.on, self.right.ref,
                                         self.left.ref, self.resolver,
                                         registry)

        select_all = list(self.left.attr_types.items())
        for n, t in self.right.attr_types.items():
            if n not in self.left.attr_types:
                select_all.append((n, t))
        self.selector = CompiledSelector(
            query.selector, self.resolver, registry,
            ctx.effective_group_capacity, select_all_attrs=select_all)
        self.output_definition = StreamDefinition(
            id=query.output_stream.target_id or f"{name}_out",
            attributes=tuple(Attribute(n, t)
                             for n, t in self.selector.out_types.items()))
        self.output_codec = StreamCodec(self.output_definition,
                                        ctx.global_strings)

        # a side's multimap serves probes FROM the other side: it indexes
        # the side's sliding ring by the hash of the plan that builds on it
        for side, plan in ((self.left, self.plan_from_right),
                           (self.right, self.plan_from_left)):
            if isinstance(side.window, SlidingWindow) and plan.probe_keys:
                side.mm_buckets = multimap_buckets(side.window.C)
                side.mm_build_keys = plan.build_keys

        self.state = self.init_state()
        self._step_left = self._make_step(from_left=True)
        self._step_right = self._make_step(from_left=False)
        self.has_time_semantics = any(
            window_has_time_semantics(s.window)
            for s in (self.left, self.right))

    def init_state(self):
        """(left window, right window, left multimap, right multimap,
        selector), each side's multimap () where it has none."""
        dev = self.ctx.device

        def mm_state(s):
            if s.mm_buckets is None:
                return ()
            return multimap_init(s.window.C, s.mm_buckets, dev)

        return (self.left.window.init_state(dev),
                self.right.window.init_state(dev),
                mm_state(self.left), mm_state(self.right),
                self.selector.init_state(dev))

    def _probe_outer(self, from_left: bool) -> bool:
        if self.join_type == JoinType.FULL_OUTER:
            return True
        if self.join_type == JoinType.LEFT_OUTER:
            return from_left
        if self.join_type == JoinType.RIGHT_OUTER:
            return not from_left
        return False

    def _triggers(self, from_left: bool) -> bool:
        return (self.trigger == EventTrigger.ALL
                or (self.trigger == EventTrigger.LEFT and from_left)
                or (self.trigger == EventTrigger.RIGHT and not from_left))

    def _make_step(self, from_left: bool):
        probe_side = self.left if from_left else self.right
        build_side = self.right if from_left else self.left
        plan = self.plan_from_left if from_left else self.plan_from_right
        selector = self.selector
        k_max = self.k_max
        within = self.within_ms
        outer = self._probe_outer(from_left)
        filters = probe_side.filters
        use_mm = build_side.mm_buckets is not None and bool(plan.probe_keys)
        bw = build_side.window
        layout = bw.layout

        def step(state, batch: EventBatch, now):
            wl, wr, mml, mmr, sel = state
            w_probe, w_build = (wl, wr) if from_left else (wr, wl)
            mm_probe, mm_build = (mml, mmr) if from_left else (mmr, mml)
            dev = batch.ts.device

            # --- probe-side filter + window append (+ its multimap) ---
            pscope = Scope()
            pscope.add_frame(probe_side.ref, batch.cols, batch.ts,
                             batch.valid, default=True)
            mask = batch.valid
            for f in filters:
                mask = mask & f(pscope)
            batch = dataclasses.replace(batch, valid=mask)
            pscope.valids[probe_side.ref] = mask
            appended0 = getattr(w_probe, "appended", None)
            w_probe, _chunk = probe_side.window.step(w_probe, batch, now)
            if probe_side.mm_buckets is not None:
                live = mask & (batch.types == int(EventType.CURRENT))
                hashes = _hash_exprs(probe_side.mm_build_keys, pscope)
                mm_probe = multimap_append(mm_probe, hashes, live, appended0)

            # --- candidate pairs ---
            truncated = None
            if use_mm:
                # the multimap path never materialises the ring: candidates
                # gather packed rows below
                window_len = w_build.appended - torch.maximum(
                    w_build.expired, w_build.appended - bw.C)
                lane, brow, pv, truncated = probe_equi_mm(
                    plan, pscope, mask, mm_build, w_build.appended,
                    window_len, k_max)
                if bw.time_ms is not None:
                    # probe-time expiry before compaction, as contents()
                    # applies it: a time window whose own side went idle
                    # holds rows past their deadline
                    tsw = w_build.ring[-2:, brow.long()]
                    pv = pv & (_words_to(tsw[0], tsw[1], torch.int64)
                               + bw.time_ms > now)
            else:
                if isinstance(bw, PassThroughWindow):
                    b_cols, b_ts, b_valid = bw.contents(w_build, now,
                                                        device=dev)
                else:
                    b_cols, b_ts, b_valid = bw.contents(w_build, now)
                if plan.probe_keys:
                    lane, brow, pv = probe_equi(
                        plan, pscope, mask, b_cols, b_ts, b_valid,
                        build_side.ref, k_max)
                else:
                    lane, brow, pv = probe_cross(mask, b_valid, k_max)

            # compact the sparse [B*k_max] block before any per-pair work;
            # small blocks keep their width, big ones cap at factor*B with
            # the overflow counted
            B = batch.ts.shape[0]
            P = lane.shape[0]
            pair_cap = min(P, max(dtypes.config.join_pair_cap_factor * B,
                                  32768))
            dropped = truncated
            if pair_cap < P:
                over = torch.clamp(pv.sum(dtype=torch.int32) - pair_cap,
                                   min=0)
                dropped = over if dropped is None else over + dropped
                lane, brow, pv = compact_pairs(lane, brow, pv, pair_cap)
                P = pair_cap

            # --- pair frames ---
            lane_l = lane.long()
            brow_l = brow.long()
            p_cols = {k: v[lane_l] for k, v in batch.cols.items()}
            p_ts = batch.ts[lane_l]
            if use_mm:
                # one packed gather of the candidates' ring rows
                g_cols, g_ts = _unpack_rows(
                    torch.index_select(w_build.ring, 1, brow_l), layout)
            else:
                g_cols = {k: v[brow_l] for k, v in b_cols.items()}
                g_ts = b_ts[brow_l]

            pair = Scope()
            if from_left:
                pair.add_frame(probe_side.ref, p_cols, p_ts, pv, default=True)
                pair.add_frame(build_side.ref, g_cols, g_ts, pv)
            else:
                pair.add_frame(build_side.ref, g_cols, g_ts, pv)
                pair.add_frame(probe_side.ref, p_cols, p_ts, pv, default=True)

            # --- exact verification: the full ON condition + within ---
            if plan.residual is not None:
                pv = pv & plan.residual(pair)
            if within is not None:
                pv = pv & ((p_ts - g_ts).abs() <= within)

            if outer:
                # unmatched probe lanes join a null build frame
                matched = torch.zeros(B, dtype=torch.int32, device=dev)
                matched = matched.scatter_reduce(
                    0, lane_l, pv.to(torch.int32), "amax") > 0
                o_valid = mask & ~matched
                p_cols = {k: torch.cat([v, batch.cols[k]])
                          for k, v in p_cols.items()}
                p_ts = torch.cat([p_ts, batch.ts])
                g_cols = {k: torch.cat([v, v.new_zeros(B)])
                          for k, v in g_cols.items()}
                g_ts = torch.cat([g_ts, g_ts.new_zeros(B)])
                has_build = torch.cat([
                    torch.ones(P, dtype=torch.bool, device=dev),
                    torch.zeros(B, dtype=torch.bool, device=dev)])
                pv = torch.cat([pv, o_valid])
            else:
                has_build = None

            # zero the build frame on no-build lanes: projections emit nulls
            bf_valid = pv if has_build is None else pv & has_build
            g_cols = {k: torch.where(bf_valid, v, v.new_zeros(()))
                      for k, v in g_cols.items()}

            out_scope = Scope()
            lf_cols, lf_ts = (p_cols, p_ts) if from_left else (g_cols, g_ts)
            rf_cols, rf_ts = (g_cols, g_ts) if from_left else (p_cols, p_ts)
            out_scope.add_frame(self.left.ref, lf_cols, lf_ts,
                                pv if from_left else bf_valid, default=True)
            out_scope.add_frame(self.right.ref, rf_cols, rf_ts,
                                bf_valid if from_left else pv)
            chunk = EventBatch(
                ts=p_ts, cols={}, valid=pv,
                types=torch.zeros(pv.shape[0], dtype=torch.int8,
                                  device=dev))  # CURRENT
            sel, out = selector.step(sel, chunk, out_scope)

            new_wl, new_wr = ((w_probe, w_build) if from_left
                              else (w_build, w_probe))
            new_mml, new_mmr = ((mm_probe, mm_build) if from_left
                                else (mm_build, mm_probe))
            return (new_wl, new_wr, new_mml, new_mmr, sel), out, dropped

        return step

    # ---------------------------------------------------------------- runtime

    def on_side_batch(self, from_left: bool, batch: EventBatch,
                      now: int) -> None:
        t0 = time.perf_counter_ns()
        side = self.left if from_left else self.right
        if batch.capacity < side.junction.batch_size:
            # the step's pair block is sized for the full batch capacity
            batch = batch.pad_to(side.junction.batch_size)
        if not self._triggers(from_left):
            # a non-triggering side still feeds its window (+ multimap)
            wl, wr, mml, mmr, sel = self.state
            w, mm = (wl, mml) if from_left else (wr, mmr)
            w2, mm2 = self._append_only(side, w, mm, batch, now)
            self.state = ((w2, wr, mm2, mmr, sel) if from_left
                          else (wl, w2, mml, mm2, sel))
            return
        step = self._step_left if from_left else self._step_right
        self.state, out, dropped = step(self.state, batch, now)
        if dropped is not None:
            self._dropped_dev = (dropped if self._dropped_dev is None
                                 else self._dropped_dev + dropped)
        self._drop_checks += 1
        if (not self._drop_warned and self._dropped_dev is not None
                and self._drop_checks % _DROP_CHECK_EVERY == 0):
            n = int(self._dropped_dev)
            if n > 0:
                warnings.warn(
                    f"join {self.name!r}: {n} matched pairs exceeded the "
                    "per-step pair block or the per-probe candidate walk "
                    "and were dropped — raise config.join_pair_cap_factor "
                    "/ config.join_max_matches", stacklevel=2)
                self._drop_warned = True
        self._distribute(out, now)
        self.ctx.statistics.track_latency(self.name,
                                          time.perf_counter_ns() - t0)

    def _append_only(self, side: _Side, w, mm, batch: EventBatch, now):
        scope = Scope()
        scope.add_frame(side.ref, batch.cols, batch.ts, batch.valid,
                        default=True)
        mask = batch.valid
        for f in side.filters:
            mask = mask & f(scope)
        batch = dataclasses.replace(batch, valid=mask)
        w2, _chunk = side.window.step(w, batch, now)
        if side.mm_buckets is not None:
            live = mask & (batch.types == int(EventType.CURRENT))
            mm = multimap_append(mm, _hash_exprs(side.mm_build_keys, scope),
                                 live, w.appended)
        return w2, mm

    def side_junctions(self) -> list:
        """The side junctions, each once (a self-join reads one stream)."""
        out = [self.left.junction]
        if self.right.junction is not self.left.junction:
            out.append(self.right.junction)
        return out

    _distribute = QueryRuntime._distribute

    def add_callback(self, cb: QueryCallback) -> None:
        self.callbacks.append(cb)


class _JoinSideReceiver(Receiver):
    def __init__(self, runtime: JoinQueryRuntime, from_left: bool):
        self.runtime = runtime
        self.from_left = from_left

    def on_batch(self, batch: EventBatch, now: int) -> None:
        self.runtime.on_side_batch(self.from_left, batch, now)
