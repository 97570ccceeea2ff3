"""Device times of K11b's pending insert, K10's multimap probe and its
pair compaction, and K2b's chunk gather for one tree of the port, at
their main-path shapes, and the app steps that run them.

Kernel rows:
- K11b at app I's shape: W = 32,768 candidates (97% valid) of one frame
  into a P = 131,072-slot pending table 45% full in scattered slots; the
  same table 90% full (the insert overflows); a table of 9 refs of 4
  columns receiving 7 of them (48 column jobs); and the launch's floor,
  one candidate into 256 slots (one block: a plain launch) and into 2,048
  (two blocks: a cooperative launch). Each the same call,
  `pending_insert`, in both trees, the table restored before each call.
- K10 at app G's shape: B = 8,192 probe lanes (99% valid) against a
  multimap over a full 100,000-row window (H = 2^18), k_max = 16,
  pair_cap = 32,768; and the same with one hot key (a tenth of the window
  and half the probe lanes one key: every such walk passes k_max, the
  pairs overflow pair_cap); and the launch's floor, one probe lane (one
  block: a plain launch) and 129 (two: a cooperative launch). A
  tree with `multimap_probe_compact` runs it; a tree without it runs
  what its join step ran: `multimap_probe`, the
  [B * k_max] lane block, the pairs past pair_cap counted, and
  `compact_pairs`. The outputs (lanes, rows, pv, over, truncated) are the
  same in both.
- K2b `_gather_chunk_packed` at app D's shape (E = B = 131,072, 6 words):
  on a random permutation and on the order `_merge_order` gives a sliding
  step whose every arrival expires one row.

Each row gives the call's time on the device alone (`chip_smoke
.device_ms`: calls behind a spin kernel, L2 flushed), the same with L2
warm (`warm_ms`: no flush between the calls, as a step finds the
multimap its other side's step just wrote), one call with its host
enqueue (`chip_smoke.time_ms`, `time_ms`), the launches of one call
(`launches`: the row's counters; `all_launches`: every counter), the
bound (the function's bytes at 3.35 TB/s: each input read once, each
output written once), the peak device memory the call allocates past
what it was handed (`peak_mib`), and the outputs' digest, so two trees
can be seen to agree.

Step rows, from a fresh state, five runs each: apps H and I (BASELINE
config 4 and its uniform-value feed, 16 rounds of one A and one B batch
of 32,768): the A step (its insert) and the B step, each synchronised
alone, mean ms a step; app G (config 5, 64 rounds of 8,192 a side): a
round of both join steps, mean ms. Their digest is of every step's valid
output rows from one further run; `busy_ms` is the card's busy time a
round over one more run (`chip_smoke.device_busy_ms`, a CUPTI trace).

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`), so two trees compare on one card in one command, in
turns:

    for t in old new new old; do
        python3 tools/insert_probe_timing.py --root $t --label $t \\
            >> insert_probe.jsonl
    done
    python3 tools/insert_probe_timing.py --summarize insert_probe.jsonl

Needs a CUDA card. Inputs come from `--seed` (the same in every tree).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
W_I, P_I = 32_768, 131_072  # app I's insert
B_G, C_G, K_G, CAP_G = 8_192, 100_000, 16, 32_768  # app G's probe
B_D = 131_072  # app D's batch and expired candidates


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _columns(t) -> list:
    """Every column tensor of a pending table, in a fixed order."""
    out = [c for _, cs in sorted(t.frames.items())
           for _, c in sorted(cs.items())]
    out += [v for _, v in sorted(t.frame_valid.items())]
    out += [v for _, v in sorted(t.frame_ts.items())]
    return out + [t.start_ts, t.last_seq, t.armed_ts, t.valid, t.leg_done,
                  t.origin]


def _pending(torch, pattern, rng, dev, P, refs, fill, attrs):
    live = torch.from_numpy(rng.random(P) < fill).to(dev)

    def col(dt, hi=2**40):
        return torch.from_numpy(rng.integers(0, hi, P)).to(dev).to(dt)

    return pattern.PendingTable(
        frames={r: {a: col(torch.int32, 100_000) for a in attrs}
                for r in refs},
        frame_valid={r: col(torch.bool, 2) for r in refs},
        frame_ts={r: col(torch.int64) for r in refs},
        start_ts=col(torch.int64), last_seq=col(torch.int64),
        armed_ts=col(torch.int64), valid=live,
        leg_done=torch.from_numpy(rng.random((P, 2)) < 0.1).to(dev),
        origin=torch.full((P,), -1, dtype=torch.int32, device=dev))


def k11b_rows(torch, rng, pattern, dev):
    """(name, counters, fn, bound_ms, reset, outputs) of K11b."""
    rows = []
    wide = tuple(f"e{k}" for k in range(9))
    for name, W, P, fill, refs, cand_refs, attrs in (
            ("K11b app I, 45% full", W_I, P_I, 0.45, ("a",), ("a",),
             ("val",)),
            ("K11b app I, 90% full (overflow)", W_I, P_I, 0.9, ("a",),
             ("a",), ("val",)),
            ("K11b 48 column jobs, 60% full", W_I, P_I, 0.6, wide, wide[:7],
             ("i", "j", "k", "l")),
            ("K11b floor: W = 1 into P = 256", 1, 256, 0.45, ("a",), ("a",),
             ("val",)),
            ("K11b floor, two blocks: W = 1 into P = 2048", 1, 2048, 0.45,
             ("a",), ("a",), ("val",))):
        dst = _pending(torch, pattern, rng, dev, P, refs, fill, attrs)
        c = _pending(torch, pattern, rng, dev, W, cand_refs,
                     0.97 if W > 1 else 1.0, attrs)
        args = (c.frames, c.frame_valid, c.frame_ts, c.start_ts, c.last_seq,
                c.armed_ts, c.valid)
        saved = [x.clone() for x in _columns(dst)]

        def reset(dst=dst, saved=saved):
            for x, x0 in zip(_columns(dst), saved):
                x.copy_(x0)

        def fn(dst=dst, args=args):
            return pattern.pending_insert(dst, *args)

        def outputs(dst=dst, fn=fn, reset=reset):
            reset()
            _, n_drop = fn()
            return [n_drop] + _columns(dst)

        n_valid = int(c.valid.sum())
        n_free = int((~dst.valid).sum())
        n_fit = min(n_valid, n_free)
        # the candidates' and the table's valid read; per fitting
        # candidate each source column read and each table column written
        src = sum(4 * len(c.frames[r]) + 1 + 8 for r in cand_refs) + 24
        dst_b = sum(4 * len(c.frames[r]) + 1 + 8 for r in cand_refs) \
            + 24 + 1 + 2 + 4
        rows.append((name, ("K11b", "K1"), fn,
                     bound_ms(W + P + n_fit * (src + dst_b) + 8),
                     reset, outputs))
    return rows


def _multimap(torch, groupby, join, rng, dev, keys_of, start):
    """A multimap over a C_G ring filled by 13 batches of B_G lanes (97%
    live) by the plain append; returns (state, next overall index)."""
    mm = join.multimap_init(C_G, join.multimap_buckets(C_G), dev)
    a = start
    for _ in range(-(-C_G // B_G)):
        k = torch.from_numpy(keys_of(B_G).astype(np.int32)).to(dev)
        live = torch.from_numpy(rng.random(B_G) < 0.97).to(dev)
        mm = join.multimap_append_plain(
            mm, groupby.hash_columns32_plain([k], remap=True), live,
            torch.tensor(a, device=dev))
        a += int(live.sum())
    return mm, a


def k10_rows(torch, rng, groupby, join, dev):
    """(name, counters, fn, bound_ms, reset, outputs) of the K10 probe as
    the join step runs it where it compacts."""
    fused = hasattr(join, "multimap_probe_compact")
    rows = []

    def uniform(b):
        return rng.integers(1, C_G + 1, b)

    def hot(b):
        return np.where(rng.random(b) < 0.1, 7, uniform(b))

    for name, keys_of, probe_keys, B, cap in (
            ("K10 probe + compact app G", uniform, uniform, B_G, CAP_G),
            ("K10 probe + compact, one hot key", hot,
             lambda b: np.where(rng.random(b) < 0.5, 7, uniform(b)), B_G,
             CAP_G),
            ("K10 probe + compact floor: B = 1", uniform, uniform, 1, 8),
            ("K10 probe + compact floor, two tiles: B = 129", uniform,
             uniform, 129, 512)):
        mm, appended = _multimap(torch, groupby, join, rng, dev, keys_of,
                                 3 * C_G)
        pk = torch.from_numpy(probe_keys(B).astype(np.int32)).to(dev)
        ph = groupby.hash_columns32_plain([pk], remap=True)
        pv = torch.from_numpy(rng.random(B) < 0.99 if B > 129
                              else np.ones(B, bool)).to(dev)
        app = torch.tensor(appended, device=dev)
        wlen = torch.tensor(C_G, device=dev)

        def fn(mm=mm, ph=ph, pv=pv, app=app, B=B, cap=cap):
            if fused:
                return join.multimap_probe_compact(mm, ph, pv, app, wlen,
                                                   K_G, cap)
            pos, ok, truncated = join.multimap_probe(mm, ph, pv, app, wlen,
                                                     K_G)
            ok = ok.reshape(-1)
            over = torch.clamp(ok.sum(dtype=torch.int32) - cap, min=0)
            lane, row, valid = join.compact_pairs(
                join._lanes(B, K_G, dev), pos.reshape(-1), ok, cap)
            return lane, row, valid, over, truncated

        # hash, valid and a head a lane; 12 bytes a chain entry the
        # walks visit (the truncation probe included); the pairs out
        visited = _visited(torch, mm, ph, pv, appended, C_G, K_G)
        rows.append((name, ("K10 probe compact", "K10 probe",
                            "K10 compact"), fn,
                     bound_ms(B * 9 + visited * 12 + cap * 9 + 12), None,
                     lambda fn=fn: list(fn())))
    return rows


def _visited(torch, mm, hashes, valid, appended, wlen, k_max) -> int:
    """Chain entries the probe's walks read, truncation probe included."""
    H = mm.heads.shape[0]
    app32 = int(appended) & 0xFFFFFFFF
    seq = mm.slot_seq.to(torch.int64) & 0xFFFFFFFF
    pos = torch.where(valid, mm.heads[(hashes & (H - 1)).long()], -1)
    alive = valid.clone()
    prev = torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    visited = 0
    for _ in range(k_max + 1):
        ok = alive & (pos >= 0)
        visited += int(ok.sum())
        p = torch.where(ok, pos, 0).long()
        age = (app32 - seq[p]) & 0xFFFFFFFF
        alive = ok & (age > prev) & (age <= wlen)
        prev = age
        pos = mm.nexts[p]
    return visited


def k2b_rows(torch, rng, w, dev):
    """(name, counters, fn, bound_ms, reset, outputs) of K2b's gather."""
    layout = {"symbol": torch.int32, "price": torch.float32,
              "volume": torch.int64}
    W = w._layout_words(layout)
    L = 2 * B_D
    payload = torch.from_numpy(rng.integers(-(2**31), 2**31, (W, L)).astype(
        np.int32)).to(dev)
    emit = torch.arange(L, dtype=torch.int64, device=dev)
    valid = torch.from_numpy(rng.random(L) < 0.5).to(dev)
    types = torch.from_numpy(rng.integers(0, 2, L).astype(np.int8)).to(dev)
    perm = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    lane = torch.arange(B_D, dtype=torch.int32, device=dev)
    every = torch.ones(B_D, dtype=torch.bool, device=dev)
    merge = w._merge_order([(lane * 4 + w.KIND_EXPIRED, lane),
                            (lane * 4 + w.KIND_CURRENT, lane)],
                           [every, every])
    rows = []
    for name, order in (("K2b gather, random order", perm),
                        ("K2b gather, app D's merge order", merge)):
        def fn(order=order):
            return w._gather_chunk_packed(order, payload, emit, valid,
                                          types, layout)

        def outputs(fn=fn):
            c = fn()
            return [c.ts, c.valid, c.types] + [c.cols[k] for k in layout]

        rows.append((name, ("K2b gather",), fn,
                     bound_ms(L * (4 + (W - 2) * 4 + 8 + 1 + 1)
                              + L * (4 + 4 + 8 + 8 + 1 + 1)), None,
                     outputs))
    return rows


def warm_ms(torch, cs, fn, reset=None, iters: int = 20) -> float:
    """Mean device time of fn() with L2 warm: as `chip_smoke.device_ms`
    (calls queued behind a spin kernel, each between its own events) but
    with no fill between the calls."""
    reset = reset if reset is not None else (lambda: None)
    for _ in range(3):
        reset()
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(cs._SLEEP_CYCLES_PER_MS[0] * 10))
    for e0, e1 in events:
        reset()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / iters


def _out_digest(h, out) -> None:
    v = out.valid
    h.update(out.ts[v].cpu().numpy().tobytes())
    h.update(out.types[v].cpu().numpy().tobytes())
    for k in sorted(out.cols):
        h.update(out.cols[k][v].cpu().numpy().tobytes())


def pattern_steps(torch, cs, name: str, seed: int, runs: int = 5) -> list:
    """App H's or I's steps alone from a fresh state: mean ms of an A step
    and of a B step, each synchronised alone, over the rounds; median of
    `runs`."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core import dtypes
    from siddhi_tpu_torch.core.event import EventBatch
    data = cs.pattern_events(np.random.default_rng(seed), name)
    prev = dtypes.config.pattern_pending_capacity
    dtypes.config.pattern_pending_capacity = cs.PENDING_P
    try:
        rt = SiddhiManager().create_siddhi_app_runtime(
            cs.APP_H, batch_size=cs.BATCH_P)
    finally:
        dtypes.config.pattern_pending_capacity = prev
    qr = rt.query_runtimes["bench"]
    dev = torch.device("cuda")
    nows = cs.pattern_nows(data, cs.ROUNDS_P, cs.BATCH_P)
    steps = []
    for r in range(cs.ROUNDS_P):
        sl = slice(r * cs.BATCH_P, (r + 1) * cs.BATCH_P)
        for k, side in enumerate(("A", "B")):
            val, ts = data[side]
            steps.append((side, qr._steps[f"Stream{side}"],
                          EventBatch.from_numpy(ts[sl], {"val": val[sl]},
                                                cs.BATCH_P, dev),
                          nows[2 * r + k]))
    a_ms, b_ms = [], []
    for _ in range(runs):
        qr.state = qr.init_state()
        per = {"A": 0.0, "B": 0.0}
        for side, step, b, now in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qr.state, _ = step(qr.state, b, now)
            torch.cuda.synchronize()
            per[side] += time.perf_counter() - t0
        a_ms.append(per["A"] / cs.ROUNDS_P * 1e3)
        b_ms.append(per["B"] / cs.ROUNDS_P * 1e3)
    h = hashlib.sha256()
    qr.state = qr.init_state()
    for side, step, b, now in steps:
        qr.state, out = step(qr.state, b, now)
        _out_digest(h, out)
    h.update(str(int(qr.state.dropped)).encode())
    dig = h.hexdigest()[:16]

    def one_pass():
        qr.state = qr.init_state()
        for _, step, b, now in steps:
            qr.state, _ = step(qr.state, b, now)

    busy = cs.device_busy_ms(torch, one_pass)
    return [{"row": f"app {name} A step (its insert)",
             "ms": float(np.median(a_ms)), "runs_ms": a_ms, "digest": dig},
            {"row": f"app {name} B step", "ms": float(np.median(b_ms)),
             "runs_ms": b_ms, "digest": dig},
            {"row": f"app {name} round (A + B steps)",
             "ms": float(np.median(np.add(a_ms, b_ms))),
             "runs_ms": list(np.add(a_ms, b_ms)), "digest": dig,
             "busy_ms": busy / cs.ROUNDS_P if busy else None}]


def join_steps(torch, cs, seed: int, runs: int = 5) -> list:
    """App G's two join steps a round from a fresh state, mean ms a round
    (`chip_smoke.measure_join_steps`); median of `runs`."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch
    k, v, ts = cs.join_events(np.random.default_rng(seed))
    rt = SiddhiManager().create_siddhi_app_runtime(cs.APP_G,
                                                   batch_size=cs.BATCH_G)
    rounds = [cs.measure_join_steps(torch, rt, k, v, ts)[1]
              for _ in range(runs)]
    jr = rt.query_runtimes["bench"]
    codecs = {"L": rt.junctions["LeftStream"].codec,
              "R": rt.junctions["RightStream"].codec}
    dev = torch.device("cuda")
    steps = []
    for r in range(cs.ROUNDS_G):
        s = slice(r * cs.BATCH_G, (r + 1) * cs.BATCH_G)
        for side, step in (("L", jr._step_left), ("R", jr._step_right)):
            steps.append((step, EventBatch.from_numpy(
                ts[side][s], codecs[side].encode_columns(
                    {"k": k[side][s], "v": v[side][s]}, cs.BATCH_G),
                cs.BATCH_G, dev), int(ts[side][s].max())))
    h = hashlib.sha256()
    jr.state = jr.init_state()
    dropped = 0
    for step, b, now in steps:
        jr.state, out, d = step(jr.state, b, now)
        _out_digest(h, out)
        dropped += int(d) if d is not None else 0
    h.update(str(dropped).encode())

    def one_pass():
        jr.state = jr.init_state()
        for step, b, now in steps:
            jr.state, _, _ = step(jr.state, b, now)

    busy = cs.device_busy_ms(torch, one_pass)
    return [{"row": "app G round (both join steps)",
             "ms": float(np.median(rounds)), "runs_ms": rounds,
             "digest": h.hexdigest()[:16],
             "busy_ms": busy / cs.ROUNDS_G if busy else None}]


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("insert_probe_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, join, pattern
    from siddhi_tpu_torch.ops import windows as w
    kernels.build_all()
    card = cs.card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    table = (k11b_rows(torch, rng, pattern, dev)
             + k10_rows(torch, rng, groupby, join, dev)
             + k2b_rows(torch, rng, w, dev))
    for name, counters, fn, bnd, reset, outputs in table:
        outs = outputs()
        torch.cuda.synchronize()
        if reset is not None:
            reset()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        launches = dict(kernels.LAUNCHES)
        rec = {"label": args.label, "row": name, "card": card,
               # a parent tree may lack a counter
               "launches": {c: launches.get(c, 0) for c in counters},
               "all_launches": sum(launches.values()),
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=2,
                                  reset=reset),
               "time_ms": cs.time_ms(torch, fn, reset=reset,
                                     iters=args.iters),
               "warm_ms": warm_ms(torch, cs, fn, reset=reset,
                                  iters=args.iters),
               "bound_ms": bnd, "peak_mib": peak, "digest": digest(outs)}
        del outs
        print(json.dumps(rec), flush=True)
    steps = (pattern_steps(torch, cs, "H", args.seed)
             + pattern_steps(torch, cs, "I", args.seed)
             + join_steps(torch, cs, args.seed))
    for rec in steps:
        print(json.dumps({"label": args.label, "card": card, **rec}),
              flush=True)


def summarize(path: str) -> None:
    """Mean of each label's runs a row (the runs listed), and each row's
    digests: trees agree where every label shows one and the same."""
    recs = [json.loads(x) for x in open(path) if x.startswith("{")]
    labels = list(dict.fromkeys(r["label"] for r in recs))
    by = {}
    for r in recs:
        by.setdefault(r["row"], {}).setdefault(r["label"], []).append(r)
    for row, per in by.items():
        line = {"row": row}
        for lb in labels:
            rs = per.get(lb, [])
            line[lb] = {k: float(np.mean([r[k] for r in rs]))
                        for k in ("ms", "warm_ms", "time_ms", "peak_mib",
                                  "busy_ms")
                        if rs and rs[0].get(k) is not None}
            line[lb]["runs_ms"] = [r["ms"] for r in rs]
            for k in ("launches", "all_launches"):
                line[lb][k] = rs[0].get(k) if rs else None
            line[lb]["digests"] = sorted({r["digest"] for r in rs})
        line["bound_ms"] = next(iter(per.values()))[0].get("bound_ms")
        print(json.dumps(line))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--summarize", metavar="JSONL")
    args = ap.parse_args(argv)
    if args.summarize:
        summarize(args.summarize)
    else:
        measure(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
