"""Device times of the windows' merge (`_merge_order`), the binary search
(`searchsorted32`) and K5's slot sort for one tree of the port, at their
main-path shapes, and the steps of apps A and D that run them.

Kernel rows (the same call in every tree; a tree before the K7 merge and
K6 kernels runs its torch routes behind the same names):
- the merge at app D's sliding step (E = B = 131,072, every arrival
  expiring one row), app C's (a time window's triggers, half the
  candidates expiring) and app A's lengthBatch(10000) step (141,072
  current and 15 RESET lanes; and with the expired group, three groups);
- the search at app C's expiry trigger (131,072 int64 deadlines into the
  batch's timestamps) and app M's bucket trigger (int32 buckets);
- K5's slot sort at app A's chunk (141,087 slots in [0, 2^20]), as
  `groupby._k5_sort` runs it (a torch sort in an older tree, K7 here), and
  the whole grouped K5 call (the sort and the scan) at the same shape.

Each row gives the call's time on the device alone (`chip_smoke
.device_ms`: calls behind a spin kernel, L2 flushed), one call with its
host enqueue (`chip_smoke.time_ms`, `time_ms`), the launches of one call
(`launches`: every counter that moved), the bound (the function's bytes
at 3.35 TB/s: each input read once, each output written once), and the
outputs' digest (int64 positions), so two trees can be seen to agree.

Step rows, from a fresh state, five runs each: app A (BASELINE config 2,
`lengthBatch(10000)` sum/avg by 1,000,000 symbols) and app D (the north
star, `length(100000)` sum/count by symbol), 8 rounds of 131,072 events:
the query step alone (device batches prepared beforehand), the card
synchronised at the end of the rounds, mean ms a step; `busy_ms`, the
card's busy time a step over one more run (`chip_smoke.device_busy_ms`, a
CUPTI trace); the digest of every step's valid output rows.

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`'s timers and app feeds); the inputs are built by this
tool's own `chip_smoke.py` (`merge_shapes`, `search_shapes`), so two trees
compare on one card in one command, in turns:

    for t in old new new old; do
        python3 tools/merge_search_timing.py --root $t --label $t \\
            >> merge_search.jsonl
    done
    python3 tools/merge_search_timing.py --summarize merge_search.jsonl

Needs a CUDA card. Inputs come from `--seed` (the same in every tree).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys
import time

import numpy as np

#: the repository this tool belongs to: its chip_smoke.py builds the inputs
TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def case_builders():
    """This tool's chip_smoke.py, loaded beside the measured tree's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(TOOL_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.long().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def merge_rows(torch, cs, cases, w, rng, dev):
    """(name, fn, bound_ms, outputs) of the merge at its four shapes."""
    rows = []
    for name, (keys, valids) in cases.merge_shapes(torch, rng,
                                                   dev).items():
        lanes = sum(int(k[0].numel()) for k in keys)

        def fn(keys=keys, valids=valids):
            return w._merge_order(keys, valids)

        rows.append((f"K7 merge, {name}", fn,
                     cs.bound_ms(lanes * (4 + 4 + 1 + 4)),
                     lambda fn=fn: [fn()]))
    return rows


def search_rows(torch, cs, cases, search, rng, dev):
    """(name, fn, bound_ms, outputs) of the search at its two shapes."""
    rows = []
    for name, (a, v, side) in cases.search_shapes(torch, rng,
                                                  dev).items():
        def fn(a=a, v=v, side=side):
            return search.searchsorted32(a, v, side)

        rows.append((f"K6, {name}", fn,
                     cs.bound_ms(a.numel() * a.element_size()
                                 + v.numel() * (v.element_size() + 4)),
                     lambda fn=fn: [fn()]))
    return rows


def k5_rows(torch, cs, groupby, rng, dev):
    """(name, fn, bound_ms, outputs) of K5's slot sort and the whole
    grouped K5 call at app A's chunk."""
    from siddhi_tpu_torch.ops.windows import LengthBatchWindow
    L = LengthBatchWindow({}, cs.BATCH, cs.WINDOW,
                          expired_on=False).chunk_width
    K = cs.GROUP_CAP
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(dev)
    resets = torch.zeros(L, dtype=torch.bool, device=dev)
    cur = torch.zeros((), dtype=torch.int32, device=dev)
    comps = [torch.from_numpy(rng.uniform(1, 100, L).astype(np.float32))
             .to(dev) for _ in range(3)]
    sort_args = (slots, valid, resets, cur, K)
    if "counter" in inspect.signature(groupby._k5_sort).parameters:
        sort_args += ("K7 K5 sort",)

    def sort():
        return groupby._k5_sort(*sort_args)[2]

    values = [torch.zeros(K, dtype=torch.float32, device=dev)
              for _ in comps]
    epoch = torch.zeros(K, dtype=torch.int32, device=dev)

    def reset():
        for v in values:
            v.zero_()
        epoch.zero_()

    def scan():
        return groupby.grouped_scan_fused(values, epoch, slots, comps, valid,
                                          resets, cur)[2]

    def scan_out():
        reset()
        return list(scan()) + values + [epoch]

    return [("K5 slot sort, app A's chunk", sort, cs.bound_ms(L * (4 + 4)),
             lambda: [sort()], None),
            ("K5 grouped call (sort + scan), app A's chunk, 3 f32 sums",
             scan, cs.bound_ms(L * (4 + 1 + 1 + 3 * 8)), scan_out, reset)]


def _out_digest(h, out) -> None:
    v = out.valid
    h.update(out.ts[v].cpu().numpy().tobytes())
    h.update(out.types[v].cpu().numpy().tobytes())
    for k in sorted(out.cols):
        h.update(out.cols[k][v].cpu().numpy().tobytes())


def app_steps(torch, cs, name: str, seed: int, runs: int = 5) -> dict:
    """App A's or D's query step alone from a fresh state over 8 rounds of
    131,072: mean ms a step (median of `runs`), busy ms a step, digest."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch
    rng = np.random.default_rng(seed)
    if name == "A":
        key, price, volume, ts = cs.make_events(rng, False)
        columns = {"symbol": np.array([f"S{k}" for k in key], dtype=object),
                   "price": price, "volume": volume}
        text = cs.APP_A
    else:
        sym, price, volume, ts = cs.sliding_events(rng, cs.N_KEYS)
        columns = {"symbol": cs.symbols(cs.N_KEYS)[sym], "price": price,
                   "volume": volume}
        text = cs.APP_D
    rt = SiddhiManager().create_siddhi_app_runtime(
        text, batch_size=cs.BATCH, group_capacity=cs.GROUP_CAP)
    qr = rt.query_runtimes["bench"]
    j = rt.junctions["TradeStream"]
    dev = j.ctx.device
    steps = []
    for r in range(cs.ROUNDS):
        s = slice(r * cs.BATCH, (r + 1) * cs.BATCH)
        cols = j.codec.encode_columns({k: v[s] for k, v in columns.items()},
                                      cs.BATCH)
        steps.append((EventBatch.from_numpy(ts[s], cols, cs.BATCH, dev),
                      int(ts[s].max())))

    def restart():
        qr.state = (qr.window.init_state(dev), qr.selector.init_state(dev),
                    qr.rate_limiter.init_state(dev))

    def one_pass(h=None):
        restart()
        for b, now in steps:
            qr.state, out = qr.step(qr.state, b, now)
            if h is not None:
                _out_digest(h, out)

    one_pass()  # warm
    ms = []
    for _ in range(runs):
        restart()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, now in steps:
            qr.state, _ = qr.step(qr.state, b, now)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / cs.ROUNDS * 1e3)
    h = hashlib.sha256()
    one_pass(h)
    busy = cs.device_busy_ms(torch, one_pass)
    rt.shutdown()
    return {"row": f"app {name} step", "ms": float(np.median(ms)),
            "runs_ms": ms, "digest": h.hexdigest()[:16],
            "busy_ms": busy / cs.ROUNDS if busy else None}


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("merge_search_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops import windows as w
    kernels.build_all()
    card = cs.card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    cases = case_builders()
    table = [r + (None,) for r in merge_rows(torch, cs, cases, w, rng, dev)
             + search_rows(torch, cs, cases, search, rng, dev)]
    table += k5_rows(torch, cs, groupby, rng, dev)
    for name, fn, bnd, outputs, reset in table:
        outs = outputs()
        torch.cuda.synchronize()
        if reset is not None:
            reset()
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        rec = {"label": args.label, "row": name, "card": card,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=2,
                                  reset=reset),
               "time_ms": cs.time_ms(torch, fn, reset=reset,
                                     iters=args.iters),
               "bound_ms": bnd, "digest": digest(outs)}
        del outs
        print(json.dumps(rec), flush=True)
    for name in ("A", "D"):
        rec = app_steps(torch, cs, name, args.seed)
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
                        for k in ("ms", "time_ms", "busy_ms")
                        if rs and rs[0].get(k) is not None}
            line[lb]["runs_ms"] = [r["ms"] for r in rs]
            line[lb]["launches"] = rs[0].get("launches") if rs else None
            line[lb]["digests"] = sorted({r["digest"] for r in rs})
        line["bound_ms"] = next(iter(per.values()))[0].get("bound_ms")
        print(json.dumps(line))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=TOOL_ROOT)
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
