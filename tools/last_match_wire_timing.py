"""Device times of K13e's last match and K12a's wire pack for one tree of
the port, at their main-path shapes, and app AD's table steps.

K13e rows, each what a table output pays from the evaluated condition to
(has, b_star, ev_matched):
- app AD's equality (`on Account.id == id`): B = 8,192 ids over 60,000
  against C = 65,536 rows, 50,000 live, 98% of the lanes valid; a tree
  with `last_match_eq` hashes the keys, a tree without it builds the [B,
  C] mask (`==` and the two valid `&`) and reduces it, as its executor
  did;
- the mask route over an [8,192 x 65,536] condition (each event equal to
  at most one row), with both valid vectors folded in (the older tree
  ANDs them into the mask first);
- a table-only condition ([C], `on T.balance < x` from a stream of 8,192
  events), read as a [1, C] view (the older tree broadcasts it into [B,
  C] first).
K12a rows: app A's output (B = 131,072, code + 2 x float32, half valid),
a delivery of 256 lanes (app AH's batch) and 2^20 lanes, each the same
call in both trees.

Each row gives the call's time on the device alone (`chip_smoke
.device_ms`: calls behind a spin kernel, L2 flushed), one call with its
host enqueue (`chip_smoke.time_ms`, `time_ms`), the launches of one call
(`launches`: the row's counter; `all_launches`: every counter), the bound
(the function's bytes at 3.35 TB/s: each input read once, each output
written once; of a mask, the bytes at a valid lane and a live row), the
peak device memory the call allocates past what it
was handed (`peak_mib`), and the outputs' digest, so two trees can be
seen to agree. Then app AD's steps from a cleared table
(`chip_smoke.timed_steps`): an update or insert of a Txn batch and a
round (8 of them and a delete batch), three runs each, with the peak
device memory of the update-or-insert run and the digest of the table's
rows.

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`), so two trees compare on one card in one command, in
turns:

    for t in old new new old; do
        python3 tools/last_match_wire_timing.py --root $t --label $t \\
            >> last_match_wire.jsonl
    done
    python3 tools/last_match_wire_timing.py --summarize \\
        last_match_wire.jsonl

Needs a CUDA card. Inputs come from `--seed` (the same in every tree).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12
B_AD, C_AD, IDS_AD, LIVE_AD = 8_192, 65_536, 60_000, 50_000


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rows_digest(rows) -> str:
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def k13e_rows(torch, rng, tb, dev=None):
    """(name, counter, fn, bound_ms) of K13e, each as the tree's executor
    runs it."""
    dev = dev or torch.device("cuda")
    new = hasattr(tb, "last_match_eq")
    ids = rng.permutation(IDS_AD)[:LIVE_AD].astype(np.int64)
    rows = torch.from_numpy(np.concatenate(
        [ids, rng.integers(0, IDS_AD, C_AD - ids.size)])).to(dev)
    rv = torch.from_numpy(np.arange(C_AD) < ids.size).to(dev)
    lane = torch.from_numpy(rng.integers(0, IDS_AD, B_AD)).to(dev)
    lv = torch.from_numpy(rng.random(B_AD) < 0.98).to(dev)
    eq_mask = lane[:, None] == rows[None, :]
    balance = torch.from_numpy(rng.uniform(-9000, 9000, C_AD)
                               .astype(np.float32)).to(dev)

    def eq():
        if new:
            return tb.last_match_eq([lane], [rows], lv, rv)
        return tb.last_match((lane[:, None] == rows[None, :])
                             & lv[:, None] & rv[None, :])

    def mask():
        if new:
            return tb.last_match(eq_mask, lv, rv)
        return tb.last_match(eq_mask & lv[:, None] & rv[None, :])

    def table_only():
        cond = balance < -5000.0
        if new:
            return tb.last_match(cond, lv, rv)
        return tb.last_match(torch.broadcast_to(cond, (B_AD, C_AD))
                             & lv[:, None] & rv[None, :])

    out_bytes = 5 * C_AD + B_AD
    # the condition's bytes a mask needs: a valid lane's at a live row
    pairs = int(lv.sum()) * int(rv.sum())
    return [("K13e eq app AD", "K13e eq" if new else "K13e", eq,
             bound_ms(9 * B_AD + 9 * C_AD + out_bytes)),
            ("K13e mask [8192 x 65536] with valid vectors", "K13e", mask,
             bound_ms(pairs + B_AD + C_AD + out_bytes)),
            ("K13e mask table-only [C] condition, B = 8192", "K13e",
             table_only, bound_ms(4 * C_AD + B_AD + C_AD + out_bytes))]


def k12a_rows(torch, rng, wire, dev=None, sizes=(131_072, 256, 1 << 20)):
    """(name, counter, fn, bound_ms, check) of K12a."""
    dev = dev or torch.device("cuda")
    rows = []
    for name, B in zip(("K12a app A output, B = 131072",
                        "K12a delivery of 256 lanes", "K12a 2^20 lanes"),
                       sizes):
        ts = torch.from_numpy(1_700_000_000_000 + np.arange(B)).to(dev)
        valid = torch.from_numpy(rng.random(B) < 0.5).to(dev)
        types = torch.from_numpy(rng.choice(np.array([0, 1, 3], np.int8),
                                            B)).to(dev)
        cols = {"symbol": torch.from_numpy(rng.integers(0, 10**6, B)
                                           .astype(np.int32)).to(dev),
                "total": torch.from_numpy(rng.random(B).astype(np.float32))
                .to(dev),
                "avgPrice": torch.from_numpy(rng.random(B)
                                             .astype(np.float32)).to(dev)}
        layout = wire.layout_of(ts, cols)
        n_valid = int(valid.sum())

        def fn(ts=ts, valid=valid, types=types, cols=cols, layout=layout):
            return (wire.wire_payload(wire.wire_pack_cuda(
                ts, valid, types, cols, layout), layout),)

        def call(ts=ts, valid=valid, types=types, cols=cols, layout=layout):
            return wire.wire_pack_cuda(ts, valid, types, cols, layout)

        need = B * (8 + 1 + 1 + 12) + 32 + n_valid * (4 + 1 + 12)
        rows.append((name, "K12a", call, bound_ms(need), fn))
    return rows


def ad_steps(torch, cs, seed: int, runs: int = 3) -> list:
    """App AD's steps alone at chip_smoke.py's sizes, each run from a
    cleared table: one record each with the median of `runs`."""
    from siddhi_tpu_torch import SiddhiManager
    rng = np.random.default_rng(seed)
    ids, amount, kind, close = cs.ad_events(rng)
    rt = SiddhiManager().create_siddhi_app_runtime(
        cs.APP_AD, batch_size=cs.AD_BATCH, group_capacity=cs.GROUP_CAP)
    tbl = rt.tables["Account"]
    txn, cls = rt.query_runtimes["txn"], rt.query_runtimes["close"]
    t0 = 1_700_000_000_000
    n = ids.shape[0]
    txb = cs._batches(rt, "Txn", {"id": ids, "amount": amount,
                                  "kind": kind},
                      t0 + np.arange(n, dtype=np.int64), cs.AD_BATCH)
    clb = cs._batches(rt, "Close", {"id": close},
                      t0 + n + np.arange(close.shape[0], dtype=np.int64),
                      cs.AD_CLOSE)
    uoi, rnd, peaks = [], [], []
    for _ in range(runs):
        tbl.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        u = cs.timed_steps(torch, lambda b: txn.on_batch(*b), txb, 1,
                           "app AD txn")[0]
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        d = cs.timed_steps(torch, lambda b: cls.on_batch(*b), clb, 0,
                           "app AD close")[0]
        uoi.append(u)
        rnd.append(u * cs.AD_TXN_BATCHES + d)
    rows = rows_digest(tbl.all_rows())
    return [{"row": "app AD update or insert (a Txn batch)",
             "ms": float(np.median(uoi)), "runs_ms": uoi,
             "peak_mib": max(peaks), "digest": rows},
            {"row": "app AD round (8 Txn batches and a delete)",
             "ms": float(np.median(rnd)), "runs_ms": rnd, "digest": rows}]


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("last_match_wire_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.ops import wire
    kernels.build_all()
    card = cs.card_line()
    rng = np.random.default_rng(args.seed)
    table = [(*r, None) for r in k13e_rows(torch, rng, tb)] + k12a_rows(
        torch, rng, wire)
    for name, counter, fn, bnd, check in table:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = (check or fn)()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        launches = dict(kernels.LAUNCHES)
        rec = {"label": args.label, "row": name, "card": card,
               "launches": launches[counter],
               "all_launches": sum(launches.values()),
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=2),
               "time_ms": cs.time_ms(torch, fn, iters=args.iters),
               "bound_ms": bnd, "peak_mib": peak, "digest": digest(outs)}
        del outs
        print(json.dumps(rec), flush=True)
    for rec in ad_steps(torch, cs, args.seed):
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
                        for k in ("ms", "time_ms", "peak_mib")
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
