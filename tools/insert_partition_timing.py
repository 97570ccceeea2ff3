"""Device times of K13d (the table insert's primary-key dedup and its
placement) and K1 (the stable partition order) for one tree of the port,
at their main-path shapes: the dedup at app AC's feed (B = 16,384 string
codes, a fifth repeating a live row and a fifth an earlier lane, against
C = 65,536 rows, 40,000 live) and at app AD's update-or-insert (the
unmatched ids of B = 8,192 over 60,000 against 50,000 live accounts); the
placement of AC's staying lanes into its free rows; K1 at each of its
widths in PERF.md (a 131,072-lane batch, AB's 141,087-lane ORDER BY chunk,
the 65,536 rows of a table's free-row order) and at 4,096 (one block),
393,216 and 2^20 + 1.
Each row gives the call's time on the device alone
(`chip_smoke.device_ms`: calls behind a spin kernel, L2 flushed), the
same back to back with L2 warm (`warm_ms`, rows that write no input),
one call with its host enqueue (`chip_smoke.time_ms`, `time_ms`), the
launches of one call, the bound (the function's bytes at 3.35 TB/s: each
input read once, each output written once), the bytes the design moves
(`design_ms`) and the outputs' digest, so two trees can be seen to agree.
Then apps AC's and AD's steps alone (`chip_smoke.timed_steps`, host
clock, card synchronised): AC's insert of a feed batch and its round (the
`in` filter and the join of a trade batch), AD's update or insert of a
Txn batch and its round (8 of them and a delete batch), three runs each
from a cleared table, with the digest of the table's rows.

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`), so two trees compare on one card in one command, in
turns:

    for t in old new new old; do
        python3 tools/insert_partition_timing.py --root $t --label $t \\
            >> insert_partition.jsonl
    done
    python3 tools/insert_partition_timing.py --summarize \\
        insert_partition.jsonl

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
C_TABLE = 65_536
B_AC, N_LIVE_AC = 16_384, 40_000
B_AD, IDS_AD, LIVE_AD = 8_192, 60_000, 50_000
K1_WIDTHS = ((131_072, "K1"), (141_087, "K1 order by"),
             (65_536, "K1 table free"), (4_096, "K1"), (393_216, "K1"),
             ((1 << 20) + 1, "K1"))


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def table_slots(B: int, C: int) -> int:
    """The dedup's hash table: a power of two, at least 2 (B + C) and 256
    (csrc/k13d_table_insert.cu `table_slots`)."""
    s = 256
    while s < 2 * (B + C):
        s *= 2
    return s


def dedup_design_bytes(B: int, C: int, key_bytes: int, n_in: int) -> int:
    """The keys and valid flags read once and the drop flags written; the
    n_in inserted elements' slots written (8 bytes) and the table read at
    their probes and by the lanes (8 bytes each), the lanes' slots written
    and read, then the table and the lanes' slots zeroed."""
    S = table_slots(B, C)
    return ((B + C) * (key_bytes + 1) + B + n_in * 16 + B * 8 + 8 * S
            + 4 * B)


def k13d_rows(torch, rng, tb, search):
    """(name, counter, fn, bound_ms, design_ms, reset) of the dedup at AC's
    and AD's shapes and the placement at AC's."""
    from siddhi_tpu_torch.core.table import TableState
    dev = torch.device("cuda")
    C = C_TABLE
    live = np.zeros(C, bool)
    live[rng.choice(C, N_LIVE_AC, replace=False)] = True
    codes = rng.permutation(4 * C).astype(np.int32)[:C]
    state = TableState(
        {"symbol": torch.from_numpy(codes).to(dev),
         "sector": torch.from_numpy(rng.integers(0, 100, C)
                                    .astype(np.int32)).to(dev),
         "weight": torch.from_numpy(rng.random(C).astype(np.float32))
         .to(dev)},
        torch.arange(C, dtype=torch.int64, device=dev),
        torch.from_numpy(live).to(dev))
    B = B_AC
    bkey = rng.integers(0, 4 * C, B).astype(np.int32)
    pick = rng.random(B)
    bkey = np.where(pick < 0.2, rng.choice(codes[live], B), bkey)
    earlier = np.maximum(np.arange(B) - rng.integers(1, 50, B), 0)
    bkey = np.where(pick > 0.8, bkey[earlier], bkey)
    bcols = {"symbol": torch.from_numpy(bkey).to(dev),
             "sector": torch.from_numpy(rng.integers(0, 100, B)
                                        .astype(np.int32)).to(dev),
             "weight": torch.from_numpy(rng.random(B).astype(np.float32))
             .to(dev)}
    bts = torch.arange(B, dtype=torch.int64, device=dev) + 10**12
    bvalid = torch.from_numpy(rng.random(B) < 0.98).to(dev)
    lane, row = [bcols["symbol"]], [state.cols["symbol"]]
    n_in = int(bvalid.sum()) + N_LIVE_AC
    out = [("K13d dedup app AC", "K13d dedup",
            lambda: (tb.pk_duplicates(lane, row, bvalid, state.valid),),
            bound_ms(5 * B + 5 * C + B),
            bound_ms(dedup_design_bytes(B, C, 4, n_in)), None)]

    ids = rng.permutation(IDS_AD)[:LIVE_AD].astype(np.int64)
    rows = np.concatenate([ids, rng.integers(0, IDS_AD, C - ids.size)])
    lanes = rng.integers(0, IDS_AD, B_AD)
    ad_lane = [torch.from_numpy(lanes).to(dev)]
    ad_row = [torch.from_numpy(rows).to(dev)]
    ad_lv = torch.from_numpy(~np.isin(lanes, ids)).to(dev)
    ad_rv = torch.from_numpy(np.arange(C) < ids.size).to(dev)
    n_in = int(ad_lv.sum()) + LIVE_AD
    out.append(("K13d dedup app AD", "K13d dedup",
                lambda: (tb.pk_duplicates(ad_lane, ad_row, ad_lv, ad_rv),),
                bound_ms(9 * B_AD + 9 * C + B_AD),
                bound_ms(dedup_design_bytes(B_AD, C, 8, n_in)), None))

    drop = tb.pk_duplicates_plain(lane, row, bvalid, state.valid)
    free = search.stable_partition_order_plain(~state.valid)
    work = TableState({k: v.clone() for k, v in state.cols.items()},
                      state.ts.clone(), state.valid.clone())

    def reset():  # untimed: the placement writes the table in place
        for k, v in state.cols.items():
            work.cols[k].copy_(v)
        work.ts.copy_(state.ts)
        work.valid.copy_(state.valid)

    def place():
        new, counts = tb.place_rows(work, bcols, bts, bvalid, drop, free)
        return (*new.cols.values(), new.ts, new.valid, counts)

    n_ins = int((bvalid & ~drop).sum())
    row_bytes = 4 + 4 + 4 + 8  # three columns and ts
    nbytes = 2 * B + C + n_ins * (4 + 2 * row_bytes + 1)
    out.append(("K13d place app AC", "K13d place", place, bound_ms(nbytes),
                bound_ms(nbytes + 2 * B + C), reset))
    return out


def k1_rows(torch, rng, search):
    """(name, counter, fn, bound_ms, design_ms, reset) of K1 at each
    width: flags read once, the order written (the design reads the flags
    twice)."""
    dev = torch.device("cuda")
    out = []
    for n, counter in K1_WIDTHS:
        live = torch.from_numpy(rng.random(n) < 0.7).to(dev)
        out.append((f"{counter} n={n}", counter,
                    lambda live=live, c=counter: (
                        search.stable_partition_order(live, counter=c),),
                    bound_ms(5 * n), bound_ms(6 * n), None))
    return out


def warm_ms(torch, cs, fn, iters: int = 50) -> float:
    """Device time a call with L2 warm: `iters` calls back to back between
    two events, queued behind a spin kernel that outlasts their enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cs._SLEEP_CYCLES_PER_MS[0]
                          * min(2 * enqueue_ms + 1, 1000)))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rows_digest(rows) -> str:
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def app_steps(torch, cs, seed: int, runs: int = 3) -> list:
    """Apps AC's and AD's steps alone at chip_smoke.py's sizes, each run
    from a cleared table: one record an app with the median of `runs`."""
    from siddhi_tpu_torch import SiddhiManager
    rng = np.random.default_rng(seed)
    names, feed_cols, trade_cols = cs.ac_events(rng)
    feed, sector, weight, feed_ts = feed_cols
    sym, price, volume, ts = trade_cols
    rt = SiddhiManager().create_siddhi_app_runtime(
        cs.APP_AC, batch_size=cs.BATCH, group_capacity=cs.GROUP_CAP)
    tbl = rt.tables["SymbolTable"]
    fbat = cs._batches(rt, "SymbolFeed", {"symbol": names[feed],
                                          "sector": sector,
                                          "weight": weight},
                       feed_ts, cs.AC_FEED_BATCH)
    tbat = cs._batches(rt, "TradeStream", {"symbol": names[sym],
                                           "price": price,
                                           "volume": volume},
                       ts, cs.BATCH)
    known, jr = rt.query_runtimes["known"], rt.query_runtimes["enrich"]

    def known_step(b):
        known.state, _ = known.step(known.state, b[0], b[1])

    def join_step(b):
        jr.state, _, _ = jr._step_left(jr.state, b[0], b[1])

    ins, rnd = [], []
    for _ in range(runs):
        tbl.clear()
        ins.append(cs.timed_steps(torch, lambda b: tbl.insert_batch(b[0]),
                                  fbat, 1, "app AC insert")[0])
        rnd.append(cs.timed_steps(torch, known_step, tbat, 0,
                                  "app AC known")[0]
                   + cs.timed_steps(torch, join_step, tbat, 0,
                                    "app AC enrich")[0])
    recs = [{"row": "app AC insert (a feed batch)",
             "ms": float(np.median(ins)), "runs_ms": ins,
             "digest": rows_digest(tbl.all_rows())},
            {"row": "app AC round (in + join of a trade batch)",
             "ms": float(np.median(rnd)), "runs_ms": rnd,
             "digest": rows_digest(tbl.all_rows())}]
    del rt

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
    uoi, rnd = [], []
    for _ in range(runs):
        tbl.clear()
        u = cs.timed_steps(torch, lambda b: txn.on_batch(*b), txb, 1,
                           "app AD txn")[0]
        d = cs.timed_steps(torch, lambda b: cls.on_batch(*b), clb, 0,
                           "app AD close")[0]
        uoi.append(u)
        rnd.append(u * cs.AD_TXN_BATCHES + d)
    recs += [{"row": "app AD update or insert (a Txn batch)",
              "ms": float(np.median(uoi)), "runs_ms": uoi,
              "digest": rows_digest(tbl.all_rows())},
             {"row": "app AD round (8 Txn batches and a delete)",
              "ms": float(np.median(rnd)), "runs_ms": rnd,
              "digest": rows_digest(tbl.all_rows())}]
    return recs


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("insert_partition_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.ops import search
    kernels.build_all()
    card = cs.card_line()
    rng = np.random.default_rng(args.seed)
    table = k13d_rows(torch, rng, tb, search) + k1_rows(torch, rng, search)
    for name, counter, fn, bnd, design, reset in table:
        if reset is not None:
            reset()
        kernels.reset_launch_counts()
        outs = fn()
        torch.cuda.synchronize()
        rec = {"label": args.label, "row": name, "card": card,
               "launches": kernels.LAUNCHES[counter],
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=2,
                                  reset=reset),
               "warm_ms": warm_ms(torch, cs, fn) if reset is None else None,
               "time_ms": cs.time_ms(torch, fn, reset=reset,
                                     iters=args.iters),
               "bound_ms": bnd, "design_ms": design,
               "digest": digest(outs)}
        print(json.dumps(rec), flush=True)
    for rec in app_steps(torch, cs, args.seed):
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
                        for k in ("ms", "warm_ms", "time_ms")
                        if rs and rs[0].get(k) is not None}
            line[lb]["runs_ms"] = [r["ms"] for r in rs]
            line[lb]["launches"] = rs[0].get("launches") if rs else None
            line[lb]["digests"] = sorted({r["digest"] for r in rs})
        first = next(iter(per.values()))[0]
        line["bound_ms"] = first.get("bound_ms")
        line["design_ms"] = first.get("design_ms")
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
