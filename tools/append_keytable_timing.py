"""Device times of K10's multimap append and K4's key table for one tree
of the port, at their main-path shapes: the append at app G's shape (B =
8,192 keys uniform over 1..100,000, 97% live, into a C = 100,000 ring of
H = 2^18 buckets), skewed (every live lane one key) and at 131,072 lanes
into C = 262,144; K4 at apps B's and E's shape (a 2^21-slot table holding
2^19 keys, 131,072 lanes half present and half new, 95% valid), at app
AE's sec store (2^18 present, ~125,000 new keys of 131,072 lanes, 98%
valid) and in the steady state (131,072 keys the B/E table holds).
Each row gives the call's time on the device alone
(`chip_smoke.device_ms`: calls behind a spin kernel, L2 flushed), one
call with its host enqueue (`chip_smoke.time_ms`, `time_ms`), the
launches of one call (`launches`: the row's counter; `all_launches`: every
counter, so the parent's K1 under the append shows), the bound (the
function's bytes at 3.35 TB/s: each input read once, each output written
once), the bytes the new design moves (`design_ms`: for the append, a
tile's sorted lists written and read once more past one tile; for K4, the
probe's window reads as batched, each claim's atomic and re-read, the
bitmap, its prefixes and the id writes) and the outputs' digest, so two
trees can be seen to agree.
Then app G's step (both join steps of a round, `chip_smoke
.measure_join_steps`), app B's step (`chip_smoke.measure_steps` from a
fresh state) and app AE's ingest step (`_ingest` of a batch into the
five duration stores), each in ms a round, three runs each, with the
digest of what the steps leave: G's join state, B's and AE's key tables
(their float sums are not compared: a run's order of atomics moves their
last bits).

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`), so two trees compare on one card in one command, in
turns:

    for t in old new new old; do
        python3 tools/append_keytable_timing.py --root $t --label $t \\
            >> append_keytable.jsonl
    done
    python3 tools/append_keytable_timing.py --summarize \\
        append_keytable.jsonl

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
PAD = (1 << 63) - 1
B_G, C_G = 8_192, 100_000
B_BIG, C_BIG = 131_072, 262_144
L_K4, K_BE, K_AE = 131_072, 1 << 20, 1 << 20
APPEND_TILE = 8_192  # csrc/k10_join.cu ATILE


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def append_case(torch, rng, groupby, join, B, C, keys, p_live, end_at):
    """A multimap over a C-slot ring that two all-live batches filled (by
    the plain append), and a batch of `keys` to append at `end_at`."""
    dev = torch.device("cuda")
    mm = join.multimap_init(C, join.multimap_buckets(C), dev)
    a = end_at - 2 * B
    for _ in range(2):
        pk = torch.from_numpy(rng.integers(1, C + 1, B).astype(np.int32))
        mm = join.multimap_append_plain(
            mm, groupby.hash_columns32_plain([pk.to(dev)], remap=True),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.tensor(a, device=dev))
        a += B
    kt = torch.from_numpy(np.asarray(keys, dtype=np.int32)).to(dev)
    live = torch.from_numpy(rng.random(B) < p_live).to(dev)
    return (mm, groupby.hash_columns32_plain([kt], remap=True), live,
            torch.tensor(end_at, device=dev))


def append_rows(torch, rng, groupby, join):
    """(name, counter, fn, bound_ms, design_ms, reset) of the appends."""
    rows = []
    for name, B, C, keys in (
            ("K10 append app G", B_G, C_G, rng.integers(1, C_G + 1, B_G)),
            ("K10 append app G, one key", B_G, C_G, np.full(B_G, 7)),
            ("K10 append 131072 into 262144", B_BIG, C_BIG,
             rng.integers(1, C_BIG + 1, B_BIG))):
        mm, h, live, a0 = append_case(torch, rng, groupby, join, B, C, keys,
                                      0.97, 5 * C + 12_345)
        H = mm.heads.shape[0]
        n_live = int(live.sum())
        runs = int(torch.unique(h[live] & (H - 1)).numel())
        nbytes = B * (4 + 1) + n_live * 12 + runs * 8
        extra = 16 * n_live + 16 * runs if B > APPEND_TILE else 0
        work = [t.clone() for t in mm]

        def reset(work=work, mm=mm):
            for t, t0 in zip(work, mm):
                t.copy_(t0)

        def fn(work=work, h=h, live=live, a0=a0):
            return tuple(join.multimap_append(join.MultimapState(*work), h,
                                              live, a0))

        rows.append((name, "K10 append", fn, bound_ms(nbytes),
                     bound_ms(nbytes + extra), reset))
    return rows


def keytable_rows(torch, rng, groupby):
    """(name, counter, fn, bound_ms, design_ms, reset) of K4."""
    dev = torch.device("cuda")

    def table_with(K, pre):
        t = groupby.init_key_table(K, dev)
        pk = torch.from_numpy(pre).to(dev)
        t, _, _ = groupby.key_lookup_or_insert_plain(
            t, pk, torch.ones(pk.shape[0], dtype=torch.bool, device=dev))
        return t

    pre_be = rng.integers(0, 2**62, K_BE // 2, dtype=np.int64)
    be = table_with(K_BE, pre_be)
    present = pre_be[rng.integers(0, pre_be.size, L_K4 // 2)]
    fresh = rng.integers(2**62, PAD, L_K4 // 2, dtype=np.int64)
    mixed = np.concatenate([present, fresh])[rng.permutation(L_K4)]
    pre_ae = rng.integers(0, 2**62, K_AE // 4, dtype=np.int64)
    ae = table_with(K_AE, pre_ae)
    n_fresh = L_K4 * 125 // 131
    fresh_ae = rng.integers(2**62, PAD, n_fresh, dtype=np.int64)
    ae_keys = rng.permutation(np.concatenate(
        [fresh_ae, fresh_ae[rng.integers(0, n_fresh, L_K4 - n_fresh)]]))
    in_be = be.keys[be.keys != PAD].cpu().numpy()  # every one placed
    steady = in_be[rng.integers(0, in_be.size, L_K4)]
    rows = []
    for name, table, keys, p_valid in (
            ("K4 apps B/E", be, mixed, 0.95),
            ("K4 aggregation app AE sec store", ae, ae_keys, 0.98),
            ("K4 steady state", be, steady, 0.95)):
        kt = torch.from_numpy(keys).to(dev)
        valid = torch.from_numpy(rng.random(L_K4) < p_valid).to(dev)
        H = table.keys.shape[0]
        pt, _, _ = groupby.key_lookup_or_insert_plain(
            groupby.KeyTable(*[t.clone() for t in table]), kt, valid)
        n_new = int(pt.count) - int(table.count)
        n_valid = int(valid.sum())
        nbytes = L_K4 * (8 + 1 + 4 + 1) + n_valid * 12 + n_new * 12
        design = nbytes + 8 * probe_loads(torch, groupby, table, kt, valid)
        if n_new:  # claims, the bitmap and its prefixes
            claims = int((valid & ~torch.isin(kt, table.keys)).sum())
            design += claims * 16 + H // 8 * 3
        counter = "K4 aggregation" if "AE" in name else "K4"
        work = [t.clone() for t in table]

        def reset(work=work, table=table):
            for t, t0 in zip(work, table):
                t.copy_(t0)

        def fn(work=work, kt=kt, valid=valid, counter=counter):
            t, ids, res = groupby.key_lookup_or_insert(
                groupby.KeyTable(*work), kt, valid, counter=counter)
            return (*t, ids, res)

        rows.append((name, counter, fn, bound_ms(nbytes), bound_ms(design),
                     reset))
    return rows


def probe_loads(torch, groupby, table, keys, valid) -> int:
    """Table words the new K4's first probe reads: slot 0 alone, then
    batches of 8 up to the first match, all 32 where none matches."""
    win = groupby._probe_windows(
        torch.where(keys == PAD, PAD - 1, keys), table.keys.shape[0])
    match = table.keys[win] == keys[:, None]
    d = torch.where(match.any(1), match.to(torch.uint8).argmax(1), 32)
    loads = torch.where(d == 0, 1, torch.clamp(1 + 8 * ((d + 7) // 8),
                                               max=32))
    return int(loads[valid].sum())


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def state_digest(state) -> str:
    """The tensors of a nested state (tuples, lists, dicts, NamedTuples,
    dataclasses) in order."""
    import dataclasses
    import torch
    outs = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            outs.append(x)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(state)
    return digest(outs)


def app_steps(torch, cs, seed: int, runs: int = 3) -> list:
    """App G's and B's steps and AE's ingest step at chip_smoke.py's
    sizes: one record each with the median of `runs`."""
    from siddhi_tpu_torch import SiddhiManager
    recs = []
    rng = np.random.default_rng(seed)
    k, v, ts = cs.join_events(rng)
    rt = SiddhiManager().create_siddhi_app_runtime(cs.APP_G,
                                                   batch_size=cs.BATCH_G)
    ms = [cs.measure_join_steps(torch, rt, k, v, ts)[1] for _ in range(runs)]
    recs.append({"row": "app G step (a left and a right batch)",
                 "ms": float(np.median(ms)), "runs_ms": ms,
                 "digest": state_digest(rt.query_runtimes["bench"].state)})
    del rt

    key, price, volume, ts = cs.make_events(rng, True)
    columns = {"account": key, "price": price, "volume": volume}
    rt = SiddhiManager().create_siddhi_app_runtime(
        cs.APP_B, batch_size=cs.BATCH, group_capacity=cs.GROUP_CAP)
    ms = [cs.measure_steps(torch, rt, columns, ts, fresh=True)[1]
          for _ in range(runs)]
    recs.append({"row": "app B step (a 131072-event batch)",
                 "ms": float(np.median(ms)), "runs_ms": ms,
                 "digest": state_digest(
                     rt.query_runtimes["bench"].state[1].key_table)})
    del rt

    names, trades, _ = cs.ae_events(rng)
    sym, price, volume, ts = trades
    columns = {"symbol": names[sym], "price": price, "volume": volume,
               "ts": ts}
    rt = SiddhiManager().create_siddhi_app_runtime(
        cs.APP_AE, batch_size=cs.BATCH, group_capacity=cs.GROUP_CAP)
    agg = rt.aggregations["TradeAgg"]
    items = cs._batches(rt, "TradeStream", columns, ts, cs.BATCH)
    ms = []
    for _ in range(runs):
        agg.state = tuple(agg._init_store() for _ in agg.durations)
        total = 0.0
        for b, now in items:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agg.state = agg._ingest(agg.state, b, now)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            agg._maybe_evict(now)  # retention, outside the timed span
        ms.append(total / len(items) * 1e3)
    recs.append({"row": "app AE ingest step (a 131072-trade batch)",
                 "ms": float(np.median(ms)), "runs_ms": ms,
                 "digest": state_digest([st.key_table for st in agg.state])})
    return recs


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("append_keytable_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, join
    kernels.build_all()
    card = cs.card_line()
    rng = np.random.default_rng(args.seed)
    table = append_rows(torch, rng, groupby, join) + keytable_rows(
        torch, rng, groupby)
    for name, counter, fn, bnd, design, reset in table:
        reset()
        kernels.reset_launch_counts()
        outs = fn()
        torch.cuda.synchronize()
        rec = {"label": args.label, "row": name, "card": card,
               "launches": kernels.LAUNCHES[counter],
               "all_launches": sum(kernels.LAUNCHES.values()),
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=2,
                                  reset=reset),
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
                        for k in ("ms", "time_ms")
                        if rs and rs[0].get(k) is not None}
            line[lb]["runs_ms"] = [r["ms"] for r in rs]
            for k in ("launches", "all_launches"):
                line[lb][k] = rs[0].get(k) if rs else None
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
