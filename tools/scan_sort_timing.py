"""Device times of every K5, K5b and K7 site of `chip_smoke.py`, at the
same shapes, for one tree of the port: the kernel's time on the device
alone (`chip_smoke.device_ms`: 20 calls behind a spin kernel, L2 flushed),
the PyTorch call that computes the same function (`torch.cumsum`, a stable
`torch.sort`), the stable `torch.sort` a grouped scan runs before its
kernel, the launches of one call, and the bound (bytes at 3.35 TB/s).

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`), so two trees compare on one card in one command, in
turns:

    for t in old new new old; do
        python3 tools/scan_sort_timing.py --root $t --label $t \\
            >> scan_sort.jsonl
    done
    python3 tools/scan_sort_timing.py --summarize scan_sort.jsonl

Needs a CUDA card. Inputs come from `--seed` (the same in every tree).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12
B = 131_072
WINDOW = 10_000
GROUP_CAP = 1 << 20
N_V = 10_000  # app V's sort(N)
T_SYMBOLS = 1_000
C_TABLE = 65_536


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def rows(torch, rng):
    """(name, counter, fn, library or None, sort or None, bound_ms, reset)
    for every site; fn calls the tree's public entry point."""
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops.windows import LengthBatchWindow
    dev = torch.device("cuda")
    out = []

    # K5: a lengthBatch(10000) chunk of app A, three float32 components
    L = LengthBatchWindow({}, B, WINDOW, expired_on=False).chunk_width
    types = np.full(L, -1)
    for f in range(B // WINDOW):
        types[f * (WINDOW + 1)] = 3
        types[f * (WINDOW + 1) + 1:(f + 1) * (WINDOW + 1)] = 0
    resets = torch.from_numpy(types == 3).to(dev)
    valid = torch.from_numpy(types == 0).to(dev)
    slots = torch.from_numpy(rng.integers(0, GROUP_CAP, L)
                             .astype(np.int32)).to(dev)
    price = torch.from_numpy(rng.uniform(1, 100, L).astype(np.float32)) \
        .to(dev)
    comps = [price, price.clone(), torch.ones(L, dtype=torch.float32,
                                             device=dev)]
    v0 = [torch.from_numpy(rng.uniform(0, 500, GROUP_CAP).astype(
        np.float32)).to(dev) for _ in comps]
    e0 = torch.from_numpy(rng.integers(0, 8, GROUP_CAP).astype(np.int32)) \
        .to(dev)
    cur = torch.tensor(5, dtype=torch.int32, device=dev)
    vals, ep = [v.clone() for v in v0], e0.clone()

    def reset5():
        for v, a in zip(vals, v0):
            v.copy_(a)
        ep.copy_(e0)

    slots_v = torch.where(valid, slots, GROUP_CAP).to(torch.int32)
    touched = int(torch.unique(torch.where(valid, slots, -1)).numel()) - 1
    out.append(("K5", "K5",
                lambda: groupby.grouped_scan_fused(vals, ep, slots, comps,
                                                   valid, resets, cur),
                None, lambda: torch.sort(slots_v, stable=True),
                bound_ms(L * 6 + 3 * L * 8 + touched * (3 * 8 + 8)), reset5))

    # the sliding width, K = 2^20: K5b grouped int64 sum, K5b ungrouped,
    # K5 ungrouped (app F's three components)
    L2 = 2 * B
    slots2 = torch.from_numpy(rng.integers(0, GROUP_CAP, L2)
                              .astype(np.int32)).to(dev)
    valid2 = torch.from_numpy(rng.random(L2) < 0.9).to(dev)
    resets2 = torch.zeros(L2, dtype=torch.bool, device=dev)
    resets2[torch.from_numpy(rng.choice(L2, 3, replace=False)).to(dev)] = \
        True
    valid2 &= ~resets2
    no_resets = torch.zeros(L2, dtype=torch.bool, device=dev)
    d64 = torch.from_numpy(rng.choice([-1, 1], L2)).to(dev)
    d32f = torch.from_numpy(rng.uniform(-100, 100, L2).astype(np.float32)) \
        .to(dev)
    g0 = torch.from_numpy(rng.integers(0, 50, GROUP_CAP)).to(dev)
    ge0 = torch.from_numpy(rng.integers(3, 7, GROUP_CAP).astype(np.int32)) \
        .to(dev)
    gst = groupby.GroupState(g0.clone(), ge0.clone())

    def reset_g():
        gst.values.copy_(g0)
        gst.epoch.copy_(ge0)

    slots2_v = torch.where(valid2, slots2, GROUP_CAP).to(torch.int32)
    touched2 = int(torch.unique(torch.where(valid2, slots2, -1)).numel()) - 1
    out.append(("K5b grouped", "K5b grouped",
                lambda: groupby.grouped_scan(gst, slots2, d64, valid2,
                                             resets2, cur),
                None, lambda: torch.sort(slots2_v, stable=True),
                bound_ms(L2 * 22 + touched2 * 24), reset_g))
    cell0 = g0[:1].clone()
    cep0 = torch.tensor([5], dtype=torch.int32, device=dev)
    ust = groupby.GroupState(cell0.clone(), cep0.clone())

    def reset_u():
        ust.values.copy_(cell0)
        ust.epoch.copy_(cep0)

    out.append(("K5b ungrouped", "K5b ungrouped",
                lambda: groupby.ungrouped_scan(ust, d64, valid2, no_resets,
                                               cur),
                lambda: torch.cumsum(d64, 0), None,
                bound_ms(L2 * 18), reset_u))
    fcomps = [d32f, d64 * 7, d64]
    fcells0 = [torch.tensor([v], dtype=c.dtype, device=dev)
               for v, c in zip((1234.5, 999, 40), fcomps)]
    fcells = [c.clone() for c in fcells0]
    fep = cep0.clone()

    def reset_f():
        for c, c0 in zip(fcells, fcells0):
            c.copy_(c0)
        fep.copy_(cep0)

    out.append(("K5 ungrouped", "K5 ungrouped",
                lambda: groupby.ungrouped_scan_fused(fcells, fep, fcomps,
                                                     valid2, no_resets, cur),
                lambda: [torch.cumsum(c, 0) for c in fcomps], None,
                bound_ms(L2 * 2 + sum(2 * L2 * c.element_size()
                                      for c in fcomps)), reset_f))

    # K5b running counts: the ordinal limiter (B, int64 onto a base) and
    # LIMIT's ranks (app AB's chunk, int32)
    mask_o = torch.from_numpy(rng.random(B) < 0.97).to(dev)
    base_o = torch.tensor(5_000_000, device=dev)
    out.append(("K5b ordinal", "K5b ordinal",
                lambda: groupby.running_count(mask_o, counter="K5b ordinal",
                                              base=base_o,
                                              dtype=torch.int64),
                lambda: torch.cumsum(mask_o.to(torch.int64), 0), None,
                bound_ms(B * 9), None))
    M = L
    mask_l = torch.from_numpy(rng.random(M) < 0.99).to(dev)
    out.append(("K5b limit", "K5b limit",
                lambda: groupby.running_count(mask_l, counter="K5b limit"),
                lambda: torch.cumsum(mask_l.to(torch.int32), 0), None,
                bound_ms(M * 5), None))

    # K7's eleven sites
    def sort_row(name, counter, keys, bound=None, width=None, lib=None):
        keys = keys.to(dev).contiguous()
        w = keys.numel() if width is None else width
        lk = keys if lib is None else lib.to(dev)
        out.append((name, counter,
                    lambda: search.stable_radix_argsort(keys, bound, width,
                                                        counter=counter),
                    lambda: torch.sort(lk, stable=True), None,
                    bound_ms(keys.numel() * keys.element_size() + w * 4),
                    None))

    cb = 4 * B + 3

    def chunk_keys(n, p_valid):
        k = rng.integers(0, B + 1, n) * 4 + rng.choice([0, 2], n)
        return torch.from_numpy(np.where(rng.random(n) < p_valid, k, cb)
                                .astype(np.int32))

    sort_row("K7 session chunk", "K7 session chunk", chunk_keys(3 * B, 0.6),
             cb)
    ev = np.where(rng.random(N_V + B) < B / (N_V + B), 4 * B, cb)
    sort_row("K7 sort chunk", "K7 sort chunk",
             torch.from_numpy(np.concatenate([np.arange(B) * 4 + 2, ev])
                              .astype(np.int32)), cb)
    x = rng.integers(0, 2000, N_V + B).astype(np.float64) * 0.05
    for v in (0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf):
        x[rng.integers(0, x.size, 50)] = v
    xt = torch.from_numpy(x)
    sort_row("K7 rank", "K7 rank", search.float64_sort_key(xt, True),
             lib=-xt)
    kg = np.where(rng.random(B) < 0.97, rng.integers(1, T_SYMBOLS + 1, B),
                  4096)
    sort_row("K7 keyed group", "K7 keyed group",
             torch.from_numpy(kg.astype(np.int32)), 4096)
    ages = np.where(rng.random(2 * B) < 0.5, rng.permutation(2 * B), 2 * B)
    sort_row("K7 keyed top-E", "K7 keyed top-E",
             torch.from_numpy(ages.astype(np.int32)), 2 * B, B)
    pb = 4 * B + 4
    hi = np.r_[np.sort(rng.integers(0, B + 1, B)) * 4 + 3,
               np.arange(B) * 4 + 2]
    pv = np.r_[rng.random(B) < 0.5, rng.random(B) < 0.97]
    sort_row("K7 packed chunk", "K7 packed chunk",
             torch.from_numpy(np.where(pv, hi, pb).astype(np.int32)), pb)
    hkeys = groupby.hash_columns([torch.from_numpy(
        rng.zipf(1.2, B).astype(np.int32) % 10_000).to(dev)])
    sort_row("K7 frequent key", "K7 frequent key", hkeys)
    hm = hkeys[:10_000].clone()
    hm[torch.from_numpy(rng.random(10_000) >= 0.9).to(dev)] = \
        torch.iinfo(torch.int64).max
    sort_row("K7 frequent match", "K7 frequent match", hm)
    bucket = 1_700_000_000 + np.arange(B) * 1000 // 20 // 1000
    sort_row("K7 time-first", "K7 time-first",
             torch.from_numpy(np.where(rng.random(B) < 0.8, bucket, 2**62)))
    vm = torch.from_numpy(rng.random(M) < 0.99)
    tot = torch.from_numpy(rng.integers(1, 3000, M).astype(np.float64))
    k = torch.where(vm, -tot, float("inf"))
    sort_row("K7 order by", "K7 order by", search.float64_sort_key(k),
             lib=k)
    live = rng.random(C_TABLE) < 40_000 / C_TABLE
    sector = torch.from_numpy(np.where(live, rng.integers(0, 60, C_TABLE),
                                       np.iinfo(np.int32).max)
                              .astype(np.int32)).to(dev)
    out.append(("K7 table index", "K7 table index",
                lambda: tb.sorted_index(sector),
                lambda: torch.sort(sector), None,
                bound_ms(8 * C_TABLE), None))
    return out


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("scan_sort_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    kernels.build_all()
    card = cs.card_line()
    rng = np.random.default_rng(args.seed)
    for name, counter, fn, library, sort, bnd, reset in rows(torch, rng):
        if reset is not None:
            reset()
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        rec = {"label": args.label, "row": name, "card": card,
               "launches": kernels.LAUNCHES[counter],
               "ms": cs.device_ms(torch, fn, reset=reset),
               "library_ms": (cs.device_ms(torch, library)
                              if library is not None else None),
               "sort_ms": cs.device_ms(torch, sort) if sort else None,
               "bound_ms": bnd}
        print(json.dumps(rec), flush=True)


def summarize(path: str) -> None:
    """Mean of each label's runs a row, and new over old."""
    recs = [json.loads(x) for x in open(path) if x.startswith("{")]
    labels = list(dict.fromkeys(r["label"] for r in recs))
    by = {}
    for r in recs:
        by.setdefault(r["row"], {}).setdefault(r["label"], []).append(r)
    for row, per in by.items():
        line = {"row": row}
        for lb in labels:
            rs = per.get(lb, [])
            line[lb] = {k: (float(np.mean([r[k] for r in rs]))
                            if rs and rs[0][k] is not None else None)
                        for k in ("ms", "library_ms", "sort_ms")}
            line[lb]["runs_ms"] = [r["ms"] for r in rs]
            line[lb]["launches"] = rs[0]["launches"] if rs else None
            line[lb]["digests"] = sorted({r.get("digest") or "" for r in rs})
        line["bound_ms"] = next(iter(per.values()))[0]["bound_ms"]
        print(json.dumps(line))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--summarize", metavar="JSONL")
    args = ap.parse_args(argv)
    if args.summarize:
        summarize(args.summarize)
    else:
        measure(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
