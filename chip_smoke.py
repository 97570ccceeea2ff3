#!/usr/bin/env python3
"""Drive siddhi_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build every kernel under
   siddhi_tpu_torch/csrc/ with `nvcc -Xptxas -v` and print the report;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (K1, K3 and K4 bit for bit, K4 including the
   table state; K5 within rtol 1e-5), with its time (CUDA events), the
   plain version's time, a single PyTorch library call where one computes
   the same function, and the least time the card could take (bytes over
   3.35 TB/s, counted from this run's inputs);
3. app A, BASELINE config 2 as written: lengthBatch(10000) sum/avg grouped
   by a string symbol over 1,000,000 symbols, group_capacity 2^20,
   batch_size 131072, 8 rounds of send_columns + flush (1,048,576 events);
4. app B: the same query keyed by a long account id behind a filter;
5. both apps' outputs against an independent numpy oracle (strings, longs
   and timestamps exact, floats rtol 1e-5), and each on-path kernel's
   launch counter non-zero; then the query step alone over the same
   rounds (device batches prepared beforehand) and the places where one
   step syncs with the host;
6. the sliding-window kernels: each K2b entry point of the packed ring
   (pack-compact, fetch, append across the ring's end, gather), each K5b
   scan (grouped sum/min/max and ungrouped with and without resets, int64
   and float32) and the K5 scan without GROUP BY (three components)
   against its plain version at the sliding apps' shapes (B = E = C =
   131072, W = 6 words; L = 262144 lanes, K = 2^20): K2b, integer scans
   and min/max bit for bit, float32 sums within rtol 1e-5 of the largest
   running value; with the same timings; and the torch routes K2a, K6 and
   the K7 merge timed at their shapes;
7. app C, BASELINE config 3 (time(60 sec) distinctCount(symbol) over
   100,000 symbols, in playback), app D (length(100000) sum/count grouped
   by 1,000,000 symbols), app E (time(60 sec) distinctCount(volume)
   grouped by 1,000 symbols) and app F (length(100000) sum/sum/count
   without GROUP BY), 1,048,576 events each, every output event against
   an independent numpy oracle (counts and long sums exact, float sums
   rtol 1e-5 plus atol 1e-3 for the float32 residues of removal), with
   the same per-app numbers as apps A and B;
8. the join kernels against their plain versions at app G's shapes, bit
   for bit: K3b (one int key column of B = 8192 lanes, with and without
   the validity mask), K10 append (the whole multimap state after a
   sequence of batches that wraps a C = 100000 ring more than twice, H =
   2^18 buckets), K10 probe (k_max = 16; once more on a state whose
   arrival tags cross 2^32, so the u32 ages wrap) and K10 compact (P =
   131072 candidates into pair_cap = 32768, at app G's density and with
   more valid lanes than pair_cap); with the same timings;
9. app G, BASELINE config 5 as bench.py writes it: a stream-stream equi
   join over two length(100000) windows, 64 rounds of 8192 events on each
   side (1,048,576 events), keys uniform over 1..100000; every output
   event against an independent numpy oracle (keys, timestamps and the
   stored float32 values exact), no dropped pair, the same per-app
   numbers.

The second-to-last lines are the kernel table as one JSON object and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one card; without one, or without the package beside it, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
BATCH = 131072
ROUNDS = 8
N_KEYS = 1_000_000
GROUP_CAP = 1 << 20
WINDOW = 10_000
RTOL = 1e-5  # float32 sums vs the float64 oracle (numeric-parity policy)

APP_A = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.lengthBatch(10000)
select symbol, sum(price) as total, avg(price) as avgPrice
group by symbol
insert into SummaryStream;
"""

APP_B = """
define stream TradeStream (account long, price double, volume long);
@info(name = 'bench')
from TradeStream[price > 20.0]#window.lengthBatch(10000)
select account, sum(price) as total, avg(price) as avgPrice
group by account
insert into SummaryStream;
"""

# BASELINE config 3 as bench.py writes it, with @app:playback so that the
# window follows event time (wall-clock `now` would expire every event at
# the end of its own batch)
APP_C = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.time(60 sec)
select distinctCount(symbol) as distinctSymbols
insert into OutStream;
"""

# the north star: a sliding group-by; EXPIRED lanes feed K5 negative deltas
APP_D = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.length(100000)
select symbol, sum(price) as total, count() as n
group by symbol
insert into OutStream;
"""

# exact grouped distinctCount on the (symbol, volume) pair table
APP_E = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.time(60 sec)
select symbol, distinctCount(volume) as n
group by symbol
insert into OutStream;
"""

# a sliding sum without GROUP BY: the ungrouped K5 scan, EXPIRED lanes
# negative
APP_F = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.length(100000)
select sum(price) as total, sum(volume) as vol, count() as n
insert into OutStream;
"""

# BASELINE config 5 as bench.py writes it (bench_join)
APP_G = """
define stream LeftStream (k int, v double);
define stream RightStream (k int, v double);
@info(name = 'bench')
from LeftStream#window.length(100000) as a
join RightStream#window.length(100000) as b
on a.k == b.k
select a.k as k, a.v as lv, b.v as rv
insert into OutStream;
"""
BATCH_G = 8192  # bench.py's join batch
ROUNDS_G = 64
LENGTH_G = 100_000
K_MAX = 16
BUCKETS_G = 1 << 18  # multimap_buckets(100000)
PAIR_CAP_G = 32768  # min(B * k_max, max(4 * B, 32768))

TIME_WINDOW_MS = 60_000
LENGTH_D = 100_000
C_SYMBOLS = 100_000
E_SYMBOLS = 1_000
ATOL_SLIDING = 1e-3  # float32 residues of removal in sliding sums

WINDOWS = "siddhi_tpu/ops/windows.py"
GROUPBY = "siddhi_tpu/ops/groupby.py"
K5_SRC = "siddhi_tpu_torch/csrc/k5_grouped_scan.cu"
K2B_SRC = "siddhi_tpu_torch/csrc/k2b_packed_ring.cu"
K10_SRC = "siddhi_tpu_torch/csrc/k10_join.cu"
JOIN = "siddhi_tpu/ops/join.py"

#: launch-counter key -> (function, source, TPU-side function replaced)
KERNELS = {
    "K1": ("stable_partition_order", "siddhi_tpu_torch/csrc/k1_partition.cu",
           "siddhi_tpu/ops/search.py:20"),
    "K3": ("hash_columns", "siddhi_tpu_torch/csrc/k3_hash.cu",
           f"{GROUPBY}:576"),
    "K4": ("key_lookup_or_insert", "siddhi_tpu_torch/csrc/k4_keytable.cu",
           f"{GROUPBY}:362"),
    "K5": ("grouped_scan_fused", K5_SRC, f"{GROUPBY}:171"),
    "K5 ungrouped": ("ungrouped_scan_fused", K5_SRC, f"{GROUPBY}:240"),
    "K2b pack": ("_pack_rows + compact_packed", K2B_SRC, f"{WINDOWS}:295"),
    "K2b fetch": ("_fetch_rel_packed", K2B_SRC, f"{WINDOWS}:374"),
    "K2b append": ("_append_packed", K2B_SRC, f"{WINDOWS}:354"),
    "K2b gather": ("_gather_chunk_packed", K2B_SRC, f"{WINDOWS}:400"),
    "K5b grouped": ("grouped_scan + _scan_component", K5_SRC,
                    f"{GROUPBY}:61"),
    "K5b ungrouped": ("ungrouped_scan", K5_SRC, f"{GROUPBY}:207"),
    "K3b": ("hash_columns32 + _hash_exprs",
            "siddhi_tpu_torch/csrc/k3_hash.cu", f"{GROUPBY}:555"),
    "K10 append": ("multimap_append", K10_SRC, f"{JOIN}:227"),
    "K10 probe": ("multimap_probe", K10_SRC, f"{JOIN}:275"),
    "K10 compact": ("compact_pairs", K10_SRC, f"{JOIN}:165"),
}


class Failure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise Failure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_ms(torch, fn, reset=None, iters=20, warmup=3) -> float:
    """Mean CUDA-event time of fn(); `reset` (untimed) restores any state
    fn mutates before each run."""
    for _ in range(warmup):
        if reset is not None:
            reset()
        fn()
    total = 0.0
    for _ in range(iters):
        if reset is not None:
            reset()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def check_equal(name, a, b) -> None:
    """Bit for bit (floats compared as their bits, so NaN words match)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise Failure(f"{name}: kernel and plain version differ in shape or "
                      "type")
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    if not bool((a == b).all()):
        raise Failure(f"{name}: kernel and plain version differ")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


def kernel_phase(torch, rng, chunk_width_a: int) -> dict:
    from siddhi_tpu_torch.ops import groupby, search

    dev = torch.device("cuda")
    res = {}

    # K1: compaction of a batch (L = 131072) and a merge group (B + N)
    k1 = {}
    for L in (BATCH, BATCH + WINDOW):
        live = torch.from_numpy(rng.random(L) < 0.7).to(dev)
        got = search.stable_partition_order(live)
        check_equal(f"K1 L={L}", got, search.stable_partition_order_plain(live))
        k1[L] = dict(
            ms=time_ms(torch, lambda: search.stable_partition_order(live)),
            plain_ms=time_ms(
                torch, lambda: search.stable_partition_order_plain(live)),
            library_ms=time_ms(torch, lambda: torch.sort(
                (~live).to(torch.int32), stable=True)),
            bound_ms=bound_ms(L * 1 + L * 4))
        print(f"K1 stable_partition_order L={L}: {k1[L]}")
    res["K1"] = dict(k1[BATCH], max_abs_err=0, bound_by="bytes")

    # K3: one int64 key column of a full batch
    keys = torch.from_numpy(
        rng.integers(-(2**63), 2**63 - 1, BATCH, dtype=np.int64)).to(dev)
    check_equal("K3", groupby.hash_columns([keys]),
                groupby.hash_columns_plain([keys]))
    res["K3"] = dict(
        ms=time_ms(torch, lambda: groupby.hash_columns([keys])),
        plain_ms=time_ms(torch, lambda: groupby.hash_columns_plain([keys])),
        library_ms=None, bound_ms=bound_ms(BATCH * 8 * 2), max_abs_err=0,
        bound_by="bytes")
    print(f"K3 hash_columns n={BATCH}: {res['K3']}")

    # K4: H = 2^21 table (K = 2^20 ids) holding 2^19 keys, then a batch of
    # half present, half new keys
    table = groupby.init_key_table(GROUP_CAP, dev)
    pre = torch.from_numpy(rng.integers(0, 2**62, GROUP_CAP // 2,
                                        dtype=np.int64)).to(dev)
    ones = torch.ones(pre.shape[0], dtype=torch.bool, device=dev)
    table, _, ok = groupby.key_lookup_or_insert(table, pre, ones)
    present = pre[torch.from_numpy(
        rng.integers(0, pre.shape[0], BATCH // 2)).to(dev)]
    fresh = torch.from_numpy(rng.integers(2**62, 2**63 - 1, BATCH // 2,
                                          dtype=np.int64)).to(dev)
    batch_keys = torch.cat([present, fresh])[
        torch.from_numpy(rng.permutation(BATCH)).to(dev)].contiguous()
    valid = torch.from_numpy(rng.random(BATCH) < 0.95).to(dev)
    saved = [t.clone() for t in table]
    count0 = int(table.count)

    def restore():
        for t, s in zip(table, saved):
            t.copy_(s)

    restore()
    p_tab, p_ids, p_res = groupby.key_lookup_or_insert_plain(
        groupby.KeyTable(*[t.clone() for t in saved]), batch_keys, valid)
    restore()
    k_tab, k_ids, k_res = groupby.key_lookup_or_insert(table, batch_keys,
                                                       valid)
    for nm, a, b in (("keys", k_tab.keys, p_tab.keys),
                     ("ids", k_tab.ids, p_tab.ids),
                     ("count", k_tab.count, p_tab.count),
                     ("misses", k_tab.misses, p_tab.misses),
                     ("lane ids", k_ids, p_ids),
                     ("resolved", k_res, p_res)):
        check_equal(f"K4 {nm}", a, b)
    n_new = int(k_tab.count) - count0
    n_valid = int(valid.sum())
    # lane I/O (keys, valid, ids, resolved), one slot + id read per valid
    # lane, one slot + id write per new key
    k4_bytes = BATCH * (8 + 1 + 4 + 1) + n_valid * 12 + n_new * 12
    res["K4"] = dict(
        ms=time_ms(torch, lambda: groupby.key_lookup_or_insert(
            table, batch_keys, valid), reset=restore),
        plain_ms=time_ms(torch, lambda: groupby.key_lookup_or_insert_plain(
            table, batch_keys, valid), reset=restore),
        library_ms=None, bound_ms=bound_ms(k4_bytes), max_abs_err=0,
        bound_by="bytes")
    print(f"K4 key_lookup_or_insert H={2 * GROUP_CAP} prefilled="
          f"{count0} new={n_new}: {res['K4']}")

    # K5: one lengthBatch(10000) chunk of app A: 13 flushes of [RESET,
    # 10000 CURRENT], the rest invalid; three float32 components
    L = chunk_width_a
    flushes = BATCH // WINDOW
    types = np.full(L, -1)
    for f in range(flushes):
        types[f * (WINDOW + 1)] = 3
        types[f * (WINDOW + 1) + 1:(f + 1) * (WINDOW + 1)] = 0
    resets = torch.from_numpy(types == 3).to(dev)
    data_valid = torch.from_numpy(types == 0).to(dev)
    slots = torch.from_numpy(rng.integers(0, GROUP_CAP, L).astype(
        np.int32)).to(dev)
    price = torch.from_numpy(rng.uniform(1, 100, L).astype(np.float32)).to(dev)
    comps = [price, price.clone(), torch.ones(L, dtype=torch.float32, device=dev)]
    values0 = [torch.from_numpy(rng.uniform(0, 500, GROUP_CAP).astype(
        np.float32)).to(dev) for _ in comps]
    epoch0 = torch.from_numpy(rng.integers(0, 8, GROUP_CAP).astype(
        np.int32)).to(dev)
    cur_epoch = torch.tensor(5, dtype=torch.int32, device=dev)
    values = [v.clone() for v in values0]
    epoch = epoch0.clone()

    def restore5():
        for v, v0 in zip(values, values0):
            v.copy_(v0)
        epoch.copy_(epoch0)

    def run5():
        return groupby.grouped_scan_fused(values, epoch, slots, comps,
                                          data_valid, resets, cur_epoch)

    def plain5():
        return groupby.grouped_scan_fused_plain(values, epoch, slots, comps,
                                                data_valid, resets, cur_epoch)

    restore5()
    pv, pe, po = plain5()
    restore5()
    kv, ke, ko = run5()
    check_equal("K5 epoch", ke, pe)
    err = 0.0
    for a, b in list(zip(kv, pv)) + list(zip(ko, po)):
        if not torch.allclose(a, b, rtol=RTOL, atol=0):
            raise Failure("K5: float components beyond rtol 1e-5")
        err = max(err, float((a - b).abs().max()))
    # exactness of the int64 and float64 instantiations on the same plan
    for dt in (torch.int64, torch.float64):
        d = (price * 7).to(dt)
        v0 = torch.from_numpy(rng.integers(0, 500, GROUP_CAP)).to(dev).to(dt)
        a = groupby.grouped_scan_fused([v0.clone()], epoch0.clone(), slots,
                                       [d], data_valid, resets, cur_epoch)
        b = groupby.grouped_scan_fused_plain([v0.clone()], epoch0.clone(),
                                             slots, [d], data_valid, resets,
                                             cur_epoch)
        if dt == torch.int64:
            check_equal("K5 int64 values", a[0][0], b[0][0])
            check_equal("K5 int64 lanes", a[2][0], b[2][0])
        elif not (torch.allclose(a[0][0], b[0][0], rtol=1e-12, atol=0)
                  and torch.allclose(a[2][0], b[2][0], rtol=1e-12, atol=0)):
            raise Failure("K5 float64 beyond rtol 1e-12")
    touched = int(torch.unique(torch.where(data_valid, slots, -1)).numel()) - 1
    n_comp = len(comps)
    # slots, valid, resets, deltas in; lane outputs out; per touched slot
    # one value read + write per component and one epoch read + write
    k5_bytes = (L * (4 + 1 + 1) + n_comp * L * 4 * 2
                + touched * (n_comp * 8 + 8))
    res["K5"] = dict(
        ms=time_ms(torch, run5, reset=restore5),
        plain_ms=time_ms(torch, plain5, reset=restore5),
        library_ms=None, bound_ms=bound_ms(k5_bytes), max_abs_err=err,
        bound_by="bytes")
    print(f"K5 grouped_scan_fused L={L} comps={n_comp} K={GROUP_CAP}: "
          f"{res['K5']}")
    torch.cuda.synchronize()
    return res


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_float_scan(name, a, b) -> float:
    """A float32 sum scan against its plain version: the two add in other
    orders, so they differ by rounding of the running sums, not of each
    lane's value (a lane near a zero crossing holds far less than the sums
    it came from). Tolerance: rtol 1e-5 of the largest running value."""
    err = _err(a, b)
    scale = max(float(b.double().abs().max()), 1.0)
    if err > RTOL * scale:
        raise Failure(f"{name}: off by {err} (> {RTOL} x {scale})")
    return err


def _timed(torch, fn, plain, library=None, reset=None) -> dict:
    return dict(ms=time_ms(torch, fn, reset=reset),
                plain_ms=time_ms(torch, plain, reset=reset),
                library_ms=(time_ms(torch, library, reset=reset)
                            if library is not None else None))


def sliding_kernel_phase(torch, rng) -> tuple[dict, dict]:
    """K2b and K5b against their plain versions at the sliding apps'
    shapes; then the torch routes K2a, K6 and the K7 merge timed at their
    shapes. Returns (kernel results, torch-route results)."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops import windows as w

    dev = torch.device("cuda")
    res, routes = {}, {}
    B = E = C = BATCH
    layout = {"symbol": torch.int32, "price": torch.float32,
              "volume": torch.int64}
    W = w._layout_words(layout)  # 6 words for TradeStream
    cols = {"symbol": torch.from_numpy(rng.integers(1, C_SYMBOLS, B).astype(
                np.int32)).to(dev),
            "price": torch.from_numpy(rng.uniform(1, 100, B).astype(
                np.float32)).to(dev),
            "volume": torch.from_numpy(rng.integers(1, 1000, B)).to(dev)}
    ts = torch.arange(B, dtype=torch.int64, device=dev) + 1_700_000_000_000
    live = torch.from_numpy(rng.random(B) < 0.9).to(dev)
    order = search.stable_partition_order(live)
    n_live = int(live.sum())

    # pack-compact: read the typed columns, ts and K1's order, write [W, B]
    got = w.pack_compact(cols, ts, layout, order)
    check_equal("K2b pack", got, w.pack_compact_plain(cols, ts, layout,
                                                      order))
    res["K2b pack"] = dict(
        _timed(torch, lambda: w.pack_compact(cols, ts, layout, order),
               lambda: w.pack_compact_plain(cols, ts, layout, order)),
        bound_ms=bound_ms(B * (4 + 4 + 8 + 8 + 4) + W * 4 * B),
        max_abs_err=0, bound_by="bytes")
    comp = got

    # fetch at app C's steady state: the window holds 60000 rows of the
    # ring; the other candidates come from the batch (rel0 = 60000)
    ring0 = torch.from_numpy(rng.integers(-(2**31), 2**31, (W, C)).astype(
        np.int32)).to(dev)
    expired = torch.tensor(1_000_000, device=dev)
    appended = torch.tensor(1_000_000 + TIME_WINDOW_MS, device=dev)
    # the append lands across the ring's end: 1,120,000 % C + n_live > C
    append_at = torch.tensor(1_000_000 + 120_000, device=dev)
    if int(append_at) % C + n_live <= C:
        raise Failure("K2b append: the test position does not wrap")
    n_valid = torch.tensor(n_live, dtype=torch.int32, device=dev)
    check_equal("K2b fetch", w._fetch_rel_packed(ring0, comp, expired,
                                                 appended, E),
                w._fetch_rel_packed_plain(ring0, comp, expired, appended, E))
    ring_idx = torch.remainder(expired + torch.arange(E, device=dev), C)
    res["K2b fetch"] = dict(
        _timed(torch,
               lambda: w._fetch_rel_packed(ring0, comp, expired, appended,
                                           E),
               lambda: w._fetch_rel_packed_plain(ring0, comp, expired,
                                                 appended, E),
               library=lambda: ring0[:, ring_idx]),
        bound_ms=bound_ms(2 * W * 4 * E), max_abs_err=0, bound_by="bytes")

    # append at a wrapping position
    ring = ring0.clone()
    want = w._append_packed_plain(ring0, comp, append_at, n_valid)
    check_equal("K2b append", w._append_packed(ring, comp, append_at,
                                               n_valid), want)
    dest = torch.remainder(append_at + torch.arange(n_live, device=dev), C)
    comp_v = comp[:, :n_live].contiguous()

    def lib_append():
        ring[:, dest] = comp_v

    res["K2b append"] = dict(
        _timed(torch,
               lambda: w._append_packed(ring, comp, append_at, n_valid),
               lambda: w._append_packed_plain(ring, comp, append_at,
                                              n_valid),
               library=lib_append),
        bound_ms=bound_ms(2 * W * 4 * n_live), max_abs_err=0,
        bound_by="bytes")

    # chunk gather over E + B lanes by a permutation (random: no locality)
    L = E + B
    payload = torch.cat([ring0, comp], dim=1)
    perm = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    emit = torch.arange(L, dtype=torch.int64, device=dev)
    valid = torch.from_numpy(rng.random(L) < 0.5).to(dev)
    types = torch.from_numpy(rng.integers(0, 2, L).astype(np.int8)).to(dev)
    args = (perm, payload, emit, valid, types, layout)
    kb = w._gather_chunk_packed(*args)
    pb = w._gather_chunk_packed_plain(*args)
    for nm in ("ts", "valid", "types"):
        check_equal(f"K2b gather {nm}", getattr(kb, nm), getattr(pb, nm))
    for k in layout:
        check_equal(f"K2b gather {k}", kb.cols[k], pb.cols[k])
    perm64 = perm.long()
    res["K2b gather"] = dict(
        _timed(torch, lambda: w._gather_chunk_packed(*args),
               lambda: w._gather_chunk_packed_plain(*args),
               library=lambda: torch.index_select(payload, 1, perm64)),
        # order, the column words, emit ts, valid, type in; typed columns,
        # ts, valid, type out
        bound_ms=bound_ms(L * (4 + (W - 2) * 4 + 8 + 1 + 1)
                          + L * (4 + 4 + 8 + 8 + 1 + 1)),
        max_abs_err=0, bound_by="bytes")
    for k in ("K2b pack", "K2b fetch", "K2b append", "K2b gather"):
        print(f"{k} B=E=C={B} W={W}: {res[k]}")

    # K5b at the chunk width of the sliding apps, K = 2^20
    L, K = 2 * BATCH, GROUP_CAP
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(dev)
    resets = torch.zeros(L, dtype=torch.bool, device=dev)
    resets[torch.from_numpy(rng.choice(L, 3, replace=False)).to(dev)] = True
    valid &= ~resets
    no_resets = torch.zeros(L, dtype=torch.bool, device=dev)
    cur = torch.tensor(5, dtype=torch.int32, device=dev)
    deltas = {torch.int64: torch.from_numpy(rng.choice([-1, 1], L)).to(dev),
              torch.float32: torch.from_numpy(rng.uniform(
                  -100, 100, L).astype(np.float32)).to(dev)}
    epochs0 = torch.from_numpy(rng.integers(3, 7, K).astype(np.int32)).to(dev)
    grouped, ungrouped = {}, {}
    for dt, d in deltas.items():
        values0 = torch.from_numpy(rng.integers(0, 50, K)).to(dev).to(dt)
        for op in ("sum", "min", "max"):
            st = groupby.GroupState(values0.clone(), epochs0.clone())

            def restore(st=st, v0=values0):
                st.values.copy_(v0)
                st.epoch.copy_(epochs0)

            ps, po = groupby.grouped_scan_plain(
                groupby.GroupState(values0.clone(), epochs0.clone()), slots,
                d, valid, resets, cur, op)
            ks, ko = groupby.grouped_scan(st, slots, d, valid, resets, cur,
                                          op)
            check_equal(f"K5b grouped {op} {dt} epoch", ks.epoch, ps.epoch)
            err = 0.0
            for a, b in ((ks.values, ps.values), (ko, po)):
                if dt == torch.int64 or op != "sum":
                    check_equal(f"K5b grouped {op} {dt}", a, b)
                else:
                    err = max(err, check_float_scan(
                        f"K5b grouped {op} {dt}", a, b))
            grouped[(op, dt)] = dict(_timed(
                torch,
                lambda st=st, d=d, op=op: groupby.grouped_scan(
                    st, slots, d, valid, resets, cur, op),
                lambda st=st, d=d, op=op: groupby.grouped_scan_plain(
                    st, slots, d, valid, resets, cur, op),
                reset=restore), max_abs_err=err)
        for rs_name, rs in (("resets", resets), ("no resets", no_resets)):
            for op in ("sum", "max"):
                cell0 = values0[:1].clone()
                ep0 = torch.tensor([5], dtype=torch.int32, device=dev)
                st = groupby.GroupState(cell0.clone(), ep0.clone())

                def restore(st=st, c0=cell0, e0=ep0):
                    st.values.copy_(c0)
                    st.epoch.copy_(e0)

                ps, po = groupby.ungrouped_scan_plain(
                    groupby.GroupState(cell0.clone(), ep0.clone()), d, valid,
                    rs, cur, op)
                ks, ko = groupby.ungrouped_scan(st, d, valid, rs, cur, op)
                check_equal(f"K5b ungrouped {op} {rs_name} epoch", ks.epoch,
                            ps.epoch)
                err = 0.0
                for a, b in ((ks.values, ps.values), (ko, po)):
                    if dt == torch.int64 or op != "sum":
                        check_equal(f"K5b ungrouped {op} {dt} {rs_name}", a,
                                    b)
                    else:
                        err = max(err, check_float_scan(
                            f"K5b ungrouped {op} {dt} {rs_name}", a, b))
                lib = (lambda d=d: torch.cumsum(d, 0)) \
                    if (op == "sum" and rs is no_resets) else None
                ungrouped[(op, dt, rs_name)] = dict(_timed(
                    torch,
                    lambda st=st, d=d, rs=rs, op=op: groupby.ungrouped_scan(
                        st, d, valid, rs, cur, op),
                    lambda st=st, d=d, rs=rs, op=op:
                        groupby.ungrouped_scan_plain(st, d, valid, rs, cur,
                                                     op),
                    library=lib, reset=restore), max_abs_err=err)
    for (op, dt), r in grouped.items():
        print(f"K5b grouped_scan op={op} {dt} L={L} K={K}: {r}")
    for (op, dt, rs), r in ungrouped.items():
        print(f"K5b ungrouped_scan op={op} {dt} {rs} L={L}: {r}")
    # the path's instantiations: int64 sums (distinctCount's counts)
    touched = int(torch.unique(torch.where(valid, slots, -1)).numel()) - 1
    res["K5b grouped"] = dict(
        grouped[("sum", torch.int64)], bound_by="bytes",
        # slots, valid, resets, deltas in, outputs out; per touched slot
        # one value and one epoch read and written
        bound_ms=bound_ms(L * (4 + 1 + 1 + 8 + 8) + touched * (8 + 8 + 8)))
    res["K5b ungrouped"] = dict(
        ungrouped[("sum", torch.int64, "no resets")], bound_by="bytes",
        bound_ms=bound_ms(L * (1 + 1 + 8 + 8)))
    res["K5b ungrouped"]["max_abs_err"] = max(
        r["max_abs_err"] for r in ungrouped.values())
    res["K5b grouped"]["max_abs_err"] = max(
        r["max_abs_err"] for r in grouped.values())

    # K5 without GROUP BY at the same width: app F's three components
    # (float32 sum, int64 sum, int64 count) over one plan, no sort
    comps = [deltas[torch.float32], deltas[torch.int64] * 7,
             deltas[torch.int64]]
    cells0 = [torch.tensor([v], dtype=c.dtype, device=dev)
              for v, c in zip((1234.5, 999, 40), comps)]
    ep_cell0 = torch.tensor([5], dtype=torch.int32, device=dev)
    u_vals = [c.clone() for c in cells0]
    u_ep = ep_cell0.clone()

    def restore_u():
        for v, v0 in zip(u_vals, cells0):
            v.copy_(v0)
        u_ep.copy_(ep_cell0)

    err = 0.0
    for rs_name, rs in (("resets", resets), ("no resets", no_resets)):
        restore_u()
        kv, ke, ko = groupby.ungrouped_scan_fused(u_vals, u_ep, comps, valid,
                                                  rs, cur)
        pv, pe, po = groupby.ungrouped_scan_fused_plain(
            [v.clone() for v in cells0], ep_cell0.clone(), comps, valid, rs,
            cur)
        check_equal(f"K5 ungrouped {rs_name} epoch", ke, pe)
        for c in range(len(comps)):
            for a, b in ((kv[c], pv[c]), (ko[c], po[c])):
                if a.dtype == torch.int64:
                    check_equal(f"K5 ungrouped {rs_name} component {c}", a,
                                b)
                else:
                    err = max(err, check_float_scan(
                        f"K5 ungrouped {rs_name} component {c}", a, b))
    res["K5 ungrouped"] = dict(
        _timed(torch,
               lambda: groupby.ungrouped_scan_fused(u_vals, u_ep, comps,
                                                    valid, no_resets, cur),
               lambda: groupby.ungrouped_scan_fused_plain(
                   u_vals, u_ep, comps, valid, no_resets, cur),
               reset=restore_u),
        # valid and resets in; per component the deltas in, outputs out
        bound_ms=bound_ms(L * (1 + 1) + sum(2 * L * c.element_size()
                                            for c in comps)),
        max_abs_err=err, bound_by="bytes")
    print(f"K5 ungrouped_scan_fused L={L} comps={len(comps)}: "
          f"{res['K5 ungrouped']}")

    # torch routes: K2a ring ops at app A's shapes
    N = WINDOW
    Ca = 2 * N + BATCH
    ring_cols = {k: torch.zeros(Ca + 1, dtype=v.dtype, device=dev)
                 for k, v in cols.items()}
    ring_ts = torch.zeros(Ca + 1, dtype=torch.int64, device=dev)
    offs = torch.arange(BATCH + N, dtype=torch.int32, device=dev)
    base = torch.tensor(5 * N, device=dev)
    app0 = torch.tensor(5 * N + 3 * N // 2, device=dev)
    nv = torch.tensor(BATCH, dtype=torch.int32, device=dev)
    row = 4 + 4 + 8 + 8  # symbol, price, volume, ts
    routes["K2a _gather_rel"] = dict(
        ms=time_ms(torch, lambda: w._gather_rel(
            ring_cols, ring_ts, cols, ts, app0, base, offs)),
        bound_ms=bound_ms(2 * (BATCH + N) * row), shape=f"L={BATCH + N}")
    routes["K2a _scatter_append"] = dict(
        ms=time_ms(torch, lambda: w._scatter_append(
            ring_cols, ring_ts, cols, ts, app0, nv)),
        bound_ms=bound_ms(2 * BATCH * row), shape=f"B={BATCH} C={Ca}")
    # K6 at app C's shapes: the expiry trigger and the K5 sort
    sorted_ts = ts.contiguous()
    deadline = ts + 30_000
    routes["K6 searchsorted32"] = dict(
        ms=time_ms(torch, lambda: search.searchsorted32(sorted_ts, deadline)),
        bound_ms=bound_ms(BATCH * (8 + 8 + 4)), shape=f"{BATCH} into {BATCH}")
    sk = torch.where(valid, slots, K)
    routes["K6 stable_argsort_bounded"] = dict(
        ms=time_ms(torch, lambda: search.stable_argsort_bounded(sk)),
        bound_ms=bound_ms(L * (4 + 8)), shape=f"L={L}")
    # K7 merge of the sliding chunk: E expired + B current lanes
    pe = torch.arange(E, dtype=torch.int32, device=dev)
    pb = torch.arange(B, dtype=torch.int32, device=dev)
    keys = [(torch.clamp(pe * 2, 0, B) * 4, pe), (pb * 4 + 2, pb)]
    valids = [pe < E // 2 + 7000, pb < n_live]
    routes["K7 _merge_order"] = dict(
        ms=time_ms(torch, lambda: w._merge_order(keys, valids)),
        bound_ms=bound_ms((E + B) * (4 + 4 + 1 + 4)), shape=f"E={E} B={B}")
    for k, r in routes.items():
        print(f"{k}: {r}")
    torch.cuda.synchronize()
    return res, routes


# --------------------------------------------------------------------------- #
# phases 3-5: the apps and the oracle
# --------------------------------------------------------------------------- #


def make_events(rng, keyed_by_long: bool):
    n = BATCH * ROUNDS
    idx = rng.integers(0, N_KEYS, n)
    if keyed_by_long:
        ids = rng.choice(2**63 - 1, N_KEYS, replace=False).astype(np.int64)
        key = ids[idx]
    else:
        key = idx + 1  # symbol "S<k>", k in 1..1000000
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return key, price, volume, ts


def oracle(key, price32, ts, passed):
    """Running per-key sum/count inside each completed flush of WINDOW
    passing events, in arrival order (float64)."""
    sel = np.nonzero(passed)[0]
    n_full = (sel.shape[0] // WINDOW) * WINDOW
    sel = sel[:n_full]
    k, v = key[sel], price32[sel].astype(np.float64)
    total = np.empty(n_full)
    cnt = np.empty(n_full)
    for f in range(0, n_full, WINDOW):
        kk, vv = k[f:f + WINDOW], v[f:f + WINDOW]
        order = np.argsort(kk, kind="stable")
        ks, vs = kk[order], vv[order]
        start = np.r_[True, ks[1:] != ks[:-1]]
        seg = np.cumsum(start) - 1
        cs = np.cumsum(vs)
        base = (cs - vs)[start][seg]
        run = cs - base
        pos = np.arange(WINDOW)
        c = pos - pos[start][seg] + 1
        total[f + order] = run
        cnt[f + order] = c
    return sel, total, total / cnt, ts[sel]


def run_app(torch, text: str, columns: dict, ts,
            out_stream: str = "SummaryStream"):
    """Feed ROUNDS sends of BATCH events (send_columns + flush each) and
    collect the output stream's events."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch import kernels

    rt = SiddhiManager().create_siddhi_app_runtime(
        text, batch_size=BATCH, group_capacity=GROUP_CAP)
    got = []
    rt.add_callback(out_stream, got.extend)
    h = rt.get_input_handler("TradeStream")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(ROUNDS):
        s = slice(r * BATCH, (r + 1) * BATCH)
        h.send_columns({k: v[s] for k, v in columns.items()},
                       timestamps=ts[s])
        rt.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return rt, got, launches, elapsed, peak


def check_app(name, got, key_col, key, price, ts, passed, long_key):
    price32 = price.astype(np.float32)
    sel, total, avg, ots = oracle(key, price32, ts, passed)
    if len(got) != sel.shape[0]:
        raise Failure(f"app {name}: {len(got)} events out, oracle expects "
                      f"{sel.shape[0]}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, len(got))
    if not np.array_equal(g_ts, ots):
        raise Failure(f"app {name}: timestamps differ from the oracle")
    g_key = [e.data[0] for e in got]
    exp_key = key[sel].tolist() if long_key else key_col[sel].tolist()
    if g_key != exp_key:
        raise Failure(f"app {name}: group keys differ from the oracle")
    g_tot = np.fromiter((e.data[1] for e in got), np.float64, len(got))
    g_avg = np.fromiter((e.data[2] for e in got), np.float64, len(got))
    for what, g, o in (("total", g_tot, total), ("avgPrice", g_avg, avg)):
        if not np.allclose(g, o, rtol=RTOL, atol=0):
            bad = np.max(np.abs(g - o) / np.abs(o))
            raise Failure(f"app {name}: {what} off by rel {bad:.3g}")
    return len(got)


# ---- the sliding apps' data and oracles ------------------------------------


def symbols(n_pool: int) -> np.ndarray:
    return np.array([f"S{k}" for k in range(1, n_pool + 1)], dtype=object)


def sliding_events(rng, n_symbols: int):
    """symbol index uniform over n_symbols, price 1-100, volume 1-999,
    timestamps 1 ms apart."""
    n = BATCH * ROUNDS
    sym = rng.integers(0, n_symbols, n)
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return sym, price, volume, ts


def next_same(key: np.ndarray) -> np.ndarray:
    """Index of the next event with the same key (n where there is none)."""
    n = key.shape[0]
    order = np.argsort(key, kind="stable")
    nxt = np.full(n, n, dtype=np.int64)
    same = key[order[1:]] == key[order[:-1]]
    nxt[order[:-1][same]] = order[1:][same]
    return nxt


def distinct_in_window(key: np.ndarray, span: int) -> np.ndarray:
    """Per event i, the distinct keys among events [i - span + 1, i]: event
    j counts for i in [j, min(next_same(j), j + span)) as its key's last
    occurrence in the window."""
    n = key.shape[0]
    end = np.minimum(next_same(key), np.arange(n) + span)
    diff = (np.bincount(np.arange(n), minlength=n + 1)
            - np.bincount(end, minlength=n + 1))
    return np.cumsum(diff)[:n]


def oracle_c(sym: np.ndarray) -> np.ndarray:
    return distinct_in_window(sym, TIME_WINDOW_MS)


def oracle_d(sym: np.ndarray, price32: np.ndarray):
    """Per event, the running sum and count of its symbol over the last
    LENGTH_D events, inclusive (float64)."""
    n = sym.shape[0]
    idx = np.arange(n, dtype=np.int64)
    order = np.lexsort((idx, sym))
    ks = sym[order].astype(np.int64)
    comb = ks * n + idx[order]
    cs = np.cumsum(price32[order].astype(np.float64))
    lo = np.maximum(np.searchsorted(comb, comb - LENGTH_D, side="right"),
                    np.searchsorted(comb, ks * n, side="left"))
    q = np.arange(n)
    total = cs - np.where(lo > 0, cs[np.maximum(lo - 1, 0)], 0.0)
    count = q - lo + 1
    out_t = np.empty(n)
    out_c = np.empty(n, dtype=np.int64)
    out_t[order] = total
    out_c[order] = count
    return out_t, out_c


def oracle_f(price32: np.ndarray, volume: np.ndarray):
    """Per event, the sum of price (float64), the sum of volume and the
    count over the last LENGTH_D events, inclusive."""
    n = price32.shape[0]
    lo = np.maximum(np.arange(n) - LENGTH_D, -1)

    def window_sum(x):
        cs = np.concatenate([[0], np.cumsum(x)])
        return cs[1:] - cs[lo + 1]

    return (window_sum(price32.astype(np.float64)), window_sum(volume),
            np.arange(n) - lo)


def oracle_e(sym: np.ndarray, volume: np.ndarray) -> np.ndarray:
    """Per event, the distinct volumes of its symbol among the events of
    the last TIME_WINDOW_MS ms: pair (symbol, volume) j counts for the
    symbol's events in [j, min(next pair j, j + span)), counted along the
    symbol's own event list."""
    n = sym.shape[0]
    idx = np.arange(n, dtype=np.int64)
    pair = sym.astype(np.int64) * 1000 + volume
    end = np.minimum(next_same(pair), idx + TIME_WINDOW_MS)
    order = np.lexsort((idx, sym))
    comb = sym[order].astype(np.int64) * n + idx[order]
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    end_pos = np.searchsorted(comb, sym.astype(np.int64) * n + end,
                              side="left")
    # a -1 landing on the next symbol's first position cancels against the
    # surplus of this symbol's open intervals, so one global cumsum serves
    diff = (np.bincount(pos, minlength=n + 1)
            - np.bincount(end_pos, minlength=n + 1))
    out = np.empty(n, dtype=np.int64)
    out[order] = np.cumsum(diff)[:n]
    return out


def check_sliding(name: str, got, ts, expect_cols: list) -> int:
    """Every output event against the oracle: timestamps and the columns
    in `expect_cols` ((what, values, float?)), in arrival order."""
    n = ts.shape[0]
    if len(got) != n:
        raise Failure(f"app {name}: {len(got)} events out, expected {n}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, n)
    if not np.array_equal(g_ts, ts):
        raise Failure(f"app {name}: timestamps differ from the oracle")
    for i, (what, want, is_float) in enumerate(expect_cols):
        if isinstance(want, list):
            if [e.data[i] for e in got] != want:
                raise Failure(f"app {name}: {what} differs from the oracle")
            continue
        g = np.fromiter((e.data[i] for e in got),
                        np.float64 if is_float else np.int64, n)
        if is_float:
            ok = np.isclose(g, want, rtol=RTOL, atol=ATOL_SLIDING)
        else:
            ok = g == want
        if not ok.all():
            j = int(np.argmin(ok))
            raise Failure(f"app {name}: {what} of event {j} is {g[j]}, the "
                          f"oracle says {want[j]}")
    return n


def measure_steps(torch, rt, columns: dict, ts, fresh: bool = False):
    """The query step alone (no ingest, no output decode) over the app's
    rounds, as device batches prepared beforehand, each at its round's
    event time. `fresh` restarts from the query's initial state, so a
    sliding window sees the same traffic as in the app run. Returns (where
    one step syncs with the host under torch.cuda.set_sync_debug_mode(
    'warn'), one "file:line" per synchronizing call; mean ms per step)."""
    from siddhi_tpu_torch.core.event import EventBatch

    qr = rt.query_runtimes["bench"]
    j = rt.junctions["TradeStream"]
    batches, nows = [], []
    for r in range(ROUNDS):
        s = slice(r * BATCH, (r + 1) * BATCH)
        cols = j.codec.encode_columns({k: v[s] for k, v in columns.items()},
                                      BATCH)
        batches.append(EventBatch.from_numpy(ts[s], cols, BATCH,
                                             j.ctx.device))
        nows.append(int(ts[s].max()))
    dev = j.ctx.device

    def restart():
        qr.state = (qr.window.init_state(dev), qr.selector.init_state(dev),
                    qr.rate_limiter.init_state(dev))

    if fresh:
        restart()
    syncs = []

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()
                    if "siddhi_tpu_torch" in f.filename]
            site = f"{filename.rsplit('/', 1)[-1]}:{lineno}"
            if ours:
                site += (f" from {ours[-1].filename.rsplit('/', 1)[-1]}:"
                         f"{ours[-1].lineno}")
            syncs.append(site)

    # switch the mode once outside the capture: the first switch in a
    # process syncs by itself, outside any step
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            qr.state, _ = qr.step(qr.state, batches[0], nows[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if fresh:
        restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, now in zip(batches, nows):
        qr.state, _ = qr.step(qr.state, b, now)
    torch.cuda.synchronize()
    return syncs, (time.perf_counter() - t0) / ROUNDS * 1e3


def report_app(name, n_in, n_out, elapsed, step_ms, peak, launches, syncs,
               card, rounds=ROUNDS, batch=BATCH) -> None:
    print(f"app {name}: {n_in} events in, {n_out} out, matches the oracle; "
          f"{n_in / elapsed:.1f} events/s end to end "
          f"({elapsed * 1e3 / rounds:.3f} ms per {batch}-event round); "
          f"query step alone {step_ms:.3f} ms per round; peak device memory "
          f"{peak / 2**20:.1f} MiB; kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }; host syncs in one "
          f"step: {len(syncs)} {syncs} [{card}]")


def sliding_apps(torch, rng, card: str) -> dict:
    """Apps C, D, E and F against their oracles; returns their
    launches."""
    k2b = ("K2b pack", "K2b fetch", "K2b append", "K2b gather")
    on_path = {"C": ("K1", *k2b, "K5b grouped", "K5b ungrouped"),
               "D": ("K1", *k2b, "K5"),
               "E": ("K1", *k2b, "K3", "K4", "K5b grouped"),
               "F": ("K1", *k2b, "K5 ungrouped")}
    total = {}
    for name, text, n_sym in (("C", APP_C, C_SYMBOLS),
                              ("D", APP_D, N_KEYS),
                              ("E", APP_E, E_SYMBOLS),
                              ("F", APP_F, E_SYMBOLS)):
        sym, price, volume, ts = sliding_events(rng, n_sym)
        pool = symbols(n_sym)
        columns = {"symbol": pool[sym], "price": price, "volume": volume}
        rt, got, launches, elapsed, peak = run_app(torch, text, columns, ts,
                                                   out_stream="OutStream")
        if name == "C":
            expect = [("distinctSymbols", oracle_c(sym), False)]
        elif name == "D":
            total_d, count_d = oracle_d(sym, price.astype(np.float32))
            expect = [("symbol", columns["symbol"].tolist(), False),
                      ("total", total_d, True), ("n", count_d, False)]
        elif name == "E":
            expect = [("symbol", columns["symbol"].tolist(), False),
                      ("n", oracle_e(sym, volume), False)]
        else:
            total_f, vol_f, count_f = oracle_f(price.astype(np.float32),
                                               volume)
            expect = [("total", total_f, True), ("vol", vol_f, False),
                      ("n", count_f, False)]
        n_out = check_sliding(name, got, ts, expect)
        del got
        for k in on_path[name]:
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        syncs, step_ms = measure_steps(torch, rt, columns, ts, fresh=True)
        report_app(name, ts.shape[0], n_out, elapsed, step_ms, peak,
                   launches, syncs, card)
        del rt
    return total


# --------------------------------------------------------------------------- #
# phases 8-9: the join kernels and app G
# --------------------------------------------------------------------------- #


def _check_state(name, a, b) -> None:
    for f, x, y in zip(a._fields, a, b):
        check_equal(f"{name} {f}", x, y)


def _build_multimap(torch, rng, start: int, n_batches: int):
    """A K10 multimap over a LENGTH_G ring after n_batches app-G batches
    (97% live) from overall index `start`, by the kernel and by the plain
    version, checked bit for bit after every batch. Returns (state, its
    plain twin, next overall index, the last batch's inputs)."""
    from siddhi_tpu_torch.ops import groupby, join

    dev = torch.device("cuda")
    kmm = join.multimap_init(LENGTH_G, BUCKETS_G, dev)
    pmm = join.multimap_init(LENGTH_G, BUCKETS_G, dev)
    appended = start
    for i in range(n_batches):
        keys = torch.from_numpy(rng.integers(1, LENGTH_G + 1, BATCH_G).astype(
            np.int32)).to(dev)
        hashes = groupby.hash_columns32_plain([keys], remap=True)
        live = torch.from_numpy(rng.random(BATCH_G) < 0.97).to(dev)
        a0 = torch.tensor(appended, device=dev)
        if i == n_batches - 1:
            last = (hashes, live, a0, [t.clone() for t in kmm])
        kmm = join.multimap_append(kmm, hashes, live, a0)
        pmm = join.multimap_append_plain(pmm, hashes, live, a0)
        _check_state(f"K10 append (batch {i})", kmm, pmm)
        appended += int(live.sum())
    return kmm, pmm, appended, last


def _probe_walk(torch, mm, hashes, valid, appended, wlen, k_max):
    """(chain entries a probe reads, lanes) for the byte bound: the entries
    each lane's walk visits, truncation probe included."""
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


def join_kernel_phase(torch, rng) -> dict:
    """K3b and the three K10 kernels against their plain versions at app
    G's shapes, bit for bit, with their timings."""
    from siddhi_tpu_torch.ops import groupby, join

    dev = torch.device("cuda")
    res = {}
    B, C, H, K = BATCH_G, LENGTH_G, BUCKETS_G, K_MAX
    P = B * K

    # K3b: app G's key column, as _hash_exprs hashes it (remap), and with
    # the build side's validity mask
    keys = torch.from_numpy(rng.integers(1, C + 1, B).astype(np.int32)).to(
        dev)
    valid = torch.from_numpy(rng.random(B) < 0.9).to(dev)
    sentinel = torch.tensor([0x96825014 - 2**32], dtype=torch.int32,
                            device=dev)  # mixes to 0xFFFFFFFF
    for args in (([keys], True, None), ([keys], True, valid),
                 ([keys], False, None), ([sentinel], True, None)):
        check_equal("K3b", groupby.hash_columns32(*args),
                    groupby.hash_columns32_plain(*args))
    res["K3b"] = dict(
        _timed(torch, lambda: groupby.hash_columns32([keys], True),
               lambda: groupby.hash_columns32_plain([keys], True)),
        bound_ms=bound_ms(B * 4 + B * 4), max_abs_err=0, bound_by="bytes")
    print(f"K3b hash_columns32 n={B}, one int column: {res['K3b']}")

    # K10 append: 30 batches wrap the 100000-slot ring more than twice
    n_batches = 30
    kmm, pmm, appended, (h, live, a0, before) = _build_multimap(
        torch, rng, 0, n_batches)
    if appended < 2 * C + B:
        raise Failure("K10 append: the ring did not wrap twice")
    state = [t.clone() for t in before]
    mm = join.MultimapState(*state)

    def restore():
        for t, t0 in zip(state, before):
            t.copy_(t0)

    n_live = int(live.sum())
    runs = int(torch.unique(h[live] & (H - 1)).numel())
    res["K10 append"] = dict(
        _timed(torch, lambda: join.multimap_append(mm, h, live, a0),
               lambda: join.multimap_append_plain(mm, h, live, a0),
               reset=restore),
        # hashes and live in; three words out per live row; one old head
        # read and one head written per bucket run
        bound_ms=bound_ms(B * (4 + 1) + n_live * 12 + runs * 8),
        max_abs_err=0, bound_by="bytes")
    print(f"K10 multimap_append B={B} C={C} H={H} (ring wrapped "
          f"{appended // C} times): {res['K10 append']}")

    # K10 probe: app G's probe batch against the full window; then against
    # a state whose tags cross 2^32 (the u32 ages wrap)
    pkeys = torch.from_numpy(rng.integers(1, C + 1, B).astype(np.int32)).to(
        dev)
    ph = groupby.hash_columns32([pkeys], True)
    pvalid = torch.from_numpy(rng.random(B) < 0.99).to(dev)
    app_t = torch.tensor(appended, device=dev)
    wlen = torch.tensor(C, device=dev)
    # start so that the last tags pass 2^32 by about half a window
    wstart = 2**32 - n_batches * B * 97 // 100 + C // 2
    wmm, _, wapp, _ = _build_multimap(torch, rng, wstart, n_batches)
    if not 2**32 < wapp < 2**32 + C:
        raise Failure("K10 probe: the tags do not cross 2^32")
    cases = ((kmm, app_t, "appended < 2^32"),
             (wmm, torch.tensor(wapp, device=dev), "appended past 2^32"))
    for m, a, what in cases:
        for wl in (wlen, torch.tensor(C // 3, device=dev)):
            got = join.multimap_probe(m, ph, pvalid, a, wl, K)
            want = join.multimap_probe_plain(m, ph, pvalid, a, wl, K)
            for nm, x, y in zip(("cand_pos", "cand_ok", "truncated"), got,
                                want):
                check_equal(f"K10 probe {what} {nm}", x, y)
    n_cand = int(join.multimap_probe(kmm, ph, pvalid, app_t, wlen,
                                     K)[1].sum())
    visited = _probe_walk(torch, kmm, ph, pvalid, app_t, C, K)
    res["K10 probe"] = dict(
        _timed(torch, lambda: join.multimap_probe(kmm, ph, pvalid, app_t,
                                                  wlen, K),
               lambda: join.multimap_probe_plain(kmm, ph, pvalid, app_t,
                                                 wlen, K)),
        # hash, valid and a head per lane; 12 bytes per chain entry the
        # walks visit; the [B, K] candidates out
        bound_ms=bound_ms(B * (4 + 1 + 4) + visited * 12 + P * (4 + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K10 multimap_probe B={B} k_max={K}: {n_cand} candidates, "
          f"{visited} chain entries read: {res['K10 probe']}")

    # K10 compact: P candidates into pair_cap, at app G's density (~1
    # match a probe) and past pair_cap
    lane = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(
        B, K).reshape(-1)
    row = torch.from_numpy(rng.integers(0, C, P).astype(np.int32)).to(dev)
    dense = torch.from_numpy(rng.random(P) < 0.4).to(dev)
    if int(dense.sum()) <= PAIR_CAP_G:
        raise Failure("K10 compact: the overflow case does not overflow")
    sparse = torch.from_numpy(rng.random(P) < 1 / K).to(dev)
    for nm, pv in (("past pair_cap", dense), ("app G density", sparse)):
        got = join.compact_pairs(lane, row, pv, PAIR_CAP_G)
        want = join.compact_pairs_plain(lane, row, pv, PAIR_CAP_G)
        for part, x, y in zip(("lane", "row", "valid"), got, want):
            check_equal(f"K10 compact {nm} {part}", x, y)
    kept = min(int(sparse.sum()), PAIR_CAP_G)

    def library():
        idx = sparse.nonzero().squeeze(1)[:PAIR_CAP_G]
        return lane.index_select(0, idx), row.index_select(0, idx)

    res["K10 compact"] = dict(
        _timed(torch,
               lambda: join.compact_pairs(lane, row, sparse, PAIR_CAP_G),
               lambda: join.compact_pairs_plain(lane, row, sparse,
                                                PAIR_CAP_G),
               library=library),
        # lanes, rows and valid in; pair_cap lanes, rows and valid out
        bound_ms=bound_ms(P * (4 + 4 + 1) + PAIR_CAP_G * (4 + 4 + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K10 compact_pairs P={P} pair_cap={PAIR_CAP_G} kept={kept}: "
          f"{res['K10 compact']}")
    torch.cuda.synchronize()
    return res


def join_events(rng):
    """App G's feed: per side, keys uniform over 1..LENGTH_G, values
    uniform on [1, 100); round r's left batch then its right batch, 1 ms
    apart."""
    n = BATCH_G * ROUNDS_G
    k = {s: rng.integers(1, LENGTH_G + 1, n).astype(np.int32)
         for s in ("L", "R")}
    v = {s: rng.uniform(1.0, 100.0, n) for s in ("L", "R")}
    base = 1_700_000_000_000
    r = np.arange(n) // BATCH_G
    i = np.arange(n) % BATCH_G
    ts = {"L": base + (2 * r) * BATCH_G + i,
          "R": base + (2 * r + 1) * BATCH_G + i}
    return k, v, {s: t.astype(np.int64) for s, t in ts.items()}


def oracle_g(k, v, ts):
    """Per probe event in arrival order, the equal-key rows among the
    other side's last LENGTH_G arrivals, oldest first: (k, lv, rv, ts) as
    the port stores the values (float32), and the largest match count."""
    v32 = {s: v[s].astype(np.float32).astype(np.float64) for s in v}
    out_k, out_lv, out_rv, out_ts = [], [], [], []
    most = 0
    for r in range(ROUNDS_G):
        for probe, build in (("L", "R"), ("R", "L")):
            lo = r * BATCH_G
            n_build = lo + (BATCH_G if probe == "R" else 0)
            start = max(0, n_build - LENGTH_G)
            wk = k[build][start:n_build]
            order = np.argsort(wk, kind="stable")
            sk = wk[order]
            pk = k[probe][lo:lo + BATCH_G]
            a = np.searchsorted(sk, pk, side="left")
            cnt = np.searchsorted(sk, pk, side="right") - a
            most = max(most, int(cnt.max()) if cnt.size else 0)
            rep = np.repeat(np.arange(BATCH_G), cnt)
            offs = np.arange(rep.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            brow = start + order[a[rep] + offs]
            prow = lo + rep
            out_k.append(pk[rep])
            out_ts.append(ts[probe][prow])
            pv, bv = v32[probe][prow], v32[build][brow]
            out_lv.append(pv if probe == "L" else bv)
            out_rv.append(bv if probe == "L" else pv)
    cat = np.concatenate
    return cat(out_k), cat(out_lv), cat(out_rv), cat(out_ts), most


def run_join_app(torch, k, v, ts):
    from siddhi_tpu_torch import SiddhiManager, kernels

    rt = SiddhiManager().create_siddhi_app_runtime(APP_G, batch_size=BATCH_G)
    got = []
    rt.add_callback("OutStream", got.extend)
    hs = {"L": rt.get_input_handler("LeftStream"),
          "R": rt.get_input_handler("RightStream")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(ROUNDS_G):
        s = slice(r * BATCH_G, (r + 1) * BATCH_G)
        for side in ("L", "R"):
            hs[side].send_columns({"k": k[side][s], "v": v[side][s]},
                                  timestamps=ts[side][s])
            rt.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return rt, got, launches, elapsed, peak


def measure_join_steps(torch, rt, k, v, ts):
    """Both join steps alone over app G's rounds from a fresh state, as
    device batches prepared beforehand; (host syncs in one left and one
    right step, mean ms per round)."""
    from siddhi_tpu_torch.core.event import EventBatch

    jr = rt.query_runtimes["bench"]
    codecs = {"L": rt.junctions["LeftStream"].codec,
              "R": rt.junctions["RightStream"].codec}
    dev = torch.device("cuda")
    rounds = []
    for r in range(ROUNDS_G):
        s = slice(r * BATCH_G, (r + 1) * BATCH_G)
        rounds.append([
            (EventBatch.from_numpy(ts[side][s], codecs[side].encode_columns(
                {"k": k[side][s], "v": v[side][s]}, BATCH_G), BATCH_G, dev),
             int(ts[side][s].max()))
            for side in ("L", "R")])
    syncs = []

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "synchroniz" in str(message):
            syncs.append(f"{filename.rsplit('/', 1)[-1]}:{lineno}")

    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    jr.state = jr.init_state()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for (b, now), step in zip(rounds[0], (jr._step_left,
                                                  jr._step_right)):
                jr.state, _, _ = step(jr.state, b, now)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    jr.state = jr.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (bl, nl), (br, nr) in rounds:
        jr.state, _, _ = jr._step_left(jr.state, bl, nl)
        jr.state, _, _ = jr._step_right(jr.state, br, nr)
    torch.cuda.synchronize()
    return syncs, (time.perf_counter() - t0) / ROUNDS_G * 1e3


def join_app(torch, rng, card: str) -> dict:
    """App G against its oracle; returns its launches."""
    k, v, ts = join_events(rng)
    want_k, want_lv, want_rv, want_ts, most = oracle_g(k, v, ts)
    if most > K_MAX:
        raise Failure(f"app G: a probe has {most} matches, past k_max")
    rt, got, launches, elapsed, peak = run_join_app(torch, k, v, ts)
    n = want_ts.shape[0]
    if len(got) != n:
        raise Failure(f"app G: {len(got)} events out, the oracle expects {n}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, n)
    g = [np.fromiter((e.data[i] for e in got),
                     np.int64 if i == 0 else np.float64, n) for i in range(3)]
    del got
    for what, a, b in (("timestamp", g_ts, want_ts), ("k", g[0], want_k),
                       ("lv", g[1], want_lv), ("rv", g[2], want_rv)):
        bad = np.nonzero(a != b)[0]
        if bad.size:
            j = int(bad[0])
            raise Failure(f"app G: {what} of event {j} is {a[j]}, the oracle "
                          f"says {b[j]}")
    dropped = rt.query_runtimes["bench"]._dropped_dev
    if dropped is not None and int(dropped) != 0:
        raise Failure(f"app G: {int(dropped)} pairs dropped")
    for kname in ("K1", "K2b pack", "K2b fetch", "K2b append", "K2b gather",
                  "K3b", "K10 append", "K10 probe", "K10 compact"):
        if launches[kname] == 0:
            raise Failure(f"app G: kernel {kname} never launched")
    syncs, step_ms = measure_join_steps(torch, rt, k, v, ts)
    report_app("G", 2 * BATCH_G * ROUNDS_G, n, elapsed, step_ms, peak,
               launches, syncs, card, rounds=ROUNDS_G,
               batch=f"2 x {BATCH_G}")
    if syncs:
        raise Failure(f"app G: the join step syncs with the host: {syncs}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 3
    try:
        from siddhi_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke.py: the siddhi_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    try:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        t0 = time.perf_counter()
        logs = kernels.build_all()
        print(f"built {len(logs)} kernel libraries in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            print(f"--- nvcc -Xptxas -v: {name}\n{log.strip()}")

        rng = np.random.default_rng(args.seed)
        from siddhi_tpu_torch.ops.windows import LengthBatchWindow
        width_a = LengthBatchWindow({}, BATCH, WINDOW,
                                    expired_on=False).chunk_width
        kres = kernel_phase(torch, rng, width_a)

        launches = {k: 0 for k in KERNELS}
        on_path = {"A": ("K1", "K5"), "B": ("K1", "K3", "K4", "K5")}
        for name, text, long_key in (("A", APP_A, False), ("B", APP_B, True)):
            key, price, volume, ts = make_events(rng, long_key)
            key_col = key if long_key else np.array(
                [f"S{k}" for k in key], dtype=object)
            columns = {("account" if long_key else "symbol"): key_col,
                       "price": price, "volume": volume}
            rt, got, app_launches, elapsed, peak = run_app(
                torch, text, columns, ts)
            passed = (price.astype(np.float32) > np.float32(20.0)
                      if long_key else np.ones(key.shape[0], bool))
            n_out = check_app(name, got, key_col, key, price, ts, passed,
                              long_key)
            for k in on_path[name]:
                if app_launches[k] == 0:
                    raise Failure(f"app {name}: kernel {k} never launched")
            for k in launches:
                launches[k] += app_launches[k]
            syncs, step_ms = measure_steps(torch, rt, columns, ts)
            report_app(name, key.shape[0], n_out, elapsed, step_ms, peak,
                       app_launches, syncs, card)
            del rt, got

        sres, routes = sliding_kernel_phase(torch, rng)
        kres.update(sres)
        print("torch routes: " + json.dumps(routes))
        for k, v in sliding_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(join_kernel_phase(torch, rng))
        for k, v in join_app(torch, rng, card).items():
            launches[k] += v

        table = []
        for k, (fn, src, replaces) in KERNELS.items():
            r = kres[k]
            table.append({"name": f"{k} {fn}", "route": "cuda",
                          "source": src, "replaces": replaces,
                          "launches": launches[k],
                          "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                          "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"],
                          "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": table}))
        print(f"card: {card}")
    except Failure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
