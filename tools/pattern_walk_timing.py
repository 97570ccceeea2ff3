"""Device times of K11a (`first_match`, pattern mode), K11c
(`absent_scan`), K11d (`match_count`) and K13a (both walks) for one tree
of the port, at their main-path shapes: K11a on app H's and app I's data
(B = 32,768 arrivals against P = 131,072 pending slots, 45% of them
live), with and without a residual mask; K11c at app O's shape (app I's
data, a deadline each side of the batch) and K11d at app P's (`within`
5 s), each also on values over 1..4 and with no equality (long runs);
K13a on app X's two conditions (`sum(volume) <= 5000000` over a
~99,000-row window, `sum(price) < 10000.0` with the trigger included),
B = 131,072, and both walks on a condition false on every check (their
worst case); K2b's chunk gather beside `index_select` (dim 1). Each row
gives the call's time on the device alone (`chip_smoke.device_ms`: calls
behind a spin kernel, L2 flushed), the launches of one call, the bound
(bytes at 3.35 TB/s: each input read once, each output written once;
K11c and K11d also the bytes their index design moves, `design_ms`) and
the outputs' digest, so two trees can be seen to agree. Then apps O's
and P's query steps (`chip_smoke.measure_pattern_steps`: 16 rounds of
one A and one B step of 32,768 events, host clock, card synchronised),
three runs each, with the digest of the app's output events.

The tree is imported from `--root` (its `siddhi_tpu_torch` and its
`chip_smoke.py`), so two trees compare on one card in one command, in
turns:

    for t in old new new old; do
        python3 tools/pattern_walk_timing.py --root $t --label $t \\
            >> pattern_walk.jsonl
    done
    python3 tools/scan_sort_timing.py --summarize pattern_walk.jsonl

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
B_P, P_P, FILL = 32_768, 131_072, 0.45
WITHIN = 5_000
VALUES_I = 100_000
B_X = 131_072
X_VOLUME, X_PRICE = 5_000_000, 10_000.0


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def pattern_case(torch, rng, app: str, seq0: int = 5_000_000):
    """A B step of app H or I against a pending table FILL full: H's values
    are unique per lane (a batch of arange, entries drawn around it, about
    half with their match), I's uniform over 1..VALUES_I; ts as the apps'
    B side, last_seq mostly before the batch and some inside it, start_ts
    so that `within` cuts some."""
    dev = torch.device("cuda")
    B, P = B_P, P_P
    if app == "H":
        valid = np.ones(B, bool)
        v0 = 7 * B
        bval = np.arange(v0, v0 + B).astype(np.int32)
        eval_ = rng.integers(v0 - B, v0 + B, P).astype(np.int32)
    else:
        valid = rng.random(B) < 0.97
        bval = rng.integers(1, VALUES_I + 1, B).astype(np.int32)
        eval_ = rng.integers(1, VALUES_I + 1, P).astype(np.int32)
    arr_seq = np.where(valid, seq0 + np.cumsum(valid) - 1, 2**62)
    ts = (3000 * 7 + 1000 + np.arange(B) // 64).astype(np.int64)
    pend_valid = rng.random(P) < FILL
    inside = rng.random(P) < 0.1
    last_seq = np.where(inside, seq0 + rng.integers(-1, B, P),
                        seq0 - 1 - rng.integers(0, 10**6, P))
    start_ts = ts[0] - rng.integers(0, 5600, P)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in (
        ("valid", valid), ("arr_seq", arr_seq.astype(np.int64)),
        ("ts", ts), ("bval", bval), ("pend_valid", pend_valid),
        ("last_seq", last_seq.astype(np.int64)),
        ("start_ts", start_ts.astype(np.int64)), ("eval", eval_))}
    t["seq0"] = torch.tensor(seq0, dtype=torch.int64, device=dev)
    return t


def run_bytes(t, key_b, key_e, live) -> float:
    """The positions K11c and K11d's probes read for this batch: per live
    entry a binary search (log2 B + 1 positions) and its run past last_seq
    (K11c stops earlier once its outputs are decided, so for K11c this
    bounds it), 17 bytes a position (ok, seq or ts) plus 8 a key."""
    B = t["arr_seq"].shape[0]
    ok = t["valid"].cpu().numpy()
    seq = t["arr_seq"].cpu().numpy()[ok]
    base = int(seq.min()) if seq.size else 0
    kb = (np.zeros(ok.sum(), np.int64) if key_b is None
          else key_b.cpu().numpy()[ok].astype(np.int64))
    pair = np.sort(kb * 2**33 + (seq - base))
    e = live.cpu().numpy()
    ke = (np.zeros(e.sum(), np.int64) if key_e is None
          else key_e.cpu().numpy()[e].astype(np.int64))
    ls = np.clip(t["last_seq"].cpu().numpy()[e] - base, -1, 2**33 - 1)
    past = (np.searchsorted(pair, ke * 2**33 + 2**33 - 1, "right")
            - np.searchsorted(pair, ke * 2**33 + ls, "right"))
    n_key = 0 if key_b is None else 1
    walked = e.sum() * (np.ceil(np.log2(B)) + 1) + past.sum()
    return float(walked * (17 + 8 * n_key))


def design_bound_ms(B: int, P: int, n_eq: int, probe_bytes: float,
                    out_bytes: int) -> float:
    """The bytes the index design moves: K7 one int32 sort an equality
    column (4 passes, key and id read and written, 16 bytes a lane a
    pass), K1 (1 byte read, 4 written a lane), the gather (order, arr_seq,
    ts, lane_ok, 4 a key read; the index, 21 + 8 a key a lane, written),
    the entries (17 + 4 a key read, `out_bytes` written) and the probes'
    positions, each once."""
    per_lane = n_eq * 64 + 5 + (4 + 8 + 8 + 1 + 4 * n_eq) + 21 + 8 * n_eq
    return bound_ms(B * per_lane + P * (17 + 4 * n_eq + out_bytes)
                    + probe_bytes)


def probe_rows(torch, rng):
    """(name, counter, fn, bound_ms, design_ms) of K11c at app O's shape
    and K11d at app P's, on app I's values, on values over 1..4 and with
    no equality."""
    from siddhi_tpu_torch.ops import pattern
    dev = torch.device("cuda")
    t = pattern_case(torch, rng, "I")
    ts0, ts1 = int(t["ts"][0]), int(t["ts"][-1])
    deadline = torch.from_numpy(rng.integers(ts0 - 3000, ts1 + 3000, P_P)
                                .astype(np.int64)).to(dev)
    small = ((t["bval"] % 4).contiguous(), (t["eval"] % 4).contiguous())
    out = []
    for shape, pair in (("", (t["bval"], t["eval"])), (", values 1..4", small),
                        (", no equality", None)):
        pairs = [pair] if pair is not None else []
        probe = run_bytes(t, pair[0] if pair else None,
                          pair[1] if pair else None, t["pend_valid"])
        # lanes: arr_seq, ts, lane_ok, the value; entries: valid, last_seq,
        # deadline or start_ts, the value in; outputs
        lanes = B_P * (8 + 8 + 1 + 4 * len(pairs))
        ents = P_P * (1 + 8 + 8 + 4 * len(pairs))
        a = (t["arr_seq"], t["ts"], t["valid"], pairs, t["pend_valid"],
             t["last_seq"], deadline)
        out.append((f"K11c app O{shape}", "K11c",
                    lambda a=a: pattern.absent_scan(*a),
                    bound_ms(lanes + ents + P_P * 10),
                    design_bound_ms(B_P, P_P, len(pairs), probe, 10)))
        a = (t["arr_seq"], t["ts"], t["valid"], pairs, t["pend_valid"],
             t["last_seq"], t["start_ts"], WITHIN)
        out.append((f"K11d app P{shape}", "K11d",
                    lambda a=a: (pattern.match_count(*a),),
                    bound_ms(lanes + ents + 8),
                    design_bound_ms(B_P, P_P, len(pairs), probe, 0)))
    return out


def gather_row(torch, rng):
    """K2b's chunk gather at chip_smoke.py's shape (L = E + B = 262,144
    lanes of app C's 6-word rows in a random order) and `index_select` of
    the same words (dim 1)."""
    from siddhi_tpu_torch.ops import windows as w
    dev = torch.device("cuda")
    layout = {"symbol": torch.int32, "price": torch.float32,
              "volume": torch.int64}
    W = w._layout_words(layout)
    L = 2 * 131_072
    payload = torch.from_numpy(rng.integers(-(2**31), 2**31, (W, L))
                               .astype(np.int32)).to(dev)
    perm = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    emit = torch.arange(L, dtype=torch.int64, device=dev)
    valid = torch.from_numpy(rng.random(L) < 0.5).to(dev)
    types = torch.from_numpy(rng.integers(0, 2, L).astype(np.int8)).to(dev)
    args = (perm, payload, emit, valid, types, layout)
    perm64 = perm.long()

    def gather():
        b = w._gather_chunk_packed(*args)
        return (b.ts, b.valid, b.types, *b.cols.values())

    nb = L * (4 + (W - 2) * 4 + 8 + 1 + 1) + L * (4 + 4 + 8 + 8 + 1 + 1)
    return ("K2b gather", "K2b gather", gather, bound_ms(nb),
            lambda: torch.index_select(payload, 1, perm64))


def app_steps(torch, cs, seed: int, runs: int = 3) -> list:
    """Apps O's and P's query steps at chip_smoke.py's sizes: one record a
    app, the step's mean ms a round over `runs` runs from a fresh state,
    the launches of the whole fed run and the digest of its events."""
    recs = []
    data = cs.pattern_events(np.random.default_rng(seed), "I", cs.ROUNDS_P,
                             cs.BATCH_P)
    end = int(data["B"][1].max()) + cs.WAIT_O + 1
    for name, text in (("O", cs.APP_O), ("P", cs.APP_P)):
        rt, got, launches, _, _ = cs.run_pattern_app(
            torch, text, data, cs.ROUNDS_P, cs.BATCH_P, cs.PENDING_P,
            end=(lambda r: r.heartbeat(end)) if name == "O" else None)
        h = hashlib.sha256()
        for e in got:
            h.update(repr((e.timestamp, tuple(e.data))).encode())
        steps = [cs.measure_pattern_steps(torch, rt, data, cs.ROUNDS_P,
                                          cs.BATCH_P)[1]
                 for _ in range(runs)]
        recs.append({"row": f"app {name} step",
                     "ms": float(np.median(steps)), "step_ms": steps,
                     "library_ms": None, "sort_ms": None,
                     "bound_ms": None, "launches": launches["K11c" if
                                                        name == "O" else
                                                        "K11d"],
                     "events": len(got),
                     "launches_all": {k: v for k, v in launches.items()
                                      if v},
                     "digest": h.hexdigest()[:16]})
        del rt, got
    return recs


def rows(torch, rng, cs):
    """(name, counter, fn) for every row; fn calls the tree's public entry
    point and returns its outputs."""
    from siddhi_tpu_torch.ops import expression_general as eg
    from siddhi_tpu_torch.ops import pattern
    dev = torch.device("cuda")
    out = []
    for app in ("H", "I"):
        t = pattern_case(torch, rng, app)

        def resid(p0, p1, t=t):
            return (t["bval"][:, None] + t["eval"][None, p0:p1]) % 3 != 0

        for residual in (None, resid):
            a = (t["arr_seq"], t["ts"], t["valid"], t["valid"],
                 [(t["bval"], t["eval"])], t["pend_valid"], t["last_seq"],
                 t["start_ts"], WITHIN, False)
            kw = dict(seq0=t["seq0"], residual=residual)
            # lanes: arr_seq, ts, valid, lane_ok, value; entries: valid,
            # last_seq, start_ts, value in, b_star, matched, killed out
            nb = B_P * (8 + 8 + 1 + 1 + 4) + P_P * (1 + 8 + 8 + 4 + 10)
            if residual is not None:
                nb += B_P * P_P  # the mask, one byte a pair
            out.append((f"K11a app {app}"
                        + (" residual" if residual else ""), "K11a",
                        lambda a=a, kw=kw: pattern.first_match(*a, **kw),
                        bound_ms(nb)))

    layout = {"symbol": torch.int32, "price": torch.float64,
              "volume": torch.int64}
    win = eg.GeneralExpressionWindow(layout, B_X,
                                     f"sum(volume) <= {X_VOLUME}")
    vol = rng.integers(1, 101, win.C + B_X).astype(np.float64)
    w0 = int(np.searchsorted(np.cumsum(vol), X_VOLUME))
    env = cs._env_of(torch, win.cond, {"volume": vol}, win.C, B_X, w0, B_X)
    w0_d = torch.tensor(w0, dtype=torch.int32, device=dev)
    nv_d = torch.tensor(B_X, dtype=torch.int32, device=dev)
    pops = int(eg.sliding_walk_plain(win.cond, env, w0_d, nv_d, B_X,
                                     win.E)[1])
    visited = w0 + B_X + 1 if pops >= w0 else pops + 1 + B_X + 1
    out.append(("K13a sliding app X", "K13a sliding",
                lambda: eg.sliding_walk(win.cond, env, w0_d, nv_d, B_X,
                                        win.E),
                bound_ms(cs._walk_bytes(win.cond, visited, 4 * B_X + 4))))
    bwin = eg.GeneralExpressionBatchWindow(
        layout, B_X, f"sum(price) < {X_PRICE}", include_trigger=True)
    price = rng.integers(32, 6400, bwin.C + B_X) / 64.0
    w0b = 150
    benv = cs._env_of(torch, bwin.cond, {"price": price}, bwin.C, B_X, w0b,
                      B_X)
    w0b_d = torch.tensor(w0b, dtype=torch.int32, device=dev)
    want = eg.batch_walk_plain(bwin.cond, benv, w0b_d, nv_d, B_X, True)
    starts = want[1].cpu().numpy()[want[0].cpu().numpy().astype(bool)]
    bvisited = np.union1d(np.r_[0, starts],
                          np.arange(w0b, w0b + B_X + 1)).size
    out.append(("K13a batch app X", "K13a batch",
                lambda: eg.batch_walk(bwin.cond, benv, w0b_d, nv_d, B_X,
                                      True),
                bound_ms(cs._walk_bytes(bwin.cond, bvisited,
                                        6 * B_X + 4))))
    # worst cases: a condition false on every check (the sliding walk pops
    # its whole window on the first arrival, then twice an arrival; the
    # batch scan flushes every arrival, each on an empty window)
    fwin = eg.GeneralExpressionWindow(layout, B_X, "count() < 1")
    fenv = cs._env_of(torch, fwin.cond, {}, fwin.C, B_X, w0, B_X)
    out.append(("K13a sliding, false on every check", "K13a sliding",
                lambda: eg.sliding_walk(fwin.cond, fenv, w0_d, nv_d, B_X,
                                        fwin.E),
                bound_ms(4 * B_X + 4)))
    out.append(("K13a batch, flush every arrival", "K13a batch",
                lambda: eg.batch_walk(fwin.cond, fenv, w0b_d, nv_d, B_X,
                                      True),
                bound_ms(6 * B_X + 4)))
    return out


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(args) -> None:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("pattern_walk_timing.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    import chip_smoke as cs
    from siddhi_tpu_torch import kernels
    kernels.build_all()
    card = cs.card_line()
    rng = np.random.default_rng(args.seed)
    table = [(*r, None, None) for r in rows(torch, rng, cs)]
    table += [(*r[:4], None, r[4]) for r in probe_rows(torch, rng)]
    table.append((*gather_row(torch, rng), None))
    for name, counter, fn, bnd, library, design in table:
        kernels.reset_launch_counts()
        outs = fn()
        torch.cuda.synchronize()
        rec = {"label": args.label, "row": name, "card": card,
               "launches": kernels.LAUNCHES[counter],
               "launches_all": {k: v for k, v in kernels.LAUNCHES.items()
                                if v},
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=1),
               "library_ms": (cs.device_ms(torch, library, iters=args.iters,
                                           warmup=1)
                              if library is not None else None),
               "sort_ms": None, "bound_ms": bnd, "design_ms": design,
               "digest": digest(outs)}
        print(json.dumps(rec), flush=True)
    for rec in app_steps(torch, cs, args.seed):
        print(json.dumps({"label": args.label, "card": card, **rec}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    measure(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
