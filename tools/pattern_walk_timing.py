"""Device times of K11a (`first_match`, pattern mode) and K13a (both walks)
for one tree of the port, at their main-path shapes: K11a on app H's and
app I's data (B = 32,768 arrivals against P = 131,072 pending slots, 45%
of them live), with and without a residual mask; K13a on app X's two
conditions (`sum(volume) <= 5000000` over a ~99,000-row window,
`sum(price) < 10000.0` with the trigger included), B = 131,072, and
both walks on a condition false on every check (their worst case). Each
row gives the call's time on the device alone (`chip_smoke.device_ms`:
calls behind a spin kernel, L2 flushed), the launches of one call, the
bound (bytes at 3.35 TB/s: each input read once, each output written
once) and the outputs' digest, so two trees can be seen to agree.

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
    for name, counter, fn, bnd in rows(torch, rng, cs):
        kernels.reset_launch_counts()
        outs = fn()
        torch.cuda.synchronize()
        rec = {"label": args.label, "row": name, "card": card,
               "launches": kernels.LAUNCHES[counter],
               "launches_all": {k: v for k, v in kernels.LAUNCHES.items()
                                if v},
               "ms": cs.device_ms(torch, fn, iters=args.iters, warmup=1),
               "library_ms": None, "sort_ms": None, "bound_ms": bnd,
               "digest": digest(outs)}
        print(json.dumps(rec), flush=True)


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
