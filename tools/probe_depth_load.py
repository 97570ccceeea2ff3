"""Misses of the key table (kernel K4) against its load, at 16 and 32
probe slots, and the JAX package's own run of chip_smoke.py's app E.

    JAX_PLATFORMS=cpu python tools/probe_depth_load.py [--batches N]
        [--app-e] [--seed S]

Part 1 inserts the (group, value) pair keys of app E — K3 over (group id,
volume), 1,000 groups, volumes 1-999, in arrival order — into one key table
of capacity K = 2^20 (H = 2^21 slots) in batches of 131072 lanes, exactly
as distinctCount's pair path does, and prints after each batch the keys
placed (count, as a share of K and of H) and the lanes left unresolved
(misses) for three tables:

- the JAX package's `key_lookup_or_insert` (16 probe slots);
- siddhi_tpu_torch's plain K4 with 16 probe slots (it must equal the JAX
  table, miss for miss);
- siddhi_tpu_torch's plain K4 as shipped (32 probe slots).

A control run does the same with uniform random 64-bit keys in batches of
32768 lanes, up to 87.5% of K (28 batches). The CUDA K4
equals the plain K4 bit for bit (chip_smoke.py checks it), so the miss
counts hold for the card too.

Part 2 (`--app-e`) runs app E through the JAX package on the CPU at full
size (8 rounds of 131072 events, group_capacity 2^20) and prints the first
output event whose distinct count differs from chip_smoke.py's oracle.

Both parts run on the CPU: a few minutes and about 2 GiB.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K = 1 << 20
BATCH = 131072
N_GROUPS = 1000


def pair_keys(rng, n_batches: int):
    """app E's pair keys per batch: hash_columns([group id, volume])."""
    import torch

    from siddhi_tpu_torch.ops import groupby as tgb
    out = []
    for _ in range(n_batches):
        g = torch.from_numpy(rng.integers(0, N_GROUPS, BATCH))
        v = torch.from_numpy(rng.integers(1, 1000, BATCH))
        out.append(tgb.hash_columns_plain([g, v]))
    return out


def random_keys(rng, n_batches: int, lanes: int):
    import torch
    return [torch.from_numpy(rng.integers(0, 2**63 - 1, lanes,
                                          dtype=np.int64))
            for _ in range(n_batches)]


def sweep(name: str, batches) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from siddhi_tpu.ops import groupby as jgb
    from siddhi_tpu_torch.ops import groupby as tgb

    jfn = jax.jit(jgb.key_lookup_or_insert)
    jt = jgb.init_key_table(K)
    tables = {16: tgb.init_key_table(K, "cpu"),
              32: tgb.init_key_table(K, "cpu")}
    lanes = batches[0].shape[0]
    valid = torch.ones(lanes, dtype=torch.bool)
    print(f"{name}: K = {K}, H = {2 * K}, batches of {lanes} lanes")
    print("batch  count(JAX 16)  count/K  count/H  misses: JAX 16  "
          "port 16  port 32 (count)")
    shipped = tgb._PROBE_DEPTH
    try:
        for b, keys in enumerate(batches, 1):
            jt, _, _ = jfn(jt, jnp.asarray(keys.numpy()),
                           jnp.ones(lanes, bool))
            for depth in (16, 32):
                tgb._PROBE_DEPTH = depth
                tables[depth], _, _ = tgb.key_lookup_or_insert_plain(
                    tables[depth], keys, valid)
            jc, jm = int(jt.count), int(jt.misses)
            t16, t32 = tables[16], tables[32]
            if (int(t16.count), int(t16.misses)) != (jc, jm):
                raise SystemExit(f"port 16-slot table differs from JAX at "
                                 f"batch {b}")
            print(f"{b:5d}  {jc:13d}  {jc / K:7.4f}  {jc / (2 * K):7.4f}  "
                  f"{jm:14d}  {int(t16.misses):7d}  {int(t32.misses):7d} "
                  f"({int(t32.count)})", flush=True)
    finally:
        tgb._PROBE_DEPTH = shipped


def app_e(seed: int) -> None:
    import chip_smoke as cs
    import siddhi_tpu

    rng = np.random.default_rng(seed)
    sym, price, volume, ts = cs.sliding_events(rng, cs.E_SYMBOLS)
    pool = cs.symbols(cs.E_SYMBOLS)
    columns = {"symbol": pool[sym], "price": price, "volume": volume}
    rt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        cs.APP_E, batch_size=cs.BATCH, group_capacity=cs.GROUP_CAP)
    got = []
    rt.add_callback("OutStream", got.extend)
    h = rt.get_input_handler("TradeStream")
    t0 = time.perf_counter()
    for r in range(cs.ROUNDS):
        s = slice(r * cs.BATCH, (r + 1) * cs.BATCH)
        h.send_columns({k: v[s] for k, v in columns.items()},
                       timestamps=ts[s])
        rt.flush()
    elapsed = time.perf_counter() - t0
    want = cs.oracle_e(sym, volume)
    n = np.fromiter((e.data[1] for e in got), np.int64, len(got))
    print(f"JAX package, app E: {len(got)} events out of {ts.shape[0]} in "
          f"{elapsed:.1f} s")
    if len(got) != ts.shape[0]:
        print("  event count differs from the oracle")
        return
    bad = np.nonzero(n != want)[0]
    if bad.size == 0:
        print("  every distinct count equals the oracle")
        return
    j = int(bad[0])
    print(f"  {bad.size} events differ; first: event {j} (symbol "
          f"{pool[sym[j]]}, volume {volume[j]}) n = {n[j]}, oracle "
          f"{want[j]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--app-e", action="store_true")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(args.seed)
    sweep("app E pair keys", pair_keys(rng, args.batches))
    # 28 x 32768 keys: 87.5% of K, short of the capacity itself
    sweep("uniform random keys", random_keys(rng, 28, BATCH // 4))
    if args.app_e:
        app_e(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
