"""Card-only tests: each CUDA kernel against its plain PyTorch version, and
the public API on the card against the CPU. Skipped without a card. On a
machine with one (and no JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

This file imports neither jax nor siddhi_tpu."""

import ctypes

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_k1_kernel_matches_plain(cuda):
    from siddhi_tpu_torch.ops import search
    rng = np.random.default_rng(0)
    for n in (1, 31, 1024, 1025, 70001):
        live = torch.from_numpy(rng.random(n) < 0.4).to(cuda)
        assert torch.equal(search.stable_partition_order(live),
                           search.stable_partition_order_plain(live))


def test_k3_kernel_matches_plain(cuda):
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(1)
    n = 5000
    cols = [torch.from_numpy(rng.integers(-(2**62), 2**62, n)).to(cuda),
            torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda),
            torch.from_numpy(rng.normal(size=n)).to(cuda)]
    assert torch.equal(groupby.hash_columns(cols),
                       groupby.hash_columns_plain(cols))


def test_k4_kernel_matches_plain_with_table_state(cuda):
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(2)
    K = 64
    kt = groupby.init_key_table(K, cuda)
    pt = groupby.init_key_table(K, cuda)
    for _ in range(4):  # new keys, repeats, contention, then overflow
        keys = torch.from_numpy(rng.integers(0, 2**40, 40)[
            rng.integers(0, 40, 128)]).to(cuda)
        valid = torch.from_numpy(rng.random(128) < 0.9).to(cuda)
        kt, kids, kres = groupby.key_lookup_or_insert(kt, keys, valid)
        pt, pids, pres = groupby.key_lookup_or_insert_plain(pt, keys, valid)
        for a, b in zip(kt, pt):
            assert torch.equal(a, b)
        assert torch.equal(kids, pids) and torch.equal(kres, pres)
    assert int(kt.misses) > 0


def test_k5_kernel_matches_plain(cuda):
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(3)
    L, K = 3000, 50
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(cuda)
    resets = torch.from_numpy(rng.random(L) < 0.002).to(cuda)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(cuda) & ~resets
    f32 = torch.from_numpy(rng.uniform(1, 100, L).astype(np.float32)).to(cuda)
    i64 = torch.from_numpy(rng.integers(-50, 50, L)).to(cuda)
    epoch = torch.tensor(3, dtype=torch.int32, device=cuda)

    def state():
        return ([torch.full((K,), 5.0, device=cuda),
                 torch.full((K,), 7, dtype=torch.int64, device=cuda)],
                torch.from_numpy(rng.integers(2, 5, K).astype(np.int32)).to(cuda))

    v0, e0 = state()
    pv, pe, po = groupby.grouped_scan_fused_plain(
        [v.clone() for v in v0], e0.clone(), slots, [f32, i64], valid,
        resets, epoch)
    kv, ke, ko = groupby.grouped_scan_fused(
        [v.clone() for v in v0], e0.clone(), slots, [f32, i64], valid,
        resets, epoch)
    assert torch.equal(ke, pe)
    assert torch.equal(kv[1], pv[1]) and torch.equal(ko[1], po[1])
    # float32 sums in another order: rtol 1e-5 (numeric-parity policy)
    assert torch.allclose(kv[0], pv[0], rtol=1e-5, atol=1e-3)
    assert torch.allclose(ko[0], po[0], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("live_cell", [True, False])
def test_k5_ungrouped_kernel_matches_plain(cuda, live_cell):
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(7)
    L = 3000
    resets = torch.from_numpy(rng.random(L) < 0.002).to(cuda)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(cuda) & ~resets
    f32 = torch.from_numpy(rng.uniform(1, 100, L).astype(np.float32)).to(cuda)
    i64 = torch.from_numpy(rng.integers(-50, 50, L)).to(cuda)
    epoch = torch.tensor(3, dtype=torch.int32, device=cuda)
    v0 = [torch.tensor([5.0], device=cuda),
          torch.tensor([7], dtype=torch.int64, device=cuda)]
    e0 = torch.tensor([3 if live_cell else 2], dtype=torch.int32, device=cuda)
    pv, pe, po = groupby.ungrouped_scan_fused_plain(
        [v.clone() for v in v0], e0.clone(), [f32, i64], valid, resets, epoch)
    kv, ke, ko = groupby.ungrouped_scan_fused(
        [v.clone() for v in v0], e0.clone(), [f32, i64], valid, resets, epoch)
    assert torch.equal(ke, pe)
    assert torch.equal(kv[1], pv[1]) and torch.equal(ko[1], po[1])
    # float32 sums in another order: rtol 1e-5 (numeric-parity policy)
    assert torch.allclose(kv[0], pv[0], rtol=1e-5, atol=1e-3)
    assert torch.allclose(ko[0], po[0], rtol=1e-5, atol=1e-3)


def test_app_on_card_matches_cpu(cuda):
    from siddhi_tpu_torch import SiddhiManager
    app = """
    define stream TradeStream (account long, price double, volume long);
    @info(name = 'bench')
    from TradeStream[price > 20.0]#window.lengthBatch(64)
    select account, sum(price) as total, count() as n
    group by account
    insert into SummaryStream;
    """
    rng = np.random.default_rng(4)
    n = 1000
    cols = {"account": rng.integers(0, 300, n).astype(np.int64),
            "price": rng.uniform(1, 100, n), "volume": np.ones(n, np.int64)}
    ts = np.arange(n, dtype=np.int64)
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=128, group_capacity=256)
        got = []
        rt.add_callback("SummaryStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        rt.get_input_handler("TradeStream").send_columns(cols, timestamps=ts)
        rt.flush()
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) > 0
    for (t0, d0), (t1, d1) in zip(*outs):
        assert t0 == t1 and d0[0] == d1[0] and d0[2] == d1[2]
        assert abs(d0[1] - d1[1]) <= 1e-5 * abs(d1[1])


# copies: 10 gives 40 columns, past the 32 a K2b launch takes (one
# launch per chunk of columns)
@pytest.mark.parametrize("copies", [1, 10])
def test_k2b_kernels_match_plain(cuda, copies):
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops import windows as w
    rng = np.random.default_rng(5)
    B, C, E = 300, 512, 400
    layout, cols = {}, {}
    for r in range(copies):
        sfx = str(r) if r else ""
        layout.update({"s" + sfx: torch.int32, "p" + sfx: torch.float32,
                       "v" + sfx: torch.int64, "f" + sfx: torch.bool})
        cols.update({
            "s" + sfx: torch.from_numpy(rng.integers(0, 99, B).astype(
                np.int32)),
            "p" + sfx: torch.from_numpy(rng.normal(size=B).astype(
                np.float32)),
            "v" + sfx: torch.from_numpy(rng.integers(-(2**62), 2**62, B)),
            "f" + sfx: torch.from_numpy(rng.random(B) < 0.5)})
    batch = EventBatch(
        ts=torch.from_numpy(np.sort(rng.integers(0, 2**40, B))),
        cols=cols, valid=torch.from_numpy(rng.random(B) < 0.7),
        types=torch.zeros(B, dtype=torch.int8))
    gpu = EventBatch(ts=batch.ts.to(cuda),
                     cols={k: v.to(cuda) for k, v in cols.items()},
                     valid=batch.valid.to(cuda), types=batch.types.to(cuda))
    cm, cn = w.compact_packed(batch, layout)
    gm, gn = w.compact_packed(gpu, layout)
    assert torch.equal(gm.cpu(), cm) and int(gn) == int(cn)
    W = cm.shape[0]
    ring = torch.from_numpy(rng.integers(-(2**31), 2**31, (W, C)).astype(
        np.int32))
    for base, app0 in ((5, 105), (450, 700), (-3, 1), (511, 511)):
        b, a = torch.tensor(base), torch.tensor(app0)
        want = w._fetch_rel_packed_plain(ring, cm, b, a, E)
        got = w._fetch_rel_packed(ring.to(cuda), gm, b.to(cuda), a.to(cuda),
                                  E)
        assert torch.equal(got.cpu(), want)
        want = w._append_packed_plain(ring, cm, a, cn)
        got = w._append_packed(ring.to(cuda), gm, a.to(cuda), gn)
        assert torch.equal(got.cpu(), want)
    L = cm.shape[1]
    order = torch.from_numpy(rng.permutation(L).astype(np.int32))
    emit = torch.from_numpy(rng.integers(0, 2**40, L))
    valid = torch.from_numpy(rng.random(L) < 0.5)
    types = torch.from_numpy(rng.integers(0, 4, L).astype(np.int8))
    want = w._gather_chunk_packed_plain(order, cm, emit, valid, types, layout)
    got = w._gather_chunk_packed(order.to(cuda), gm, emit.to(cuda),
                                 valid.to(cuda), types.to(cuda), layout)
    for a, b in [(got.ts, want.ts), (got.valid, want.valid),
                 (got.types, want.types)] + [(got.cols[k], want.cols[k])
                                             for k in layout]:
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_k5b_kernels_match_plain(cuda, op):
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(6)
    L, K = 3000, 50
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32))
    resets = torch.from_numpy(rng.random(L) < 0.002)
    valid = torch.from_numpy(rng.random(L) < 0.9) & ~resets
    epoch = torch.tensor(3, dtype=torch.int32)
    for d in (torch.from_numpy(rng.integers(-50, 50, L)),
              torch.from_numpy(rng.uniform(-100, 100, L).astype(np.float32))):
        st = groupby.GroupState(
            torch.from_numpy(rng.integers(-9, 9, K)).to(d.dtype),
            torch.from_numpy(rng.integers(2, 5, K).astype(np.int32)))
        ps, po = groupby.grouped_scan_plain(st, slots, d, valid, resets,
                                            epoch, op)
        ks, ko = groupby.grouped_scan(
            groupby.GroupState(*[t.to(cuda) for t in st]), slots.to(cuda),
            d.to(cuda), valid.to(cuda), resets.to(cuda), epoch.to(cuda), op)
        cell = groupby.GroupState(st.values[:1].clone(),
                                  torch.tensor([3], dtype=torch.int32))
        pu, puo = groupby.ungrouped_scan_plain(cell, d, valid, resets, epoch,
                                               op)
        ku, kuo = groupby.ungrouped_scan(
            groupby.GroupState(*[t.to(cuda) for t in cell]), d.to(cuda),
            valid.to(cuda), resets.to(cuda), epoch.to(cuda), op)
        assert torch.equal(ks.epoch.cpu(), ps.epoch)
        assert torch.equal(ku.epoch.cpu(), pu.epoch)
        pairs = [(ks.values, ps.values), (ko, po), (ku.values, pu.values),
                 (kuo, puo)]
        for a, b in pairs:
            if d.dtype == torch.int64 or op != "sum":
                assert torch.equal(a.cpu(), b)
            else:  # float sums in another order: rtol 1e-5, atol 1e-3
                assert torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-3)


def test_sliding_distinct_app_on_card_matches_cpu(cuda):
    from siddhi_tpu_torch import SiddhiManager
    app = """
    @app:playback
    define stream TradeStream (symbol string, price double, volume long);
    @info(name = 'bench')
    from TradeStream#window.time(300)
    select symbol, distinctCount(volume) as n, count() as c
    group by symbol
    insert all events into SummaryStream;
    """
    rng = np.random.default_rng(7)
    n = 1000
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 20, n)],
                               dtype=object),
            "price": rng.uniform(1, 100, n),
            "volume": rng.integers(1, 30, n).astype(np.int64)}
    ts = np.arange(n, dtype=np.int64) * 3
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=128, group_capacity=1024)
        got = []
        rt.add_callback("SummaryStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, 200):
            h.send_columns({k: v[s:s + 200] for k, v in cols.items()},
                           timestamps=ts[s:s + 200])
            rt.flush()
        outs.append(got)
    assert outs[0] == outs[1] and len(outs[0]) > n


def test_k4_kernel_places_key_past_a_full_window(cuda):
    # a key whose first 16 probe slots are taken lands in slots 17-32
    from siddhi_tpu_torch.ops import groupby
    H = 128
    key = torch.tensor([0x1234_5678_9ABC_DEF1])
    window = groupby._probe_windows(key, H)[0]
    keys = torch.full((H,), groupby._KEY_PAD, dtype=torch.int64)
    keys[window[:16]] = 1000 + torch.arange(16)
    ids = torch.zeros(H, dtype=torch.int32)
    ids[window[:16]] = torch.arange(16, dtype=torch.int32)
    state = [keys, ids, torch.tensor(16, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32)]
    valid = torch.tensor([True])
    pt, pids, pres = groupby.key_lookup_or_insert_plain(
        groupby.KeyTable(*[t.clone() for t in state]), key, valid)
    kt, kids, kres = groupby.key_lookup_or_insert(
        groupby.KeyTable(*[t.to(cuda) for t in state]), key.to(cuda),
        valid.to(cuda))
    for a, b in zip(kt, pt):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(kids.cpu(), pids) and bool(kres[0]) and bool(pres[0])


# copies: 12 gives 36 key columns, past the 32 a K3b launch takes
@pytest.mark.parametrize("copies", [1, 12])
def test_k3b_kernel_matches_plain(cuda, copies):
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(8)
    n = 3000
    base = [torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(
                np.int32)),
            torch.from_numpy(rng.integers(-(2**62), 2**62, n)),
            torch.from_numpy(rng.normal(size=n).astype(np.float32)),
            torch.from_numpy(rng.normal(size=n)),
            torch.from_numpy(rng.random(n) < 0.5)]
    cols = [c.to(cuda) for c in base[:3]] * copies + \
        [c.to(cuda) for c in base[3:]]
    valid = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    # the int32 key 0x96825014 mixes to 0xFFFFFFFF: the remap moves it
    sentinel = torch.tensor([0x96825014 - 2**32, 5], dtype=torch.int32,
                            device=cuda)
    for args in ((cols, False, None), (cols, True, valid),
                 ([sentinel], True, None), ([sentinel], False, None)):
        got = groupby.hash_columns32(*args)
        want = groupby.hash_columns32_plain(*args)
        assert torch.equal(got, want)
    assert int(groupby.hash_columns32([sentinel], True)[0]) == -2


def _mm_sequence(cuda, C, H, B, n_batches, n_keys, start, seed):
    """The same batches through the K10 append kernel and its plain
    version; the state must agree bit for bit after every batch."""
    from siddhi_tpu_torch.ops import groupby, join
    rng = np.random.default_rng(seed)
    kmm = join.multimap_init(C, H, cuda)
    pmm = join.multimap_init(C, H, cuda)
    appended = start
    for _ in range(n_batches):
        keys = torch.from_numpy(rng.integers(0, n_keys, B).astype(
            np.int32)).to(cuda)
        hashes = groupby.hash_columns32_plain([keys], remap=True)
        live = torch.from_numpy(rng.random(B) < 0.8).to(cuda)
        a0 = torch.tensor(appended, device=cuda)
        kmm = join.multimap_append(kmm, hashes, live, a0)
        pmm = join.multimap_append_plain(pmm, hashes, live, a0)
        for a, b in zip(kmm, pmm):
            assert torch.equal(a, b)
        appended += int(live.sum())
    return kmm, appended


@pytest.mark.parametrize("C,H,B,n_batches,n_keys,start", [
    (100, 256, 64, 9, 50, 0),  # the ring wraps five times
    (64, 8, 64, 4, 4, 2**32 - 150),  # long shared chains; tags wrap 2^32
])
def test_k10_append_and_probe_kernels_match_plain(cuda, C, H, B, n_batches,
                                                  n_keys, start):
    from siddhi_tpu_torch.ops import groupby, join
    mm, appended = _mm_sequence(cuda, C, H, B, n_batches, n_keys, start,
                                seed=C + n_keys)
    rng = np.random.default_rng(C)
    keys = torch.from_numpy(rng.integers(0, n_keys + 3, 200).astype(
        np.int32)).to(cuda)
    hashes = groupby.hash_columns32([keys], remap=True)
    valid = torch.from_numpy(rng.random(200) < 0.9).to(cuda)
    app = torch.tensor(appended, device=cuda)
    truncated = 0
    for wlen in (C, C // 3, 1):
        w = torch.tensor(wlen, device=cuda)
        got = join.multimap_probe(mm, hashes, valid, app, w, 4)
        want = join.multimap_probe_plain(mm, hashes, valid, app, w, 4)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        truncated += int(got[2])
    assert truncated > 0 or n_keys > 4


@pytest.mark.parametrize("P,cap,p_valid", [(5000, 1024, 0.5),
                                           (5000, 4096, 0.3),
                                           (2048, 2048, 1.0),
                                           (3000, 100, 0.0)])
def test_k10_compact_kernel_matches_plain(cuda, P, cap, p_valid):
    from siddhi_tpu_torch.ops import join
    rng = np.random.default_rng(P + cap)
    lane = torch.arange(P, dtype=torch.int32, device=cuda) // 16
    row = torch.from_numpy(rng.integers(0, 10**5, P).astype(np.int32)).to(
        cuda)
    pv = torch.from_numpy(rng.random(P) < p_valid).to(cuda)
    got = join.compact_pairs(lane, row, pv, cap)
    want = join.compact_pairs_plain(lane, row, pv, cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the multimap path (both sides sliding), the sort-merge probe into a
# lengthBatch side, and the cross probe of an ON without an equality
JOINS_ON_CARD = {
    "multimap": ("L#window.length(300) as a left outer join "
                 "R#window.length(300) as b on a.k == b.k",
                 ("K3b", "K10 append", "K10 probe")),
    "sort_merge": ("L#window.lengthBatch(100) as a join "
                   "R#window.length(300) as b on a.k == b.k",
                   ("K3b", "K10 append", "K10 probe")),
    "cross": ("L#window.length(4) as a join R#window.length(4) as b "
              "on a.k < b.k", ("K1",)),
}


@pytest.mark.parametrize("name", sorted(JOINS_ON_CARD))
def test_join_app_on_card_matches_cpu(cuda, name):
    from siddhi_tpu_torch import SiddhiManager, kernels
    join, on_path = JOINS_ON_CARD[name]
    app = f"""
    define stream L (k int, v double);
    define stream R (k int, v double);
    @info(name = 'bench')
    from {join}
    select a.k as k, a.v as lv, b.v as rv
    insert into OutStream;
    """
    rng = np.random.default_rng(9)
    feeds = [(sid, {"k": rng.integers(0, 60, 128).astype(np.int32),
                    "v": rng.uniform(1, 100, 128)})
             for _ in range(6) for sid in ("L", "R")]
    outs = []
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=128)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        for i, (sid, cols) in enumerate(feeds):
            rt.get_input_handler(sid).send_columns(
                cols, timestamps=np.arange(128) + 128 * i)
            rt.flush()
        outs.append(got)
    assert outs[0] == outs[1] and len(outs[0]) > 300
    for k in on_path:
        assert kernels.LAUNCHES[k] > 0


def _first_match_case(cuda, rng, B, P, seq0, n_values):
    valid = rng.random(B) < 0.9
    t = {"valid": valid,
         "arr_seq": np.where(valid, seq0 + np.cumsum(valid) - 1, 2**62),
         "ts": 10_000 + np.arange(B) // 4,
         "bval": rng.integers(0, n_values, B).astype(np.int32),
         "bkey": rng.integers(0, 3, B),
         "pend_valid": rng.random(P) < 0.5,
         "last_seq": np.where(rng.random(P) < 0.5,
                              seq0 - 1 + rng.integers(-2, B + 2, P),
                              seq0 - 1 - rng.integers(0, 99, P)),
         "start_ts": 10_000 - rng.integers(-50, 400, P),
         "eval": rng.integers(0, n_values, P).astype(np.int32),
         "ekey": rng.integers(0, 3, P)}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in t.items()}
    t["seq0"] = torch.tensor(seq0, dtype=torch.int64, device=cuda)
    return t


@pytest.mark.parametrize("sequence", [False, True],
                         ids=["pattern", "sequence"])
@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["no_residual", "residual"])
def test_k11a_kernel_matches_plain(cuda, sequence, with_residual):
    from siddhi_tpu_torch.ops import pattern
    rng = np.random.default_rng(11)
    B, P = 1500, 3000
    t = _first_match_case(cuda, rng, B, P, seq0=70_000, n_values=6)

    def resid(p0, p1):
        return (t["bval"][:, None] + t["eval"][None, p0:p1]) % 3 != 0

    args = (t["arr_seq"], t["ts"], t["valid"],
            t["valid"] & (t["bval"] != 5),
            [(t["bval"], t["eval"]), (t["bkey"], t["ekey"])],
            t["pend_valid"], t["last_seq"], t["start_ts"], 300, sequence)
    kw = dict(seq0=t["seq0"], residual=resid if with_residual else None,
              tile=700)  # several residual tiles, a ragged last one
    got = pattern.first_match(*args, **kw)
    want = pattern.first_match_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1].sum()) > 0
    assert (int(got[2].sum()) > 0) == sequence


def _pending_table(cuda, rng, P, refs, fill):
    live = torch.from_numpy(rng.random(P) < fill).to(cuda)

    def col(dt):
        return torch.from_numpy(rng.integers(0, 99, P)).to(cuda).to(dt)

    from siddhi_tpu_torch.ops.pattern import PendingTable
    return PendingTable(
        frames={r: {"i": col(torch.int32), "l": col(torch.int64),
                    "f": col(torch.float32), "b": col(torch.bool)}
                for r in refs},
        frame_valid={r: col(torch.bool) for r in refs},
        frame_ts={r: col(torch.int64) for r in refs},
        start_ts=col(torch.int64), last_seq=col(torch.int64),
        armed_ts=col(torch.int64), valid=live,
        leg_done=torch.from_numpy(rng.random((P, 2)) < 0.3).to(cuda),
        origin=col(torch.int32))


@pytest.mark.parametrize("fill", [0.5, 0.97], ids=["free_slots", "overflow"])
def test_k11b_kernel_matches_plain(cuda, fill):
    from siddhi_tpu_torch.ops import pattern
    rng = np.random.default_rng(12)
    P, W = 5000, 2100
    refs = [f"e{k}" for k in range(9)]  # 54 columns: two scatter launches
    dst = _pending_table(cuda, rng, P, refs, fill)
    clone = pattern.PendingTable(
        {r: {n: c.clone() for n, c in cs.items()}
         for r, cs in dst.frames.items()},
        {r: v.clone() for r, v in dst.frame_valid.items()},
        {r: v.clone() for r, v in dst.frame_ts.items()},
        *[x.clone() for x in dst[3:]])
    cand = _pending_table(cuda, rng, W, refs[:7], 0.8)  # two refs kept
    fvalid = {r: v for r, v in cand.frame_valid.items() if r != "e3"}
    args = (cand.frames, fvalid, cand.frame_ts, cand.start_ts,
            cand.last_seq, cand.armed_ts, cand.valid)
    want, wdrop = pattern.pending_insert_plain(dst, *args)
    got, gdrop = pattern.pending_insert(clone, *args, origin=None)
    assert int(gdrop) == int(wdrop)
    assert (int(gdrop) > 0) == (fill > 0.9)
    for f in pattern.PendingTable._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "frames":
            for r in a:
                for n in a[r]:
                    assert torch.equal(a[r][n], b[r][n]), (r, n)
        elif isinstance(a, dict):
            for r in a:
                assert torch.equal(a[r], b[r]), (f, r)
        else:
            assert torch.equal(a, b), f


PATTERNS_ON_CARD = {
    "config4": ("from every a=A -> b=B[b.val == a.val] within 5 sec "
                "select a.val as av, b.val as bv", ("K1", "K11a", "K11b")),
    "logical_sequence": (
        "from every e1=A[val > 3], e2=A[val < 3] and e3=A[val == 3] "
        "select e1.val as av, e2.val as bv", ("K1", "K11a", "K11b")),
}


@pytest.mark.parametrize("name", sorted(PATTERNS_ON_CARD))
def test_pattern_app_on_card_matches_cpu(cuda, name):
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.core import dtypes
    query, on_path = PATTERNS_ON_CARD[name]
    app = f"""
    @app:playback
    define stream A (val int);
    define stream B (val int);
    @info(name = 'bench')
    {query}
    insert into OutStream;
    """
    rng = np.random.default_rng(13)
    feeds = [(sid, rng.integers(0, 8, 256).astype(np.int32))
             for _ in range(8) for sid in ("A", "B")]
    outs = []
    kernels.reset_launch_counts()
    prev = dtypes.config.pattern_pending_capacity
    dtypes.config.pattern_pending_capacity = 1024
    try:
        for dev in ("cuda", "cpu"):
            rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
                app, batch_size=256)
            got = []
            rt.add_callback("OutStream", lambda evs, g=got: g.extend(
                (e.timestamp, e.data) for e in evs))
            for i, (sid, val) in enumerate(feeds):
                rt.get_input_handler(sid).send_columns(
                    {"val": val}, timestamps=np.arange(256) * 5 + 700 * i)
                rt.flush()
            outs.append((got, int(rt.query_runtimes["bench"].state.dropped)))
    finally:
        dtypes.config.pattern_pending_capacity = prev
    assert outs[0] == outs[1] and len(outs[0][0]) > 100
    for k in on_path:
        assert kernels.LAUNCHES[k] > 0


def _extrema_chunk(cuda, rng, L):
    from siddhi_tpu_torch.core.event import EventBatch
    types = rng.integers(0, 4, L).astype(np.int8)
    types[: L // 2] = np.tile(np.array([1, 0], np.int8), L // 4)
    return EventBatch(ts=torch.zeros(L, dtype=torch.int64, device=cuda),
                      cols={},
                      valid=torch.from_numpy(rng.random(L) < 0.9).to(cuda),
                      types=torch.from_numpy(types).to(cuda))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int64,
                                torch.int32])
@pytest.mark.parametrize("op", ["min", "max"])
def test_k8_kernels_match_plain(cuda, dt, op):
    """K8 and grouped K8 bit for bit at small sizes: a wrapped ring, ranges
    within one tile, across tiles and across superblocks (C + L = 5100
    positions), NaN, and the launch counters move (a CUDA tensor never
    reaches the plain version)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import extrema as ex
    rng = np.random.default_rng(20)
    for C, L, winlen0 in ((40, 24, 13), (3000, 2100, 2500)):
        if dt.is_floating_point:
            vals = rng.uniform(-9, 9, C + L)
            vals[rng.choice(C + L, 2, replace=False)] = np.nan
        else:
            vals = rng.integers(-(2**31), 2**31 - 1, C + L)
        v = torch.from_numpy(vals).to(cuda).to(dt)
        rv, cv = v[:C].contiguous(), v[C:].contiguous()
        chunk = _extrema_chunk(cuda, rng, L)
        expired = torch.tensor(7 * C + 5, device=cuda)
        appended = expired + winlen0
        keys = torch.from_numpy(rng.integers(0, 5, C + L) * (2**40) - 3).to(
            cuda)
        rk, ck = keys[:C].contiguous(), keys[C:].contiguous()
        kernels.reset_launch_counts()
        got = ex.sliding_extrema_lanes(op, rv, expired, appended, chunk, cv)
        assert kernels.LAUNCHES["K8"] > 0
        want = ex.sliding_extrema_lanes_plain(op, rv, expired, appended,
                                              chunk, cv)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        got = ex.grouped_sliding_extrema_lanes(op, rv, rk, expired, appended,
                                               chunk, cv, ck)
        assert kernels.LAUNCHES["K8 grouped"] > 0
        want = ex.grouped_sliding_extrema_lanes_plain(
            op, rv, rk, expired, appended, chunk, cv, ck)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("n_resets", [0, 1, 3])
@pytest.mark.parametrize("G", [1, 16])
def test_k9_hll_kernels_match_plain(cuda, n_resets, G):
    """Registers and the drop count bit for bit, estimates within
    max(1, 1e-5 E) (float32 sums in another order); slots past G; the
    launch counters move."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import aggregators as ag
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(21 + n_resets)
    M, L = 1024, 3001
    h = groupby.hash_columns(
        [torch.from_numpy(rng.integers(0, 2000, L)).to(cuda)])
    slots = torch.from_numpy(rng.integers(0, G + 2, L).astype(np.int32)).to(
        cuda)
    sign = torch.from_numpy(rng.choice([-1, 1, 1], L).astype(np.int32)).to(
        cuda)
    resets = torch.zeros(L, dtype=torch.bool, device=cuda)
    resets[torch.from_numpy(rng.choice(L, n_resets, replace=False)).to(
        cuda)] = True
    valid = torch.from_numpy(rng.random(L) < 0.9).to(cuda) & ~resets
    regs0 = torch.from_numpy(rng.integers(0, 6, G * M).astype(np.int32)).to(
        cuda)
    drop0 = torch.tensor(4, dtype=torch.int64, device=cuda)
    pr, pd, pe = ag.hll_scan_plain(regs0.clone(), drop0.clone(), slots, h,
                                   sign, valid, resets, M)
    kernels.reset_launch_counts()
    kr, kd, ke = ag.hll_scan(regs0.clone(), drop0.clone(), slots, h, sign,
                             valid, resets, M)
    assert kernels.LAUNCHES["K9 HLL"] > 0
    assert kernels.LAUNCHES["K9 HLL estimate"] > 0
    assert torch.equal(kr, pr) and torch.equal(kd, pd)
    assert bool(((ke - pe).abs() <= torch.clamp(pe * 1e-5, min=1)).all())


AGG_APPS_ON_CARD = {
    # app K's shape: grouped sliding extrema (K8 grouped)
    "K": ("from TradeStream#window.time(300) select symbol, "
          "max(price) as high, min(price) as low group by symbol",
          ("K3", "K8 grouped")),
    # app M's shape: tumbling buckets with monotone scans and resets
    "M": ("from TradeStream#window.timeBatch(100) select symbol, "
          "max(price) as high, min(price) as low, avg(price) as a, "
          "stdDev(price) as sd, count() as n group by symbol",
          ("K5", "K5b grouped")),
    "L": ("from TradeStream#window.length(700) select max(price) as hi, "
          "min(volume) as lo, maxForever(price) as top",
          ("K8", "K5b ungrouped")),
    "J": ("from TradeStream#window.time(300) "
          "select hll:distinctCount(symbol) as d", ("K9 HLL",)),
}


@pytest.mark.parametrize("name", sorted(AGG_APPS_ON_CARD))
def test_aggregator_app_on_card_matches_cpu(cuda, name):
    """Extrema, counts and estimates equal; float sums within rtol 1e-5
    and stdDev within its float32 cancellation (sqrt(4 eps32) * 100)."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    query, on_path = AGG_APPS_ON_CARD[name]
    app = f"""
    @app:playback
    define stream TradeStream (symbol string, price double, volume long);
    @info(name = 'bench')
    {query}
    insert into OutStream;
    """
    rng = np.random.default_rng(17)
    n = 2048
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 30, n)],
                               dtype=object),
            "price": rng.uniform(1, 100, n),
            "volume": rng.integers(1, 1000, n).astype(np.int64)}
    ts = 1_000 + np.arange(n, dtype=np.int64)
    outs = []
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=256, group_capacity=1024)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, 256):
            h.send_columns({k: v[s:s + 256] for k, v in cols.items()},
                           timestamps=ts[s:s + 256])
            rt.flush()
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) > 0
    sd_atol = float(np.sqrt(4 * np.finfo(np.float32).eps)) * 100
    for (t0, d0), (t1, d1) in zip(*outs):
        assert t0 == t1
        for i, (a, b) in enumerate(zip(d0, d1)):
            if name == "M" and i in (3, 4):  # avg, stdDev
                tol = 1e-5 * abs(b) if i == 3 else 1e-4 * abs(b) + sd_atol
                assert abs(a - b) <= tol
            elif name == "J":
                assert abs(a - b) <= max(1, 1e-5 * abs(b))
            else:
                assert a == b
    for k in on_path:
        assert kernels.LAUNCHES[k] > 0


def _wire_case(cuda, B, seed, p_valid, span=None):
    rng = np.random.default_rng(seed)
    ts = 1_700_000_000_000 + np.cumsum(rng.integers(0, 3, B)).astype(np.int64)
    valid = rng.random(B) < p_valid
    if span is not None and valid.any():
        v = np.nonzero(valid)[0]
        ts[v[-1]] = ts[v[0]] + span
    cols = {"code": torch.from_numpy(rng.integers(0, 1000, B).astype(
                np.int32)).to(cuda),
            "x": torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(
                cuda),
            "n": torch.from_numpy(rng.integers(-2**40, 2**40, B)).to(cuda),
            "b": torch.from_numpy(rng.random(B) < 0.5).to(cuda)}
    return (torch.from_numpy(ts).to(cuda), torch.from_numpy(valid).to(cuda),
            torch.from_numpy(rng.choice(np.array([0, 1, 3], np.int8),
                                        B)).to(cuda), cols)


@pytest.mark.parametrize("B,p_valid,span", [
    (1, 1.0, None), (1000, 0.0, None), (1024, 1.0, None),
    (70001, 0.5, None), (4097, 0.3, 0xFFFFFFFF), (4097, 0.3, 1 << 32)])
def test_k12a_kernel_matches_plain(cuda, B, p_valid, span):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import wire
    ts, valid, types, cols = _wire_case(cuda, B, B, p_valid, span)
    layout = wire.layout_of(ts, cols)
    kernels.reset_launch_counts()
    got = wire.wire_pack_cuda(ts, valid, types, cols, layout)
    assert kernels.LAUNCHES["K12a"] == 1
    want = wire.wire_pack_plain(ts, valid, types, cols, layout)
    torch.cuda.synchronize()
    assert torch.equal(wire.wire_payload(got, layout),
                       wire.wire_payload(want, layout))
    host = wire.wire_unpack(got.cpu().numpy(), layout)
    idx = torch.nonzero(valid).squeeze(1)
    assert host.count == idx.numel()
    assert host.over == (span is not None and span >= 1 << 32)
    assert np.array_equal(host.ts, ts[idx].cpu().numpy())


def test_cuda_batch_reaches_k12a_not_the_plain_pack(cuda, monkeypatch):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import wire
    monkeypatch.setattr(wire, "wire_pack_plain",
                        lambda *a: pytest.fail("plain pack on the card"))
    ts, valid, types, cols = _wire_case(cuda, 512, 3, 0.5)
    kernels.reset_launch_counts()
    host = wire.start_readback(ts, valid, types, cols).result()
    assert kernels.LAUNCHES["K12a"] == 1
    assert host.count == int(valid.sum())


def test_async_decoder_on_card_while_steps_rewrite_the_ring(cuda):
    """A length window's output columns are views of its packed ring, which
    the next steps append to in place: async blocks must still hold each
    step's own rows (the pack is enqueued at submit, on the step's
    stream)."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    app = """
    define stream TradeStream (symbol string, price double, volume long);
    @info(name = 'bench')
    from TradeStream#window.length(300)
    select symbol, price, volume
    insert all events into OutStream;
    """
    rng = np.random.default_rng(23)
    n, bs = 64 * 40, 64
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 50, n)],
                               dtype=object),
            "price": rng.uniform(1, 100, n),
            "volume": rng.integers(1, 1000, n).astype(np.int64)}
    ts = 1_000 + np.arange(n, dtype=np.int64)
    outs = []
    for dev, async_cb in (("cuda", True), ("cpu", False)):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=bs, async_callbacks=async_cb)
        blocks = []
        rt.add_callback("OutStream", blocks.append, columnar=True)
        rt.start()
        kernels.reset_launch_counts()
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, bs):
            h.send_columns({k: v[s:s + bs] for k, v in cols.items()},
                           timestamps=ts[s:s + bs])
            rt.flush()
        rt.drain()
        if dev == "cuda":
            assert kernels.LAUNCHES["K12a"] > 0
        rt.shutdown()
        outs.append(blocks)
    card, cpu = outs
    assert [b.count for b in card] == [b.count for b in cpu]
    for a, b in zip(card, cpu):
        assert np.array_equal(a.timestamps, b.timestamps)
        assert np.array_equal(a.is_expired, b.is_expired)
        for k in b.columns:
            assert np.array_equal(a.columns[k], b.columns[k]), k
        assert a.strings("symbol") == b.strings("symbol")


@pytest.mark.parametrize("timer", [True, False], ids=["deadline", "untimed"])
@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["no_residual", "residual"])
def test_k11c_kernel_matches_plain(cuda, timer, with_residual):
    from siddhi_tpu_torch.ops import pattern
    rng = np.random.default_rng(14)
    B, P = 1500, 3000
    t = _first_match_case(cuda, rng, B, P, seq0=70_000, n_values=6)
    deadline = torch.from_numpy(rng.integers(9_900, 10_500, P)).to(cuda)

    def resid(p0, p1):
        return (t["bval"][:, None] + t["eval"][None, p0:p1]) % 3 != 0

    args = (t["arr_seq"], t["ts"], t["valid"] & (t["bval"] != 5),
            [(t["bval"], t["eval"]), (t["bkey"], t["ekey"])],
            t["pend_valid"], t["last_seq"], deadline if timer else None)
    kw = dict(residual=resid if with_residual else None, tile=700)
    got = pattern.absent_scan(*args, **kw)
    want = pattern.absent_scan_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[0] < 2**62).sum()) > 0 and int(got[1].sum()) > 0
    assert (int(got[2].sum()) > 0) == timer


@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["no_residual", "residual"])
def test_k11d_kernel_matches_plain(cuda, with_residual):
    from siddhi_tpu_torch.ops import pattern
    rng = np.random.default_rng(15)
    B, P = 1500, 3000
    t = _first_match_case(cuda, rng, B, P, seq0=70_000, n_values=6)

    def resid(p0, p1):
        return (t["bval"][:, None] + t["eval"][None, p0:p1]) % 3 != 0

    args = (t["arr_seq"], t["ts"], t["valid"], [(t["bval"], t["eval"])],
            t["pend_valid"], t["last_seq"], t["start_ts"], 300)
    kw = dict(residual=resid if with_residual else None, tile=700)
    got = pattern.match_count(*args, **kw)
    assert got.is_cuda and got.dtype == torch.int64
    assert int(got) == int(pattern.match_count_plain(*args, **kw)) > 0


def test_k11e_kernel_matches_plain(cuda):
    from siddhi_tpu_torch.ops import pattern
    rng = np.random.default_rng(16)
    P, W = 3000, 5000
    base = _pending_table(cuda, rng, P, [], 0.5)
    valid = torch.from_numpy(rng.random(W) < 0.7).to(cuda)
    origin = torch.from_numpy(np.where(rng.random(W) < 0.1, -1,
                                       rng.integers(0, 500, W))
                              .astype(np.int32)).to(cuda)
    seq = torch.from_numpy(rng.integers(0, 2**40, W)).to(cuda)
    want = pattern.release_origin_plain(base, valid, origin, seq)
    work = base._replace(leg_done=base.leg_done.clone(),
                         last_seq=base.last_seq.clone())
    got = pattern.release_origin(work, valid, origin, seq)
    assert torch.equal(got.leg_done, want.leg_done)
    assert torch.equal(got.last_seq, want.last_seq)
    assert got.last_seq.data_ptr() == work.last_seq.data_ptr()  # in place


ABSENT_EVERY_ON_CARD = {
    "O_absent": ("from every a=A -> not B[val == a.val] for 20 millisec "
                 "select a.val as av", ("K11b", "K11c", "K7 pattern index")),
    "P_sticky": ("from every a=A -> every b=B[b.val == a.val] within 1 sec "
                 "select a.val as av, b.val as bv",
                 ("K11a", "K11d", "K7 pattern index")),
    "Q_sequence": ("from every a=A, b=B[b.val == a.val] "
                   "select a.val as av, b.val as bv", ("K11a", "K11b")),
    "R_mid_group": ("from e0=B[val == 7] -> every (e1=A[val > 4] -> "
                    "e2=A[val < e1.val]) -> e3=B[val == e2.val] "
                    "select e1.val as av, e3.val as bv", ("K11a", "K11e")),
    "R_head_group": ("from every (e1=A[val > 4] -> e2=A[val < e1.val]) -> "
                     "e3=B[val == e2.val] within 1 sec "
                     "select e1.val as av, e3.val as bv", ("K11a", "K11b")),
}


@pytest.mark.parametrize("name", sorted(ABSENT_EVERY_ON_CARD))
def test_absent_and_every_app_on_card_matches_cpu(cuda, name):
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.core import dtypes
    query, on_path = ABSENT_EVERY_ON_CARD[name]
    app = f"""
    @app:playback
    define stream A (val int);
    define stream B (val int);
    @info(name = 'bench')
    {query}
    insert into OutStream;
    """
    rng = np.random.default_rng(17)
    # runs of one stream, so a sequence meets both streams in one batch
    feeds = [(sid, rng.integers(0, 8, int(rng.integers(1, 9)))
              .astype(np.int32)) for _ in range(160) for sid in ("A", "B")]
    outs = []
    kernels.reset_launch_counts()
    prev = dtypes.config.pattern_pending_capacity
    dtypes.config.pattern_pending_capacity = 1024
    try:
        for dev in ("cuda", "cpu"):
            rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
                app, batch_size=256)
            got = []
            rt.add_callback("OutStream", lambda evs, g=got: g.extend(
                (e.timestamp, e.data) for e in evs))
            t = 1000
            for i, (sid, val) in enumerate(feeds):
                rt.get_input_handler(sid).send_columns(
                    {"val": val}, timestamps=t + np.arange(val.size))
                t += val.size
                if i % 16 == 15:
                    rt.flush()
            rt.heartbeat(t + 5000)
            outs.append((got, int(rt.query_runtimes["bench"].state.dropped)))
    finally:
        dtypes.config.pattern_pending_capacity = prev
    assert outs[0] == outs[1] and len(outs[0][0]) > 10
    for k in on_path:
        assert kernels.LAUNCHES[k] > 0


def _k7_case(rng, site, B=512, N=100, C=4096, E=1024, K=4096):
    """(keys, bound, width) at one K7 site's form, small."""
    from siddhi_tpu_torch.ops import search
    if site in ("session_chunk", "sort_chunk", "all_equal", "wide"):
        L = {"session_chunk": 3 * B, "sort_chunk": 2 * B + N,
             "all_equal": 5000, "wide": 300_001}[site]
        bound = 4 * B + 3
        keys = rng.integers(0, B + 1, L) * 4 + rng.choice([0, 2], L)
        if site == "all_equal":
            keys[:] = 4 * B
        keys = np.where(rng.random(L) < 0.6, keys, bound)
        width = 2 * B if site == "session_chunk" else L
        return torch.from_numpy(keys.astype(np.int32)), bound, width
    if site in ("rank_asc", "rank_desc"):
        x = rng.integers(-4, 5, N + B).astype(np.float64) * 0.5
        for v in (0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf):
            x[rng.integers(0, x.size, 5)] = v
        return (search.float64_sort_key(torch.from_numpy(x),
                                        site == "rank_desc"), None, None)
    if site == "keyed_group":
        keys = np.where(rng.random(B) < 0.9, rng.integers(0, 1000, B), K)
        return torch.from_numpy(keys.astype(np.int32)), K, B
    ages = np.where(rng.random(C) < 0.3, rng.permutation(C), C)
    return torch.from_numpy(ages.astype(np.int32)), C, E


@pytest.mark.parametrize("site", ["session_chunk", "sort_chunk", "rank_asc",
                                  "rank_desc", "keyed_group", "keyed_top_e",
                                  "all_equal", "wide"])
def test_k7_kernel_matches_plain(cuda, site):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    keys, bound, width = _k7_case(np.random.default_rng(len(site)), site)
    keys = keys.to(cuda)
    kernels.reset_launch_counts()
    got = search.stable_radix_argsort(keys, bound, width, counter="K7 rank")
    want = search.stable_radix_argsort_plain(keys, bound, width)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert kernels.LAUNCHES["K7 rank"] == 1  # every pass in one launch


def test_cuda_keys_never_reach_the_plain_sort(cuda, monkeypatch):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    from siddhi_tpu_torch.ops.windows import SortWindow
    from siddhi_tpu_torch.core.event import EventBatch
    monkeypatch.setattr(search, "stable_radix_argsort_plain",
                        lambda *a, **k: pytest.fail("plain sort on the card"))
    win = SortWindow({"p": torch.float32, "v": torch.int64}, 64, 10,
                     [("p", -1), ("v", 1)])
    rng = np.random.default_rng(3)
    batch = EventBatch(
        ts=torch.arange(64, device=cuda),
        cols={"p": torch.from_numpy(rng.integers(0, 5, 64).astype(
            np.float32)).to(cuda),
              "v": torch.from_numpy(rng.integers(0, 5, 64)).to(cuda)},
        valid=torch.ones(64, dtype=torch.bool, device=cuda),
        types=torch.zeros(64, dtype=torch.int8, device=cuda))
    kernels.reset_launch_counts()
    state, chunk = win.step(win.init_state(cuda), batch, 100)
    assert int(chunk.valid.sum()) == 64 + 54
    assert kernels.LAUNCHES["K7 rank"] > 0
    assert kernels.LAUNCHES["K7 sort chunk"] > 0


SESSION_SORT_ON_CARD = {
    "S_session": ("from TradeStream#window.session(40) select symbol, "
                  "price, volume insert all events into OutStream;",
                  ("K7 session chunk",)),
    "T_keyed_session": ("from TradeStream#window.session(40, symbol) select "
                        "symbol, price, volume insert all events into "
                        "OutStream;", ("K7 keyed group", "K7 keyed top-E")),
    "U_named_window": ("define window TradeWindow (symbol string, price "
                       "double, volume long) length(300) output all "
                       "events;\nfrom TradeStream insert into TradeWindow;\n"
                       "@info(name = 'bench') from TradeWindow select "
                       "symbol, sum(price) as total, count() as n group by "
                       "symbol insert into OutStream;", ("K2b append",)),
    "V_sort": ("from TradeStream#window.sort(100, price, 'desc', volume) "
               "select symbol, price, volume insert all events into "
               "OutStream;", ("K7 sort chunk", "K7 rank")),
}


@pytest.mark.parametrize("name", sorted(SESSION_SORT_ON_CARD))
def test_session_sort_app_on_card_matches_cpu(cuda, name):
    from siddhi_tpu_torch import SiddhiManager, kernels
    query, on_path = SESSION_SORT_ON_CARD[name]
    app = ("@app:playback\ndefine stream TradeStream (symbol string, price "
           "double, volume long);\n" + query)
    rng = np.random.default_rng(29)
    n, bs = 256 * 8, 256
    steps = np.where(rng.random(n) < 0.02, rng.integers(41, 200, n),
                     rng.integers(0, 3, n))
    ts = 1_000 + np.cumsum(steps)
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 20, n)],
                               dtype=object),
            "price": rng.integers(1, 50, n) * 0.5,
            "volume": rng.integers(1, 30, n).astype(np.int64)}
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=bs)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        kernels.reset_launch_counts()
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, bs):
            h.send_columns({k: v[s:s + bs] for k, v in cols.items()},
                           timestamps=ts[s:s + bs])
            rt.flush()
        rt.heartbeat(int(ts[-1]) + 500)
        if dev == "cuda":
            for k in on_path:
                assert kernels.LAUNCHES[k] > 0, k
        outs.append(got)
    card, cpu = outs
    assert len(card) == len(cpu) >= n
    for (ta, da), (tb, db) in zip(card, cpu):
        assert ta == tb and da[0] == db[0]
        np.testing.assert_allclose(da[1:], db[1:], rtol=1e-5, atol=1e-3)


# ------------------------------------------------ K7 packed, K13a, K13b


def test_k13a_walks_match_plain(cuda):
    """Both modes of the walk on conditions over every metric kind, `%`
    with negative operands and windows that empty, bit for bit; and the
    kernel's static limits are the ones the postfix compiler checks."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import expression_general as eg
    lib = kernels.library("k13a_expression_walk")
    assert eg.K13A_LIMITS == {"instr": lib.k13a_max_instr(),
                              "consts": lib.k13a_max_consts(),
                              "arrays": lib.k13a_max_arrays(),
                              "stack": lib.k13a_max_stack()}
    layout = {"price": torch.float64, "volume": torch.int64}
    rng = np.random.default_rng(31)
    B, C = 256, 512
    data = {"price": rng.integers(-400, 900, C + B) / 64.0,
            "volume": rng.integers(-20, 20, C + B).astype(np.float64),
            eg.TS_ATTR: (1_000 + np.cumsum(rng.integers(0, 9, C + B)))
            .astype(np.float64)}
    for text in ("stdDev(price) < 3.0 and count() < 60",
                 "avg(price) > 100.0",
                 "(last.volume - first.volume) % -7 > -3 or price < 0.0",
                 "eventTimestamp(last) - eventTimestamp(first) <= 90",
                 "not (sum(volume) / count() > 1.5)"):
        win = eg.GeneralExpressionWindow(layout, B, text)
        env = {}
        for kind, attr in win.cond.program.arrays:
            seq = data[attr].copy()
            seq = {"seq": seq, "prefix": np.r_[0.0, np.cumsum(seq)],
                   "prefix_sq": np.r_[0.0, np.cumsum(seq * seq)]}[kind]
            env[(kind, attr)] = torch.from_numpy(seq).to(cuda)
        for w0, nv in ((0, B), (300, B - 9)):
            a = (torch.tensor(w0, dtype=torch.int32, device=cuda),
                 torch.tensor(nv, dtype=torch.int32, device=cuda))
            for g, w in zip(eg.sliding_walk(win.cond, env, *a, B, win.E),
                            eg.sliding_walk_plain(win.cond, env, *a, B,
                                                  win.E)):
                assert torch.equal(g, w), text
            for inc in (False, True):
                for g, w in zip(eg.batch_walk(win.cond, env, *a, B, inc),
                                eg.batch_walk_plain(win.cond, env, *a, B,
                                                    inc)):
                    assert torch.equal(g, w), text


@pytest.mark.parametrize("N", [1, 64, 10_000])
def test_k13b_kernel_matches_plain(cuda, N):
    from siddhi_tpu_torch.ops import windows_extra as wx
    rng = np.random.default_rng(N)
    B = 4096
    slot = torch.from_numpy(rng.integers(0, N + 1, B).astype(np.int32))
    comp = {"b": torch.from_numpy(rng.random(B) < 0.5),
            "i": torch.from_numpy(rng.integers(-9, 9, B).astype(np.int32)),
            "d": torch.from_numpy(rng.normal(size=B))}
    old = {"b": torch.from_numpy(rng.random(N) < 0.5),
           "i": torch.from_numpy(rng.integers(-9, 9, N).astype(np.int32)),
           "d": torch.from_numpy(rng.normal(size=N))}
    args = [slot.to(cuda), {k: v.to(cuda) for k, v in comp.items()},
            torch.from_numpy(rng.integers(0, 2**40, B)).to(cuda),
            {k: v.to(cuda) for k, v in old.items()},
            torch.from_numpy(rng.integers(0, 2**40, N)).to(cuda), N]
    gc, gt = wx.frequent_last_lane(*args)
    wc, wt = wx.frequent_last_lane_plain(*args)
    assert torch.equal(gt, wt)
    for k in comp:
        assert torch.equal(gc[k], wc[k]), k


def test_k7_packed_chunk_matches_the_cpu(cuda):
    from siddhi_tpu_torch.ops import windows
    rng = np.random.default_rng(37)
    B = 1000
    L = 2 * B
    hi = torch.from_numpy(np.r_[rng.integers(0, B + 1, B) * 4 + 3,
                                np.arange(B) * 4 + 2].astype(np.int32))
    layout = {"p": torch.float32, "v": torch.int64}
    mat = torch.from_numpy(rng.integers(-2**31, 2**31, (5, L))
                           .astype(np.int32))
    args = [hi, mat, torch.from_numpy(rng.integers(0, 2**40, L)),
            torch.from_numpy(rng.random(L) < 0.6),
            torch.from_numpy(rng.integers(0, 3, L).astype(np.int8))]
    want = windows._sort_chunk_packed(*args, layout, L, 4 * B + 4)
    got = windows._sort_chunk_packed(*[a.to(cuda) for a in args], layout, L,
                                     4 * B + 4)
    for f in ("ts", "valid", "types"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for k in layout:
        assert torch.equal(got.cols[k].cpu().view(torch.int32
                                                  if k == "p" else
                                                  torch.int64),
                           want.cols[k].view(torch.int32 if k == "p"
                                             else torch.int64)), k


EXPRESSION_ON_CARD = {
    "expression_general": (
        "@info(name = 'q') from TradeStream#window.expression('sum(volume) "
        "<= 300 and count() > 1') select symbol, price, volume insert all "
        "events into OutStream;", ("K13a sliding", "K7 packed chunk")),
    "expression_count": (
        "@info(name = 'q') from TradeStream#window.expression('count() <= "
        "100') select symbol, sum(price) as t insert all events into "
        "OutStream;", ("K7 packed chunk", "K5b ungrouped")),
    "expression_batch": (
        "@info(name = 'q') from TradeStream#window.expressionBatch("
        "'sum(price) < 60.0', true) select symbol, price insert all events "
        "into OutStream;", ("K13a batch", "K7 packed chunk")),
    "frequent": (
        "@info(name = 'q') from TradeStream#window.frequent(8, symbol) "
        "select symbol, price insert all events into OutStream;",
        ("K13b", "K7 frequent key", "K7 frequent match")),
    "hopping_pol2cart": (
        "@info(name = 'q') from TradeStream#pol2Cart(price, volume)"
        "#window.hopping(2 sec, 500 millisec)[x > 0.0] select symbol, "
        "sum(x) as sx group by symbol insert into OutStream;", ("K1",)),
    "cron": (
        "@info(name = 'q') from TradeStream#window.cron('*/1 * * * * ?') "
        "select symbol, volume insert all events into OutStream;", ("K1",)),
}


@pytest.mark.parametrize("name", sorted(EXPRESSION_ON_CARD))
def test_expression_frequent_cron_apps_on_card_match_cpu(cuda, name):
    from siddhi_tpu_torch import SiddhiManager, kernels
    query, on_path = EXPRESSION_ON_CARD[name]
    app = ("@app:playback\ndefine stream TradeStream (symbol string, price "
           "double, volume long);\n" + query)
    rng = np.random.default_rng(41)
    n, bs = 256 * 8, 256
    ts = 1_000 + np.cumsum(rng.integers(0, 12, n))
    cols = {"symbol": np.array([f"S{i}" for i in np.minimum(
        rng.zipf(1.5, n), 12)], dtype=object),
            "price": rng.integers(1, 120, n) * 0.5,
            "volume": rng.integers(1, 30, n).astype(np.int64)}
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=bs)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        kernels.reset_launch_counts()
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, bs):
            h.send_columns({k: v[s:s + bs] for k, v in cols.items()},
                           timestamps=ts[s:s + bs])
            rt.flush()
        if dev == "cuda":
            for k in on_path:
                assert kernels.LAUNCHES[k] > 0, k
        outs.append(got)
    card, cpu = outs
    assert len(card) == len(cpu) > 0
    for (ta, da), (tb, db) in zip(card, cpu):
        assert ta == tb and da[0] == db[0]
        np.testing.assert_allclose(da[1:], db[1:], rtol=1e-5, atol=1e-3)


def _ring_case(rng, B, C, dev):
    """A batch of B lanes (ts + three columns + valid + types) and a C-slot
    ring of the same columns, on `dev`."""
    def cols(n):
        return {"ts": torch.from_numpy(rng.integers(0, 2**40, n)),
                "s": torch.from_numpy(rng.integers(-9, 9, n)
                                      .astype(np.int32)),
                "p": torch.from_numpy(rng.normal(size=n).astype(np.float32)),
                "v": torch.from_numpy(rng.integers(0, 2**50, n)),
                "ok": torch.from_numpy(rng.random(n) < 0.7),
                "t": torch.from_numpy(rng.integers(0, 2, n)
                                      .astype(np.int8))}
    return ({k: v.to(dev) for k, v in cols(B).items()},
            {k: v.to(dev) for k, v in cols(C).items()})


@pytest.mark.parametrize("B,C,appended,p_sel", [
    (4096, 8192, 0, 0.6), (4096, 8192, 8190, 0.9), (3000, 6000, 2**40 + 7, 1.0),
    (131072, 262144, 262100, 0.8), (5000, 10000, 17, 0.0)],
    ids=["empty_ring", "wraps", "large_count", "path_shape", "none"])
def test_k13c_append_matches_plain(cuda, B, C, appended, p_sel):
    from siddhi_tpu_torch.ops import ratelimit as rl
    rng = np.random.default_rng(B + C)
    src, ring = _ring_case(rng, B, C, cuda)
    sel = torch.from_numpy(rng.random(B) < p_sel).to(cuda)
    base = torch.tensor(appended, device=cuda)
    want, wn = rl.ring_append_plain({k: v.clone() for k, v in ring.items()},
                                    src, sel, base)
    got, gn = rl.ring_append(ring, src, sel, base, counter="K13c append")
    assert int(gn) == int(wn)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("C,lo,n,with_valid", [
    (8192, 0, 0, True), (8192, 8000, 5000, True), (8192, 2**40 + 3, 8192,
                                                   False),
    (262144, 200000, 131072, True)],
    ids=["n_zero", "wraps", "large_lo_full", "path_shape"])
def test_k13c_gather_matches_plain(cuda, C, lo, n, with_valid):
    from siddhi_tpu_torch.ops import ratelimit as rl
    rng = np.random.default_rng(C + n)
    _, ring = _ring_case(rng, 1, C, cuda)
    rvalid = ring.pop("ok") if with_valid else None
    args = (ring, torch.tensor(lo, device=cuda), torch.tensor(n, device=cuda),
            rvalid)
    wc, wv = rl.ring_gather_plain(*args)
    gc, gv = rl.ring_gather(*args, counter="K13c gather")
    assert torch.equal(gv, wv)
    for k in wc:
        assert torch.equal(gc[k], wc[k]), k


def test_new_k7_k1_k5b_k13b_sites_match_plain(cuda):
    """The limiter and ORDER BY sites of the ported kernels: K7 on
    time-first bucket keys and on float64 order keys, K1's stable
    partition, K5b's running counts (int32 and int64 with a base) and
    K13b's last lane per group slot."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops import windows_extra as wx
    rng = np.random.default_rng(9)
    B = 131072
    kernels.reset_launch_counts()
    key = torch.from_numpy(np.where(rng.random(B) < 0.5,
                                    rng.integers(0, 50, B), 2**62)).to(cuda)
    assert torch.equal(
        search.stable_radix_argsort(key, counter="K7 time-first"),
        search.stable_radix_argsort_plain(key))
    f = torch.from_numpy(rng.choice([0.0, -0.0, np.nan, 1.5, -2.5, np.inf],
                                    B)).to(cuda)
    k = search.float64_sort_key(f)
    assert torch.equal(search.stable_radix_argsort(k, counter="K7 order by"),
                       search.stable_radix_argsort_plain(k))
    live = torch.from_numpy(rng.random(B) < 0.3).to(cuda)
    assert torch.equal(
        search.stable_partition_order(live, counter="K1 order by"),
        search.stable_partition_order_plain(live))
    for dt, base, counter in ((torch.int32, None, "K5b limit"),
                              (torch.int64, torch.tensor(2**40, device=cuda),
                               "K5b ordinal")):
        counts, total = groupby.running_count(live, counter=counter,
                                              base=base, dtype=dt)
        want = torch.cumsum(live.to(dt), 0) + (0 if base is None else base)
        assert torch.equal(counts, want.to(dt))
        assert int(total) == int(want[-1])
    G = 1024
    slot = torch.from_numpy(np.where(rng.random(B) < 0.9,
                                     rng.integers(0, G + 1, B), G)
                            .astype(np.int32)).to(cuda)
    comp = {"x": torch.from_numpy(rng.normal(size=B)).to(cuda)}
    old = {"x": torch.zeros(G, dtype=torch.float64, device=cuda)}
    present = torch.zeros(G, dtype=torch.bool, device=cuda)
    ones = torch.ones(B, dtype=torch.bool, device=cuda)
    gc, gp = wx.frequent_last_lane(slot, comp, ones, old, present, G,
                                   counter="K13b grouped snapshot")
    wc, wp = wx.frequent_last_lane_plain(slot, comp, ones, old, present, G)
    assert torch.equal(gp, wp) and torch.equal(gc["x"], wc["x"])
    for site in ("K7 time-first", "K7 order by", "K1 order by", "K5b limit",
                 "K5b ordinal", "K13b grouped snapshot"):
        assert kernels.LAUNCHES[site] > 0, site


LIMITERS_ON_CARD = {
    "last_every_100_events": (
        "from TradeStream select symbol, price output last every 100 events "
        "insert into OutStream;", ("K5b ordinal",)),
    "all_every_1_sec": (
        "from TradeStream select symbol, price, volume output all every 1 "
        "sec insert into OutStream;", ("K13c append", "K13c gather")),
    "last_every_1_sec": (
        "from TradeStream select symbol, price output last every 1 sec "
        "insert into OutStream;", ("K13c append", "K13c gather")),
    "all_every_7_events": (
        "from TradeStream select symbol, volume output all every 7 events "
        "insert into OutStream;", ("K13c append", "K13c gather")),
    "first_every_1_sec": (
        "from TradeStream select symbol, price output first every 1 sec "
        "insert into OutStream;", ("K7 time-first",)),
    "snapshot": (
        "from TradeStream select symbol, price output snapshot every 1 sec "
        "insert into OutStream;", ()),
    "grouped_snapshot": (
        "from TradeStream#window.time(3 sec) select symbol, avg(price) as ap, "
        "count() as n group by symbol output snapshot every 1 sec insert "
        "into OutStream;", ("K13b grouped snapshot",)),
    "windowed_snapshot": (
        "from TradeStream#window.length(300) select symbol, price output "
        "snapshot every 1 sec insert into OutStream;",
        ("K13c snapshot append", "K13c snapshot gather")),
    "contents_snapshot": (
        "from TradeStream#window.sort(50, price) select symbol, price output "
        "snapshot every 1 sec insert into OutStream;", ()),
    "order_limit": (
        "from TradeStream#window.lengthBatch(100) select symbol, "
        "sum(volume) as total, avg(price) as ap group by symbol order by "
        "total desc, ap limit 10 offset 2 insert into OutStream;",
        ("K7 order by", "K1 order by", "K5b limit")),
}


@pytest.mark.parametrize("name", sorted(LIMITERS_ON_CARD))
def test_rate_limiter_apps_on_card_match_cpu(cuda, name):
    """One app per limiter kind (and ORDER BY / LIMIT), card against CPU,
    with heartbeats past the feed so timed rates flush."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    query, on_path = LIMITERS_ON_CARD[name]
    app = ("@app:playback\ndefine stream TradeStream (symbol string, price "
           "double, volume long);\n@info(name = 'q') " + query)
    rng = np.random.default_rng(43)
    n, bs = 256 * 8, 256
    ts = 1_000 + np.cumsum(rng.integers(0, 12, n))
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 20, n)],
                               dtype=object),
            "price": rng.integers(1, 120, n) * 0.5,
            "volume": rng.integers(1, 30, n).astype(np.int64)}
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=bs)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        kernels.reset_launch_counts()
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, bs):
            h.send_columns({k: v[s:s + bs] for k, v in cols.items()},
                           timestamps=ts[s:s + bs])
            rt.flush()
        for dt in (1_000, 2_000):
            rt.heartbeat(int(ts[-1]) + dt)
        if dev == "cuda":
            for k in on_path:
                assert kernels.LAUNCHES[k] > 0, k
        outs.append(got)
    card, cpu = outs
    assert len(card) == len(cpu) > 0
    for (ta, da), (tb, db) in zip(card, cpu):
        assert ta == tb and da[0] == db[0]
        np.testing.assert_allclose(da[1:], db[1:], rtol=1e-5, atol=1e-3)


def _table_case(cuda, rng, B, C, n_live, kinds):
    """A table state and an insert batch whose keys collide with the
    rows and with each other (NaN and -0.0 among the float keys)."""
    from siddhi_tpu_torch.core.table import TableState

    def keys(kind, n):
        if kind == "double":
            return torch.from_numpy(rng.choice(
                np.array([0.0, -0.0, 1.5, np.nan, 2.0], np.float32), n))
        if kind == "bool":
            return torch.from_numpy(rng.random(n) < 0.5)
        dt = {"int": np.int32, "long": np.int64}[kind]
        return torch.from_numpy(rng.integers(-3, 4, n).astype(dt))

    live = np.zeros(C, bool)
    live[rng.choice(C, n_live, replace=False)] = True
    cols = {f"k{i}": keys(k, C) for i, k in enumerate(kinds)}
    cols["v"] = torch.from_numpy(rng.random(C).astype(np.float32))
    state = TableState({k: v.to(cuda) for k, v in cols.items()},
                       torch.arange(C, dtype=torch.int64, device=cuda),
                       torch.from_numpy(live).to(cuda))
    bcols = {f"k{i}": keys(k, B).to(cuda) for i, k in enumerate(kinds)}
    bcols["v"] = torch.from_numpy(rng.random(B).astype(np.float32)).to(cuda)
    bts = 10_000 + torch.arange(B, dtype=torch.int64, device=cuda)
    bvalid = torch.from_numpy(rng.random(B) < 0.9).to(cuda)
    return state, bcols, bts, bvalid


@pytest.mark.parametrize("B,C,n_live,kinds", [
    (1, 64, 10, ("long",)), (512, 4096, 0, ("int",)),
    (2048, 8192, 3000, ("int", "long")), (700, 2048, 2040, ("long",)),
    (300, 1024, 500, ("double", "bool")), (4096, 16, 16, ("long",))],
    ids=["B1", "empty", "two_keys", "full", "nan_keys", "table_full"])
def test_k13d_kernels_match_plain(cuda, B, C, n_live, kinds):
    """K13d dedup bit for bit with the [B, C] / [B, B] masks, and K13d
    place with the JAX scatter: the table state and both counts; an
    overflowing insert writes nothing."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.core.table import TableState
    from siddhi_tpu_torch.ops import search
    rng = np.random.default_rng(B + C)
    state, bcols, bts, bvalid = _table_case(cuda, rng, B, C, n_live, kinds)
    names = [f"k{i}" for i in range(len(kinds))]
    kernels.reset_launch_counts()
    lane = [bcols[k] for k in names]
    row = [state.cols[k] for k in names]
    drop = tb.pk_duplicates(lane, row, bvalid, state.valid)
    assert torch.equal(drop, tb.pk_duplicates_plain(lane, row, bvalid,
                                                    state.valid))
    free = search.stable_partition_order_plain(~state.valid)
    want, wcounts = tb.place_rows_plain(state, bcols, bts, bvalid, drop,
                                        free)
    copy = TableState({k: v.clone() for k, v in state.cols.items()},
                      state.ts.clone(), state.valid.clone())
    got, gcounts = tb.place_rows(copy, bcols, bts, bvalid, drop, free)
    assert torch.equal(gcounts, wcounts)
    expect = state if int(wcounts[0]) else want
    for k in state.cols:
        assert torch.equal(got.cols[k].view(torch.uint8),
                           expect.cols[k].view(torch.uint8)), k
    assert torch.equal(got.ts, expect.ts)
    assert torch.equal(got.valid, expect.valid)
    assert kernels.LAUNCHES["K13d dedup"] > 0
    assert kernels.LAUNCHES["K13d place"] > 0


@pytest.mark.parametrize("B,C,density", [
    (1, 65536, 0.3), (4096, 1, 0.5), (8192, 8192, 0.0001),
    (300, 5000, 0.0), (1000, 3000, 0.9)])
def test_k13e_kernel_matches_plain(cuda, B, C, density):
    from siddhi_tpu_torch.core import table as tb
    rng = np.random.default_rng(B ^ C)
    mask = torch.from_numpy(rng.random((B, C)) < density).to(cuda)
    for g, w in zip(tb.last_match(mask), tb.last_match_plain(mask)):
        assert torch.equal(g, w)


def test_new_k1_k7_k13b_table_sites_match_plain(cuda):
    """K1 on a table's free rows, K7 on its index keys (int32 codes,
    int64, float32 with NaN and -0.0), K13b's last lane per group of an
    on-demand aggregate."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.ops import search
    from siddhi_tpu_torch.ops import windows_extra as wx
    rng = np.random.default_rng(12)
    C = 65536
    kernels.reset_launch_counts()
    free = torch.from_numpy(rng.random(C) < 0.2).to(cuda)
    assert torch.equal(
        search.stable_partition_order(free, counter="K1 table free"),
        search.stable_partition_order_plain(free))
    for keys in (rng.integers(0, 60000, C).astype(np.int32),
                 rng.integers(-2**40, 2**40, C),
                 rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.5, np.inf],
                                     np.float32), C)):
        k = torch.from_numpy(keys).to(cuda)
        got = tb.sorted_index(k)
        want = torch.sort(k.cpu()).values.to(cuda)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)) \
            or torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    K = 1024
    slot = torch.from_numpy(rng.integers(0, K + 1, C).astype(np.int32)) \
        .to(cuda)
    assert torch.equal(
        wx.last_lane_per_slot(slot, K, counter="K13b final per group"),
        wx.last_lane_per_slot_plain(slot, K))
    for site in ("K1 table free", "K7 table index", "K13b final per group"):
        assert kernels.LAUNCHES[site] > 0, site


TABLE_APPS_ON_CARD = {
    "insert_primary_key": (
        "@PrimaryKey('symbol')\ndefine table T (symbol string, price double, "
        "volume long);\nfrom TradeStream insert into T;",
        (), ("K13d dedup", "K13d place", "K1 table free")),
    "in_indexed": (
        "@PrimaryKey('symbol')\ndefine table T (symbol string, price double, "
        "volume long);\nfrom TradeStream[volume < 10] insert into T;\n"
        "@info(name = 'q') from TradeStream[TradeStream.symbol == T.symbol "
        "in T] select symbol, price insert into OutStream;",
        ("q",), ("K7 table index",)),
    "in_scan": (
        "define table T (symbol string, price double, volume long);\n"
        "from TradeStream[volume < 10] insert into T;\n"
        "@info(name = 'q') from TradeStream[(TradeStream.symbol == T.symbol "
        "and TradeStream.price > T.price) in T] select symbol, price "
        "insert into OutStream;", ("q",), ("K13e",)),
    "update_or_insert": (
        "@PrimaryKey('symbol')\ndefine table T (symbol string, price double, "
        "volume long);\nfrom TradeStream update or insert into T set "
        "T.price = T.price + price, T.volume = volume on T.symbol == symbol;",
        (), ("K13e", "K13d dedup", "K13d place")),
    "update_and_delete": (
        "define table T (symbol string, price double, volume long);\n"
        "from TradeStream[volume < 15] insert into T;\n"
        "from TradeStream[volume >= 25] update T set T.price = price "
        "on T.symbol == symbol;\n"
        "from TradeStream[volume > 15 and volume < 20] delete T "
        "on T.symbol == symbol;", (), ("K13e",)),
    "join_table": (
        "@PrimaryKey('symbol')\ndefine table T (symbol string, price double, "
        "volume long);\nfrom TradeStream[volume < 5] insert into T;\n"
        "@info(name = 'q') from TradeStream as t join T as s on t.symbol == "
        "s.symbol select t.symbol, s.volume, t.price * s.price as w "
        "insert into OutStream;", ("q",), ()),
    "join_named_window": (
        "define window W (symbol string, price double, volume long) "
        "length(50);\nfrom TradeStream[volume < 10] insert into W;\n"
        "@info(name = 'q') from TradeStream as t join W as w on t.symbol == "
        "w.symbol select t.symbol, w.price as wp, t.price as tp "
        "insert into OutStream;", ("q",), ()),
}


@pytest.mark.parametrize("name", sorted(TABLE_APPS_ON_CARD))
def test_table_apps_on_card_match_cpu(cuda, name):
    """One app per table action, card against CPU: the callbacks, the
    table's rows and on-demand finds (a grouped one on K13b) and deletes
    over it."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    text, queries, on_path = TABLE_APPS_ON_CARD[name]
    app = ("@app:playback\ndefine stream TradeStream (symbol string, price "
           "double, volume long);\n" + text)
    rng = np.random.default_rng(61)
    n, bs = 256 * 6, 256
    ts = 1_000 + np.arange(n)
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 90, n)],
                               dtype=object),
            "price": rng.integers(1, 120, n) * 0.5,
            "volume": rng.integers(1, 30, n).astype(np.int64)}
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=bs)
        got = []
        if queries:
            rt.add_callback("OutStream", lambda evs, g=got: g.extend(
                (e.timestamp, e.data) for e in evs))
        kernels.reset_launch_counts()
        h = rt.get_input_handler("TradeStream")
        for s in range(0, n, bs):
            h.send_columns({k: v[s:s + bs] for k, v in cols.items()},
                           timestamps=ts[s:s + bs])
            rt.flush()
        store = "W" if "W" in rt.windows else "T"
        finds = [e.data for e in rt.query(
            f"from {store} select symbol, count() as c, sum(price) as p "
            "group by symbol")]
        if store == "T":
            finds.append(len(rt.tables["T"]))
            rt.query("delete T on T.price > 30.0")
            finds += sorted(rt.tables["T"].all_rows())
        if dev == "cuda":
            for k in on_path + ("K13b final per group",):
                assert kernels.LAUNCHES[k] > 0, k
        outs.append((got, finds))
    (card, cfind), (cpu, pfind) = outs
    assert len(card) == len(cpu) and len(cfind) == len(pfind) > 1
    assert (len(card) > 0) == bool(queries)
    for (ta, da), (tb_, db) in zip(card, cpu):
        assert ta == tb_ and da[0] == db[0]
        np.testing.assert_allclose(da[1:], db[1:], rtol=1e-5, atol=1e-3)
    for a, b in zip(cfind, pfind):
        if isinstance(a, tuple):
            assert a[0] == b[0]
            np.testing.assert_allclose(a[1:], b[1:], rtol=1e-5, atol=1e-3)
        else:
            assert a == b


# --------------------------------------------------------------------------- #
# K13f and incremental aggregation
# --------------------------------------------------------------------------- #

_K13F_SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25],
                          np.float32)


def _k13f_case(rng, n, K, dtype, op, cuda):
    w = rng.integers(0, K, n).astype(np.int32)
    w[rng.random(n) < 0.1] = K  # dropped lanes
    w[:3] = [-1, K + 5, K]
    if np.dtype(dtype).kind == "f":
        v = np.where(rng.random(n) < 0.4, rng.choice(_K13F_SPECIALS, n),
                     rng.normal(0, 50, n)).astype(dtype)
        base = np.zeros(K, dtype) if op == "add" else np.full(
            K, np.inf if op == "min" else -np.inf, dtype)
        base[:4] = np.array([0.0, -0.0, np.nan, 2.0]).astype(dtype)
    else:
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, n, dtype=dtype)
        base = np.zeros(K, dtype) if op == "add" else np.full(
            K, info.max if op == "min" else info.min, dtype)
    if op == "add" and np.dtype(dtype).kind == "f":
        v = np.where(np.isfinite(v), v, 1.0).astype(dtype)
    return (torch.from_numpy(w).to(cuda), torch.from_numpy(base).to(cuda),
            torch.from_numpy(v).to(cuda))


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64])
def test_k13f_kernel_matches_plain(cuda, op, dtype):
    """Each op and element type against the plain version: min/max and
    integer sums (int64 wrapping) bit for bit, NaN winning as the
    canonical NaN and -0.0 below +0.0; float sums within 1e-5 of the
    slot's sum of magnitudes (atomics add in another order)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import bucket_scatter as bs
    rng = np.random.default_rng(71)
    for n, K in ((5000, 64), (70001, 1 << 16)):
        w, base, v = _k13f_case(rng, n, K, dtype, op, cuda)
        got, want = base.clone(), base.clone()
        before = kernels.LAUNCHES["K13f ingest"]
        bs.bucket_scatter(w, [(got, v, op)])
        assert kernels.LAUNCHES["K13f ingest"] == before + 1
        bs.bucket_scatter_plain(w, [(want, v, op)])
        torch.cuda.synchronize()
        if op == "add" and v.dtype.is_floating_point:
            keep = (w >= 0) & (w < K)
            mag = torch.zeros(K, dtype=torch.float64, device=cuda)
            mag.index_add_(0, w[keep].long(), v[keep].double().abs())
            nan = torch.isnan(want)  # a NaN slot stays NaN in both
            assert torch.equal(torch.isnan(got), nan)
            err = (got.double() - want.double()).abs()[~nan]
            assert bool((err <= 1e-5 * torch.clamp(mag[~nan],
                                                   min=1.0)).all())
        else:
            assert _bits_equal(got, want)


def test_k13f_set_columns_match_plain(cuda):
    """One launch of every column kind: set int64/int32/float32/bool,
    the alive flags, and a sum beside them."""
    from siddhi_tpu_torch.ops import bucket_scatter as bs
    rng = np.random.default_rng(72)
    n, K = 40000, 1 << 15
    w = torch.from_numpy(rng.integers(0, K + 1, n).astype(np.int32)).to(cuda)
    slot = torch.from_numpy(rng.integers(-(2**40), 2**40, K + 1)).to(cuda)
    src = [slot[w.long()], (slot[w.long()] % 1000).to(torch.int32),
           (slot[w.long()] % 77).to(torch.float32) - 0.5,
           (slot[w.long()] % 2 == 0)]
    outs = []
    for fn in (bs.bucket_scatter, bs.bucket_scatter_plain):
        dst = [torch.zeros(K, dtype=s.dtype, device=cuda) for s in src]
        alive = torch.zeros(K, dtype=torch.bool, device=cuda)
        fn(w, [(d, s, "set") for d, s in zip(dst, src)]
           + [(alive, None, "true")])
        outs.append(dst + [alive])
    for a, b in zip(*outs):
        assert _bits_equal(a, b)
    with pytest.raises(ValueError, match="set only"):
        bs.bucket_scatter(w, [(outs[0][3], src[3], "add")])


def test_bucket_start_on_card_matches_cpu(cuda):
    from siddhi_tpu_torch.core import aggregation as agg
    from siddhi_tpu_torch.query_api.definition import Duration
    rng = np.random.default_rng(73)
    ts = torch.from_numpy(np.concatenate([
        rng.integers(-(2**42), 2**42, 100000),
        np.array([0, -1, -1000, -86_400_001, 951_782_400_000,
                  1_767_225_599_999, 1_767_225_600_000])]))
    for d in Duration:
        assert torch.equal(agg.bucket_start(d, ts.to(cuda)).cpu(),
                           agg.bucket_start(d, ts))


def test_aggregation_app_on_card_matches_cpu(cuda):
    """`every sec ... year` with a join per 'hour', @purge retention on
    the heartbeat, finds and a further group-by, card against CPU; the
    K3, K4 and K13f sites launched, none of the ingest's plain paths."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    app = """@app:playback
    define stream TradeStream (symbol string, price double, volume long,
                               ts long);
    define stream QueryStream (symbol string);
    @purge(enable='true', @retentionPeriod(sec='5 min'))
    define aggregation TradeAgg from TradeStream
    select symbol, sum(price) as total, avg(price) as ap, min(price) as lo,
           max(price) as hi, count() as n, sum(volume) as vol
    group by symbol aggregate by ts every sec ... year;
    @info(name='j')
    from QueryStream join TradeAgg on QueryStream.symbol == TradeAgg.symbol
    per 'hour'
    select QueryStream.symbol as symbol, TradeAgg.AGG_TIMESTAMP as b,
           TradeAgg.n as n insert into JoinOut;
    """
    rng = np.random.default_rng(74)
    n, bs = 4096 * 4, 4096
    t0 = 1_767_224_400_000  # 2025-12-31 23:40:00 UTC
    ts = t0 + np.arange(n) * 100
    price = rng.integers(1, 4000, n) * 0.25
    price[rng.random(n) < 0.001] = np.nan
    cols = {"symbol": np.array([f"S{i}" for i in rng.integers(0, 300, n)],
                               dtype=object),
            "price": price, "volume": rng.integers(1, 99, n),
            "ts": ts}
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=bs, group_capacity=1 << 14)
        got = []
        rt.add_callback("JoinOut", lambda evs, g=got: g.extend(
            e.data for e in evs))
        kernels.reset_launch_counts()
        seen = []
        for s in range(0, n, bs):
            rt.get_input_handler("TradeStream").send_columns(
                {k: v[s:s + bs] for k, v in cols.items()},
                timestamps=ts[s:s + bs])
            rt.flush()
            now = int(ts[s + bs - 1])
            rt.heartbeat(now)
            seen.append(sorted(e.data for e in rt.query(
                f"from TradeAgg within {now - 300_000}, {now + 1} per 'sec' "
                "select symbol, sum(total) as t, sum(n) as c "
                "group by symbol")))
            for d in ("min", "month", "year"):
                seen.append(sorted(e.data for e in rt.query(
                    f"from TradeAgg within 0, 4102444800000 per '{d}' "
                    "select symbol, total, ap, lo, hi, n, vol, "
                    "AGG_TIMESTAMP")))
            rt.get_input_handler("QueryStream").send_columns(
                {"symbol": cols["symbol"][s:s + 64]})
            rt.flush()
        if dev == "cuda":
            for k in ("K3 aggregation", "K4 aggregation", "K13f ingest",
                      "K13f evict"):
                assert kernels.LAUNCHES[k] > 0, k
        outs.append((sorted(got), seen))
    (cj, cseen), (pj, pseen) = outs
    assert cj == pj and len(cj) > 0
    for a, b in zip(cseen, pseen):
        assert len(a) == len(b) > 0
        for ra, rb in zip(a, b):
            assert ra[0] == rb[0] and ra[-1] == rb[-1]
            np.testing.assert_allclose(np.array(ra[1:], float),
                                       np.array(rb[1:], float), rtol=1e-5,
                                       atol=1e-3)


# ------------------------------------------------ K12b and the superstep


@pytest.mark.parametrize("K,W", [(1, 1), (4, 1023), (8, 3000), (32, 1025)])
def test_k12b_kernel_matches_plain(cuda, K, W):
    from siddhi_tpu_torch.ops import superstep_pack as sp
    rng = np.random.default_rng(K * 7 + W)
    ts = torch.from_numpy(rng.integers(0, 2**50, (K, W))).to(cuda)
    valid = rng.random((K, W)) < 0.45
    valid[0] = False  # an iteration with no valid lane
    valid[-1] = True  # and one with every lane valid
    valid = torch.from_numpy(valid).to(cuda)
    cols = {"s": torch.from_numpy(rng.integers(0, 9999, (K, W)).astype(
                np.int32)).to(cuda),
            "f": torch.from_numpy(rng.normal(size=(K, W)).astype(
                np.float32)).to(cuda),
            "l": torch.from_numpy(rng.integers(-2**62, 2**62, (K, W))).to(
                cuda),
            "h": torch.from_numpy(rng.integers(-99, 99, (K, W)).astype(
                np.int16)).to(cuda),
            "b": torch.from_numpy(rng.random((K, W)) < 0.5).to(cuda)}
    buf, layout = sp.superstep_pack(ts, valid, cols)
    plain = sp.superstep_pack_plain(ts, valid, cols)
    assert torch.equal(sp.pack_payload(buf, layout),
                       sp.pack_payload(plain, layout))


def test_superstep_app_on_card_matches_k1():
    """App AG's shape at a small size on the card: K = 4 against K = 1,
    every block exact, the superstep engaged, one K12b a superstep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from siddhi_tpu_torch import SiddhiManager, kernels
    rng = np.random.default_rng(5)
    n, bs = 64 * 256, 256
    cols = {"symbol": np.array([f"S{k}" for k in rng.integers(0, 500, n)],
                               dtype=object),
            "price": rng.uniform(1.0, 1000.0, n),
            "volume": rng.integers(1, 1000, n)}
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)

    def run(k):
        ss = f"@app:superstep(k='{k}')\n" if k > 1 else ""
        rt = SiddhiManager().create_siddhi_app_runtime(
            f"@app:name('AGs{k}')\n{ss}"
            f"@Async(buffer.size='{bs}', workers='2')\n"
            "define stream TradeStream (symbol string, price double, "
            "volume long);\n"
            "from TradeStream[price < 700.0] select symbol, price, volume "
            "insert into MidStream;\n"
            "from MidStream#window.lengthBatch(1000) select symbol, "
            "sum(price) as total, avg(price) as avgPrice group by symbol "
            "insert into SummaryStream;", batch_size=bs,
            group_capacity=1 << 12, async_callbacks=True)
        blocks = []
        rt.add_callback("SummaryStream", lambda b: blocks.append(
            (b.timestamps.copy(), {c: v.copy()
                                   for c, v in b.columns.items()})),
            columnar=True)
        rt.start()
        kernels.reset_launch_counts()
        try:
            h = rt.get_input_handler("TradeStream")
            for r in range(0, n, 4 * bs):
                h.send_columns({c: v[r:r + 4 * bs] for c, v in cols.items()},
                               timestamps=ts[r:r + 4 * bs])
            rt.drain()
            snap = rt.junctions["TradeStream"]._pipeline.stats_snapshot()
        finally:
            rt.shutdown()
        return blocks, snap, kernels.LAUNCHES["K12b"]

    want, s1, l1 = run(1)
    got, s4, l4 = run(4)
    assert s4["superstep_decline"] is None
    assert s4["supersteps_dispatched"] == n // bs // 4
    assert l1 == 0 and l4 == s4["supersteps_dispatched"]
    assert len(got) == len(want) > 0
    for (gt, gc), (wt, wc) in zip(got, want):
        assert np.array_equal(gt, wt)
        for c in wc:
            assert np.array_equal(gc[c], wc[c]), c


# ------------------------------------------- K5/K5b scans, K7 onesweep sort

K5_SIZES = ["one", "tile-1", "tile", "tile+1", "3tiles+5"]
K5_DTYPES = [torch.float32, torch.float64, torch.int64, torch.int32]


def _edge_n(name: str, tile: int) -> int:
    return {"one": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "3tiles+5": 3 * tile + 5}[name]


def _k5_values(rng, dt, n):
    if dt.is_floating_point:
        return torch.from_numpy(rng.uniform(-100, 100, n)).to(dt)
    return torch.from_numpy(rng.integers(-50, 50, n)).to(dt)


def _exact(fn, args, values):
    """fn (a plain scan) in float64 on the deltas and on their magnitudes:
    the exact sums and the sums of |x| that bound a float sum's rounding."""
    def conv(a, f):
        if isinstance(a, list):
            return [conv(x, f) for x in a]
        return f(a.double()) if a.dtype.is_floating_point else a

    def run(f):
        return fn([f(v.double()) for v in values],
                  *[conv(a, f) for a in args])
    return run(lambda t: t), run(torch.abs)


def _assert_k5(a, b, dt, op, exact=None, mag=None):
    """Bit for bit, except float sums: another association than the plain
    version's, so both within 1e-5 of the sum of magnitudes (+ 1e-3) of
    the exact float64 sum."""
    a = a.cpu()
    if dt.is_floating_point and op == "sum":
        tol = 1e-5 * mag + 1e-3
        assert bool(((a.double() - exact).abs() <= tol).all())
        assert bool(((b.double() - exact).abs() <= tol).all())
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", K5_SIZES)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_k5_scans_at_tile_edges_match_plain(cuda, size, op):
    """K5b grouped and ungrouped and K5 fused at n around the tile: resets
    on tile edges, one segment spanning every tile (ungrouped, no resets;
    grouped, one slot), dead epochs in the state, all four types."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    tile = kernels.library("k5_grouped_scan").k5_tile_lanes(0)
    n = _edge_n(size, tile)
    rng = np.random.default_rng(n)
    K = 50
    edges = np.zeros(n, bool)
    edges[::tile] = True

    def grouped(vals, slots, d, valid, resets, epoch, ep=None):
        st, o = groupby.grouped_scan_plain(
            groupby.GroupState(vals[0], ep), slots, d, valid, resets, epoch,
            op)
        return st.values, o

    def ungrouped(vals, d, valid, resets, epoch, ep=None):
        st, o = groupby.ungrouped_scan_plain(
            groupby.GroupState(vals[0], ep), d, valid, resets, epoch, op)
        return st.values, o

    def fused(fn):
        def run(vals, *a, ep=None):
            v, _, o = fn(vals, ep, *a)
            return v, o
        return run

    for layout in ("random", "spanning"):
        if layout == "random":
            slots = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
            resets = torch.from_numpy((rng.random(n) < 0.001) | edges)
        else:
            slots = torch.full((n,), 7, dtype=torch.int32)
            resets = torch.zeros(n, dtype=torch.bool)
        valid = torch.from_numpy(rng.random(n) < 0.9)
        epoch = torch.tensor(3, dtype=torch.int32)
        for dt in K5_DTYPES:
            d = _k5_values(rng, dt, n)
            vals = _k5_values(rng, dt, K)
            ep = torch.from_numpy(rng.integers(2, 5, K).astype(np.int32))
            args = (slots, d, valid, resets, epoch)
            ps, po = groupby.grouped_scan_plain(
                groupby.GroupState(vals.clone(), ep.clone()), *args, op)
            ks, ko = groupby.grouped_scan(
                groupby.GroupState(vals.to(cuda), ep.to(cuda)),
                *[a.to(cuda) for a in args], op)
            assert torch.equal(ks.epoch.cpu(), ps.epoch)
            ex, mag = _exact(lambda v, *a: grouped(v, *a, ep=ep), args,
                             [vals])
            _assert_k5(ks.values, ps.values, dt, op, ex[0], mag[0])
            _assert_k5(ko, po, dt, op, ex[1], mag[1])
            for live in (True, False):
                cell = vals[:1].clone()
                ecell = torch.tensor([3 if live else 2], dtype=torch.int32)
                uargs = (d, valid, resets, epoch)
                pu, puo = groupby.ungrouped_scan_plain(
                    groupby.GroupState(cell.clone(), ecell.clone()), *uargs,
                    op)
                ku, kuo = groupby.ungrouped_scan(
                    groupby.GroupState(cell.to(cuda), ecell.to(cuda)),
                    *[a.to(cuda) for a in uargs], op)
                assert torch.equal(ku.epoch.cpu(), pu.epoch)
                ex, mag = _exact(lambda v, *a: ungrouped(v, *a, ep=ecell),
                                 uargs, [cell])
                _assert_k5(ku.values, pu.values, dt, op, ex[0], mag[0])
                _assert_k5(kuo, puo, dt, op, ex[1], mag[1])
        if op != "sum":
            continue
        comps = [_k5_values(rng, dt, n) for dt in
                 (torch.float32, torch.int64, torch.int32)]
        vals = [_k5_values(rng, c.dtype, K) for c in comps]
        ep = torch.from_numpy(rng.integers(2, 5, K).astype(np.int32))
        lanes = (valid, resets, epoch)
        for plain, card, cells, e0, pre in (
                (groupby.grouped_scan_fused_plain,
                 groupby.grouped_scan_fused, vals, ep, (slots,)),
                (groupby.ungrouped_scan_fused_plain,
                 groupby.ungrouped_scan_fused, [v[:1] for v in vals],
                 torch.tensor([3], dtype=torch.int32), ())):
            pv, pe, po = plain([v.clone() for v in cells], e0.clone(), *pre,
                               comps, *lanes)
            kv, ke, ko = card([v.to(cuda) for v in cells], e0.to(cuda),
                              *[a.to(cuda) for a in pre],
                              [c.to(cuda) for c in comps],
                              *[a.to(cuda) for a in lanes])
            assert torch.equal(ke.cpu(), pe)
            ex, mag = _exact(
                lambda v, *a, e0=e0, plain=plain: fused(plain)(
                    v, *a, ep=e0.clone()),
                (*pre, [c.double() for c in comps], *lanes), cells)
            for c in range(3):
                _assert_k5(kv[c], pv[c], comps[c].dtype, op, ex[0][c],
                           mag[0][c])
                _assert_k5(ko[c], po[c], comps[c].dtype, op, ex[1][c],
                           mag[1][c])


@pytest.mark.parametrize("size", K5_SIZES + ["site"])
def test_k5b_running_count_matches_plain(cuda, size):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    tile = kernels.library("k5_grouped_scan").k5_tile_lanes(0)
    n = 141_087 if size == "site" else _edge_n(size, tile)
    rng = np.random.default_rng(n)
    mask = torch.from_numpy(rng.random(n) < 0.97)
    for dt, base in ((torch.int32, None),
                     (torch.int64, torch.tensor(2**40 + 3))):
        pc, pt = groupby.running_count_plain(mask, base, dt)
        kernels.reset_launch_counts()
        kc, kt = groupby.running_count(
            mask.to(cuda), counter="K5b limit",
            base=None if base is None else base.to(cuda), dtype=dt)
        assert kernels.LAUNCHES["K5b limit"] == 1
        assert kc.dtype == dt and torch.equal(kc.cpu(), pc)
        assert kt.shape == () and int(kt) == int(pt)


def test_k5_float_sums_are_bit_identical_across_runs(cuda):
    """Float sums fold the tile aggregates in a fixed order: the same
    inputs give the same bits, grouped (K = 2^20) and ungrouped, at the
    sites' width."""
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(15)
    L, K = 262_144, 1 << 20
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(cuda)
    resets = torch.zeros(L, dtype=torch.bool, device=cuda)
    epoch = torch.zeros((), dtype=torch.int32, device=cuda)
    for dt in (torch.float32, torch.float64):
        d = torch.from_numpy(rng.normal(size=L) * 1e3).to(dt).to(cuda)
        outs = []
        for _ in range(2):
            st = groupby.init_group_state(K, dt, cuda)
            st, o = groupby.grouped_scan(st, slots, d, valid, resets, epoch)
            cell = groupby.init_group_state(1, dt, cuda)
            cell, u = groupby.ungrouped_scan(cell, d, valid, resets, epoch)
            outs.append((o, st.values, u, cell.values))
        for a, b in zip(*outs):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_k5_launches_match_the_counters(cuda):
    """One launch a K5b component, one a K5 plan of up to four sum
    components (six take two, the second writing the epochs)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(16)
    L, K = 10_000, 64
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(cuda)
    resets = torch.from_numpy(rng.random(L) < 0.001).to(cuda)
    epoch = torch.tensor(2, dtype=torch.int32, device=cuda)
    comps = [torch.from_numpy(rng.integers(-9, 9, L)).to(dt).to(cuda)
             for dt in (torch.int64, torch.int32, torch.float64,
                        torch.int64, torch.int32, torch.int64)]
    vals = [torch.from_numpy(rng.integers(-9, 9, K)).to(c.dtype).to(cuda)
            for c in comps]
    ep = torch.from_numpy(rng.integers(1, 4, K).astype(np.int32)).to(cuda)
    kernels.reset_launch_counts()
    kv, ke, ko = groupby.grouped_scan_fused(
        [v.clone() for v in vals], ep.clone(), slots, comps, valid, resets,
        epoch)
    pv, pe, po = groupby.grouped_scan_fused_plain(
        [v.cpu() for v in vals], ep.cpu(), slots.cpu(),
        [c.cpu() for c in comps], valid.cpu(), resets.cpu(), epoch.cpu())
    assert torch.equal(ke.cpu(), pe)
    for a, b in zip(kv + ko, pv + po):  # integer-valued: exact
        assert torch.equal(a.cpu(), b)
    groupby.ungrouped_scan_fused(
        [torch.zeros(1, dtype=torch.int64, device=cuda) for _ in range(2)],
        torch.zeros(1, dtype=torch.int32, device=cuda), comps[:1] * 2,
        valid, resets, epoch)
    groupby.grouped_scan(groupby.init_group_state(K, torch.int64, cuda),
                         slots, comps[0], valid, resets, epoch, "max")
    groupby.ungrouped_scan(groupby.init_group_state(1, torch.int64, cuda),
                           comps[0], valid, resets, epoch, "min")
    assert kernels.LAUNCHES["K5"] == 2
    assert kernels.LAUNCHES["K5 ungrouped"] == 1
    assert kernels.LAUNCHES["K5b grouped"] == 1
    assert kernels.LAUNCHES["K5b ungrouped"] == 1


def _k7_keys(rng, kind: str, n: int):
    """(keys, bound) of one K7 edge case."""
    if kind == "u32":
        return rng.integers(0, 1 << 20, n).astype(np.int32), (1 << 20) - 1
    if kind == "i32":
        k = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        k[rng.integers(0, n, max(1, n // 50))] = np.int32(-2**31)
        k[rng.integers(0, n, max(1, n // 50))] = np.int32(2**31 - 1)
        return k, None
    if kind == "i64":
        k = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
        k[rng.integers(0, n, max(1, n // 50))] = -2**63
        k[rng.integers(0, n, max(1, n // 50))] = 2**63 - 1
        k[rng.integers(0, n, max(1, n // 50))] = -1
        return k, None
    if kind == "i64_some_digits":  # bytes 1 and 4 vary, the rest constant
        k = (rng.integers(0, 256, n, dtype=np.int64) << 8) | \
            (rng.integers(0, 4, n, dtype=np.int64) << 32) | (-7 << 48)
        return k, None
    if kind == "i64_equal":
        return np.full(n, -123456789012, np.int64), None
    if kind == "u32_equal":
        return np.full(n, 77, np.int32), 1000
    return np.full(n, -5, np.int32), None  # i32_equal


K7_SIZES = ["one", "tile-1", "tile", "tile+1", "3tiles+5", "small",
            "small+1", "site", "past the grid"]
K7_KINDS = ["u32", "i32", "i64", "i64_some_digits", "i64_equal",
            "u32_equal", "i32_equal"]


@pytest.mark.parametrize("size", K7_SIZES)
@pytest.mark.parametrize("kind", K7_KINDS)
def test_k7_onesweep_edge_shapes_match_plain(cuda, size, kind):
    """Sizes around a pass tile and the one-block limit, and one more
    tile than the cooperative grid holds at once (a block walks two
    tiles); keys constant in every digit (every pass skipped), in some
    digits only, signed int32 and int64 with their extremes; the full
    order and width < n; one launch a sort."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    tile = kernels.bind("k7_radix_sort", "k7_tile_keys", [])()
    small = kernels.bind("k7_radix_sort", "k7_small_max", [])()
    cap = kernels.bind("k7_radix_sort", "k7_grid_capacity",
                       [ctypes.c_int])(8)
    n = {"small": small, "small+1": small + 1, "site": 393_216,
         "past the grid": (cap + 1) * tile + 7}.get(size) \
        or _edge_n(size, tile)
    rng = np.random.default_rng(n + len(kind))
    keys, bound = _k7_keys(rng, kind, n)
    k = torch.from_numpy(keys).to(cuda)
    for width in (n, max(0, n // 3)):
        kernels.reset_launch_counts()
        got = search.stable_radix_argsort(k, bound, width, counter="K7 rank")
        want = search.stable_radix_argsort_plain(k, bound, width)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert kernels.LAUNCHES["K7 rank"] == 1


# ------------------------------------------------ K11a and K13a at their edges


def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K11A_EDGES = ["no equality", "bool", "int32 x2", "int64 negative",
              "four columns", "long runs, unsorted ts",
              "within fails then passes", "every entry matches",
              "no entry matches", "wild ts", "residual tiles",
              "dead entries", "live mask", "sequence", "sequence residual",
              "P = 0", "B = 1", "no valid lane"]


@pytest.mark.parametrize("name", K11A_EDGES)
def test_k11a_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-32 cases of first_match, bit for bit, with
    K11a's launches: the index, then one probe a residual tile."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import pattern
    cases = _chip_smoke().k11a_edge_cases(
        torch, np.random.default_rng(32), cuda)
    assert sorted(cases) == sorted(K11A_EDGES)
    args, kw = cases[name]
    kernels.reset_launch_counts()
    got = pattern.first_match(*args, **kw)
    want = pattern.first_match_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    B, P, sequence = args[0].shape[0], args[5].shape[0], args[9]
    tiles = -(-P // kw["tile"]) if kw["residual"] else min(P, 1)
    index = 0 if sequence or not P or not B else 1
    assert kernels.LAUNCHES["K11a"] == tiles + index
    if name == "every entry matches":
        assert torch.equal(got[1], args[5])
    if name in ("no entry matches", "no valid lane"):
        assert not bool(got[1].any())


def test_k11a_interleaved_calls_keep_their_own_index(cuda, monkeypatch):
    """Two first_match calls on one stream, the second enqueued whole
    between the first's index and its probes (as two sending threads or
    @Async feeders of two pattern apps can do): each call probes its own
    batch's index, so both match first_match_plain bit for bit."""
    from siddhi_tpu_torch.ops import pattern
    cs = _chip_smoke()
    one, two = (cs._k11a_case(torch, np.random.default_rng(seed), cuda,
                              1500, 3000, kinds=("i32", "i32"),
                              residual=True) for seed in (16, 17))
    tiles, inner = pattern._residual_tiles, []

    def interleaved(*a, **k):
        it = tiles(*a, **k)
        if not inner:  # the outer call: its index is already enqueued
            inner.append(None)
            inner[0] = pattern.first_match(*two[0], **two[1])
        yield from it

    monkeypatch.setattr(pattern, "_residual_tiles", interleaved)
    got_one = pattern.first_match(*one[0], **one[1])
    monkeypatch.undo()
    torch.cuda.synchronize()
    for got, (args, kw) in ((got_one, one), (inner[0], two)):
        for g, w in zip(got, pattern.first_match_plain(*args, **kw)):
            assert torch.equal(g, w)
    assert not torch.equal(got_one[0], inner[0][0])


K11CD_BASES = ["no equality", "bool", "int32 x2", "int64 negative",
               "four columns", "long runs, unsorted ts",
               "no equality, unsorted ts", "within fails then passes",
               "every entry matches", "no entry matches", "wild ts",
               "residual tiles", "long runs, residual tiles",
               "dead entries", "P = 0", "B = 1", "no valid lane"]


@pytest.mark.parametrize("base", K11CD_BASES)
def test_k11c_k11d_edges_match_plain(cuda, base):
    """chip_smoke.py's phase-33 cases of absent_scan (a deadline each
    side, untimed) and match_count (with and without `within`) on one
    batch, bit for bit, with their launches: with their own index (the
    gather, K7 an equality column, one probe a residual tile), then on an
    index built beforehand (the probes alone)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import pattern
    cs = _chip_smoke()
    assert sorted(cs.K11CD_BASES) == sorted(K11CD_BASES)
    cases = cs.k11cd_edge_cases(torch, np.random.default_rng(33), cuda)
    mine = {n: c for n, c in cases.items()
            if n.split(" ", 1)[1].rsplit(", ", 1)[0] == base}
    assert len(mine) == 4
    for name, case in mine.items():
        kernel, args, kw = case
        want = cs.run_k11cd_case(pattern, case, plain=True)
        probes, index = cs.k11cd_launches(args, kw)
        shared = pattern.match_index(args[0], args[1], args[2],
                                     [a for a, _ in args[3]])
        for idx, built in ((None, index), (shared, 0)):
            kernels.reset_launch_counts()
            got = cs.run_k11cd_case(pattern, case, plain=False, index=idx)
            for g, w in zip(got, want):
                assert torch.equal(g, w), name
            assert kernels.LAUNCHES[kernel] == probes + built, name
            assert (kernels.LAUNCHES["K7 pattern index"]
                    == len(args[3]) * built), name


@pytest.mark.parametrize("kernel", ["K11c", "K11d"])
def test_k11c_k11d_interleaved_calls_keep_their_own_index(cuda, monkeypatch,
                                                          kernel):
    """Two absent_scan (match_count) calls on one stream, the second
    enqueued whole between the first's index and its probes: each call
    probes its own batch's index, so both match their plain versions bit
    for bit."""
    from siddhi_tpu_torch.ops import pattern
    cs = _chip_smoke()
    name = f"{kernel} residual tiles, " + (
        "deadline" if kernel == "K11c" else "within")
    one, two = (cs.k11cd_edge_cases(torch, np.random.default_rng(seed),
                                    cuda)[name] for seed in (16, 17))
    tiles, inner = pattern._residual_tiles, []

    def interleaved(*a, **k):
        it = tiles(*a, **k)
        if not inner:  # the outer call: its index is already enqueued
            inner.append(None)
            inner[0] = cs.run_k11cd_case(pattern, two, plain=False)
        yield from it

    monkeypatch.setattr(pattern, "_residual_tiles", interleaved)
    got_one = cs.run_k11cd_case(pattern, one, plain=False)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for got, case in ((got_one, one), (inner[0], two)):
        for g, w in zip(got, cs.run_k11cd_case(pattern, case, plain=True)):
            assert torch.equal(g, w)
    assert not torch.equal(got_one[0], inner[0][0])


def test_sticky_step_builds_one_index(cuda):
    """A B step of `every a -> every b[b.val == a.val] within`: its four
    sticky K11a passes and its K11d count probe one index of the batch
    (one K7 sort, one gather under K11a's counter)."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.core import dtypes
    app = """
    @app:playback
    define stream A (val int);
    define stream B (val int);
    @info(name = 'bench')
    from every a=A -> every b=B[b.val == a.val] within 1 sec
    select a.val as av, b.val as bv
    insert into OutStream;
    """
    rt = SiddhiManager(device="cuda").create_siddhi_app_runtime(
        app, batch_size=256)
    rng = np.random.default_rng(5)
    rt.get_input_handler("A").send_columns(
        {"val": rng.integers(0, 8, 200).astype(np.int32)},
        timestamps=1000 + np.arange(200))
    rt.flush()
    kernels.reset_launch_counts()
    rt.get_input_handler("B").send_columns(
        {"val": rng.integers(0, 8, 200).astype(np.int32)},
        timestamps=1300 + np.arange(200))
    rt.flush()
    passes = dtypes.config.pattern_sticky_passes
    assert kernels.LAUNCHES["K7 pattern index"] == 1
    assert kernels.LAUNCHES["K11a"] == 1 + passes
    assert kernels.LAUNCHES["K11d"] == 1


@pytest.mark.parametrize("mode", [0, 1], ids=["sliding", "batch"])
def test_k13a_edges_match_plain(cuda, mode):
    """chip_smoke.py's phase-32 cases of both walks, bit for bit, one
    launch a call; among them the 2B + E + 8 cap biting (E below -2B)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import expression_general as eg
    cs = _chip_smoke()
    cases = cs.k13a_edge_cases(torch, np.random.default_rng(32), cuda)
    counter = "K13a sliding" if mode == 0 else "K13a batch"
    n = 0
    for name, case in cases.items():
        if case[0] != mode:
            continue
        kernels.reset_launch_counts()
        got = cs.run_k13a_case(eg, case, plain=False)
        assert kernels.LAUNCHES[counter] == 1, name
        for g, w in zip(got, cs.run_k13a_case(eg, case, plain=True)):
            assert torch.equal(g, w), name
        n += 1
    assert n >= 20


# ------------------------------------------ K13d and K1 at their edges


K13D_EDGES = ["float32 NaN ±0 ±inf", "float64 NaN ±0 ±inf",
              "float32 NaN ±0 beside int64", "float64 NaN ±0 beside int32",
              "int64 pairs swapped", "bool beside int64",
              "int64 differing above bit 32",
              "every lane one key, live in the table",
              "every lane one key, not in the table",
              "repeats behind invalid lanes", "B = 0", "C = 0", "B = 1",
              "large C: B = 1024 against C = 1048576"]


def _k13d_edges(cs, cuda):
    return cs.k13d_edge_cases(torch, np.random.default_rng(24), cuda,
                              B=2048, C=8192, C_big=1 << 20, B_big=1024)


@pytest.mark.parametrize("name", K13D_EDGES)
def test_k13d_dedup_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-24 dedup cases, bit for bit against the [B, C]
    and [B, B] masks, one launch a call (none at B = 0)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    cases = _k13d_edges(_chip_smoke(), cuda)
    assert sorted(cases) == sorted(K13D_EDGES)
    lane, row, lv, rv = cases[name]
    kernels.reset_launch_counts()
    got = tb.pk_duplicates(lane, row, lv, rv)
    assert torch.equal(got, tb.pk_duplicates_plain(lane, row, lv, rv))
    assert kernels.LAUNCHES["K13d dedup"] == (1 if lv.shape[0] else 0)
    if name.startswith(("every lane", "repeats")):
        assert int(got.sum()) > 0


def test_k13d_dedup_tables_of_two_sizes_alternate_on_one_stream(cuda):
    """A table of 2^20 rows and one of 8,192 (and none) take turns on one
    stream: each call finds the workspace its predecessor left zero."""
    from siddhi_tpu_torch.core import table as tb
    cases = _k13d_edges(_chip_smoke(), cuda)
    for name in 3 * [K13D_EDGES[-1], "int64 pairs swapped", "C = 0"]:
        lane, row, lv, rv = cases[name]
        assert torch.equal(tb.pk_duplicates(lane, row, lv, rv),
                           tb.pk_duplicates_plain(lane, row, lv, rv)), name


K13D_PLACE_EDGES = ["B = 1 into C = 64", "B = 0", "exact fit",
                    "one too many", "B = 131072 into 2^18"]


@pytest.mark.parametrize("name", K13D_PLACE_EDGES)
def test_k13d_place_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-24 placements: the state and both counts
    against place_rows_plain; one lane too many writes nothing."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    cs = _chip_smoke()
    cases = cs.place_edge_cases(torch, np.random.default_rng(25), cuda)
    assert sorted(cases) == sorted(K13D_PLACE_EDGES)
    kernels.reset_launch_counts()
    cs.check_place(name, tb, *cases[name])
    assert kernels.LAUNCHES["K13d place"] == 1


def test_table_insert_launches_one_dedup_one_k1_one_place(cuda):
    """table_insert on the card: the dedup, K1 on the free rows and the
    placement, one launch each, against the plain versions."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops import search
    rng = np.random.default_rng(26)
    state, bcols, bts, bvalid = _table_case(cuda, rng, 3000, 8192, 5000,
                                            ("long", "int"))
    batch = EventBatch(ts=bts, cols=bcols, valid=bvalid,
                       types=torch.zeros(3000, dtype=torch.int8,
                                         device=cuda))
    names = ("k0", "k1")
    drop = tb.pk_duplicates_plain([bcols[k] for k in names],
                                  [state.cols[k] for k in names], bvalid,
                                  state.valid)
    want, wcounts = tb.place_rows_plain(
        state, bcols, bts, bvalid, drop,
        search.stable_partition_order_plain(~state.valid))
    kernels.reset_launch_counts()
    got, counts = tb.table_insert(tb.TableState(
        {k: v.clone() for k, v in state.cols.items()}, state.ts.clone(),
        state.valid.clone()), batch, names)
    assert {k: kernels.LAUNCHES[k] for k in ("K13d dedup", "K1 table free",
                                             "K13d place")} == \
        {"K13d dedup": 1, "K1 table free": 1, "K13d place": 1}
    assert torch.equal(counts, wcounts) and int(counts[0]) == 0
    for k in state.cols:
        assert torch.equal(got.cols[k].view(torch.uint8),
                           want.cols[k].view(torch.uint8)), k
    assert torch.equal(got.valid, want.valid)


def test_k1_edges_match_plain(cuda):
    """chip_smoke.py's phase-2 K1 edges in their order (small calls right
    after the largest), bit for bit, one launch a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    cases = _chip_smoke().k1_edge_cases(torch, np.random.default_rng(2),
                                        cuda)
    assert len(cases) >= 16
    for name, live in cases:
        kernels.reset_launch_counts()
        got = search.stable_partition_order(live)
        assert kernels.LAUNCHES["K1"] == 1, name
        assert torch.equal(got, search.stable_partition_order_plain(live)), \
            name


# ------------------------------------ K10 append and K4 in one launch

K10_EDGES = ["app G's shape", "every live lane one bucket", "16 keys",
             "every lane dead", "B = 1", "B = C", "across the ring's end",
             "tags across 2^32", "one lane past a tile",
             "B = 131072 into C = 262144", "131072 lanes, one bucket"]
_EDGE_CACHE = {}


def _edges(kind, cuda):
    """chip_smoke.py's K10 append or K4 cases, built once a module."""
    if kind not in _EDGE_CACHE:
        cs = _chip_smoke()
        build = cs.k10_edge_cases if kind == "k10" else cs.k4_edge_cases
        _EDGE_CACHE[kind] = (cs, build(torch, np.random.default_rng(
            8 if kind == "k10" else 4), cuda))
    return _EDGE_CACHE[kind]


@pytest.mark.parametrize("name", K10_EDGES)
def test_k10_append_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-8 K10 append cases: the whole multimap state
    bit for bit against multimap_append_plain, one launch a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import join
    cs, cases = _edges("k10", cuda)
    assert sorted(cases) == sorted(K10_EDGES)
    kernels.reset_launch_counts()
    got = cs.run_k10_case(join, cases[name], plain=False)
    assert kernels.LAUNCHES["K10 append"] == 1
    for a, b in zip(got, cs.run_k10_case(join, cases[name], plain=True)):
        assert torch.equal(a, b)


def test_k10_append_multimaps_of_two_sizes_alternate_on_one_stream(cuda):
    """A 262,144-slot and a 100,000-slot multimap take turns on one
    stream, one-block and cooperative calls mixed: each call finds the
    workspace its predecessor left zero."""
    from siddhi_tpu_torch.ops import join
    cs, cases = _edges("k10", cuda)
    names = 3 * ["B = 131072 into C = 262144", "app G's shape",
                 "131072 lanes, one bucket", "B = C", "B = 1"]
    got = [cs.run_k10_case(join, cases[n], plain=False) for n in names]
    for n, g in zip(names, got):
        for a, b in zip(g, cs.run_k10_case(join, cases[n], plain=True)):
            assert torch.equal(a, b), n


K4_EDGES = ["steady state", "every lane new", "every lane one new key",
            "the pad key", "L = 1", "L = 2^20", "contended small table",
            "id-limit revert"]


@pytest.mark.parametrize("name", K4_EDGES)
def test_k4_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-2 K4 cases: table state, lane ids, resolved,
    count and misses bit for bit against key_lookup_or_insert_plain, one
    launch a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    cs, cases = _edges("k4", cuda)
    assert sorted(cases) == sorted(K4_EDGES)
    kernels.reset_launch_counts()
    got = cs.run_k4_case(groupby, cases[name], plain=False)
    assert kernels.LAUNCHES["K4"] == 1
    want = cs.run_k4_case(groupby, cases[name], plain=True)
    for f, a, b in zip(cs.K4_FIELDS, got, want):
        assert torch.equal(a, b), f
    table, keys, valid = cases[name]
    if name in ("contended small table", "id-limit revert"):
        # lanes left without a slot or an id: unresolved, counted as misses
        assert int(got[3]) > int(table.misses)
        assert int(got[2]) == table.keys.shape[0] // 2
    if name == "steady state":
        assert bool(got[5][valid].all()) and int(got[2]) == int(table.count)


def test_k4_small_table_right_after_a_large_one(cuda):
    """Tables of 2^21 and 128 slots take turns on one stream: each call
    finds the bitmap and flags its predecessor left zero."""
    from siddhi_tpu_torch.ops import groupby
    cs, cases = _edges("k4", cuda)
    names = 3 * ["L = 2^20", "contended small table", "every lane new",
                 "id-limit revert", "L = 1"]
    got = [cs.run_k4_case(groupby, cases[n], plain=False) for n in names]
    for n, g in zip(names, got):
        for f, a, b in zip(cs.K4_FIELDS, g,
                           cs.run_k4_case(groupby, cases[n], plain=True)):
            assert torch.equal(a, b), (n, f)


def test_k4_and_k10_append_wrappers_sort_nothing(cuda, monkeypatch):
    """The two wrappers launch their one kernel and nothing else that
    ranks: no torch.sort, no cumsum, no K1."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, join, search

    def refuse(*a, **kw):
        raise AssertionError("a sort or scan outside the kernel")

    cs, k10 = _edges("k10", cuda)
    _, k4 = _edges("k4", cuda)
    want10 = cs.run_k10_case(join, k10["app G's shape"], plain=True)
    want4 = cs.run_k4_case(groupby, k4["every lane new"], plain=True)
    for mod, name in ((torch, "sort"), (torch, "argsort"),
                      (torch, "cumsum"), (search, "stable_partition_order"),
                      (join, "stable_partition_order")):
        monkeypatch.setattr(mod, name, refuse)
    kernels.reset_launch_counts()
    got10 = cs.run_k10_case(join, k10["app G's shape"], plain=False)
    got4 = cs.run_k4_case(groupby, k4["every lane new"], plain=False)
    monkeypatch.undo()
    assert kernels.LAUNCHES["K10 append"] == 1 and kernels.LAUNCHES["K4"] == 1
    assert kernels.LAUNCHES["K1"] == 0
    for a, b in zip(got10, want10):
        assert torch.equal(a, b)
    for a, b in zip(got4, want4):
        assert torch.equal(a, b)


# ------------------------------------------- K13e's two routes, K12a's one launch

K13E_EQ_EDGES = ["float32 NaN ±0 ±inf", "float64 NaN ±0 ±inf",
                 "int64 differing above bit 32", "string codes",
                 "two columns", "four columns", "bool beside int32",
                 "repeats in the batch", "invalid lanes", "dead rows",
                 "B = 1", "no live row", "no lane valid",
                 "every row one key", "app AD's shape"]


def _k13e_eq_edges(cuda):
    return _chip_smoke().k13e_eq_edge_cases(
        torch, np.random.default_rng(20), cuda)


@pytest.mark.parametrize("name", K13E_EQ_EDGES)
def test_k13e_eq_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-24 equality cases: has, b_star and ev_matched
    bit for bit with last_match_plain of the full mask, one launch."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    cases = _k13e_eq_edges(cuda)
    assert sorted(cases) == sorted(K13E_EQ_EDGES)
    lane, row, lv, rv = cases[name]
    kernels.reset_launch_counts()
    got = tb.last_match_eq(lane, row, lv, rv)
    assert kernels.LAUNCHES["K13e eq"] == 1
    for g, w in zip(got, tb.last_match_eq_plain(lane, row, lv, rv)):
        assert torch.equal(g, w)
    if name in ("repeats in the batch", "app AD's shape"):
        assert bool(got[0].any()) and bool(got[2].any())


K13E_MASK_EDGES = ["[B, C] sparse", "[B, C] dense", "[B, C], C = 1000",
                   "[B, C] transposed view", "[B, C] one column in",
                   "[B, 1]", "[C] table-only", "host scalar true",
                   "card scalar false", "no lane valid vector",
                   "every lane invalid", "no live row", "B = 1", "C = 1"]


@pytest.mark.parametrize("name", K13E_MASK_EDGES)
def test_k13e_mask_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-24 mask cases: the condition read where it
    lies with the valid vectors folded in, bit for bit with the mask
    built and reduced by last_match_plain, one launch."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    cs = _chip_smoke()
    cases = cs.k13e_mask_edge_cases(torch, np.random.default_rng(21), cuda)
    assert sorted(cases) == sorted(K13E_MASK_EDGES)
    cond, lv, rv = cases[name]
    kernels.reset_launch_counts()
    got = tb.last_match(cond, lv, rv)
    assert kernels.LAUNCHES["K13e"] == 1
    for g, w in zip(got, tb.last_match_mask_plain(cond, lv, rv)):
        assert torch.equal(g, w)


def test_k13e_routes_and_sizes_alternate_on_one_stream(cuda):
    """Both routes at several sizes take turns on one stream: each call
    finds the shared workspace its predecessor left zero."""
    from siddhi_tpu_torch.core import table as tb
    cs = _chip_smoke()
    eq = _k13e_eq_edges(cuda)
    mask = cs.k13e_mask_edge_cases(torch, np.random.default_rng(22), cuda)
    for _ in range(3):
        for name in ("app AD's shape", "B = 1", "repeats in the batch"):
            lane, row, lv, rv = eq[name]
            for g, w in zip(tb.last_match_eq(lane, row, lv, rv),
                            tb.last_match_eq_plain(lane, row, lv, rv)):
                assert torch.equal(g, w), name
        for name in ("[B, C] dense", "[C] table-only", "C = 1"):
            cond, lv, rv = mask[name]
            for g, w in zip(tb.last_match(cond, lv, rv),
                            tb.last_match_mask_plain(cond, lv, rv)):
                assert torch.equal(g, w), name


def test_table_output_equality_route_builds_no_cross_mask(cuda):
    """App AD's update or insert on the card: the executor takes the
    equality route (one K13e eq launch, no K13e mask launch), its peak
    memory stays far below one [B, C] bool tensor, and its table and
    insert batch equal the mask route's bit for bit."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.core.event import EventBatch
    cs = _chip_smoke()
    rng = np.random.default_rng(23)
    rt = SiddhiManager().create_siddhi_app_runtime(
        cs.APP_AD, batch_size=cs.AD_BATCH)
    ex = rt.query_runtimes["txn"].table_executor
    assert ex.eq_plan is not None
    ids, amount, kind, _ = cs.ad_events(rng, rounds=1)
    items = cs._batches(rt, "Txn", {"id": ids, "amount": amount,
                                    "kind": kind},
                        1_000 + np.arange(ids.shape[0], dtype=np.int64),
                        cs.AD_BATCH)
    tbl = rt.tables["Account"]

    def selected(b):  # the query's output: select id, amount as balance
        return EventBatch(ts=b.ts, cols={"id": b.cols["id"],
                                         "balance": b.cols["amount"],
                                         "kind": b.cols["kind"]},
                          valid=b.valid, types=b.types)

    for b, _ in items[:4]:
        tbl.insert_batch(selected(b))  # these ids live in the table
    state = tbl.state
    out = selected(items[4][0])
    B, C = out.ts.shape[0], state.ts.shape[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got, gins = ex.run(state, out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["K13e eq"] == 1 and kernels.LAUNCHES["K13e"] == 0
    assert torch.cuda.max_memory_allocated() - base < B * C // 8
    plan, ex.eq_plan = ex.eq_plan, None
    try:
        want, wins = ex.run(state, out)
    finally:
        ex.eq_plan = plan
    assert kernels.LAUNCHES["K13e"] == 1
    for k in want.cols:
        assert torch.equal(got.cols[k], want.cols[k]), k
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(gins.valid, wins.valid)
    assert bool((~gins.valid & out.valid).any())  # some events matched


K12A_EDGES = ["B = 0", "B = 1", "B = 256", "B = 1,025", "B = 131,072",
              "B = 1048576", "every lane invalid", "over", "span 2^32 - 1",
              "strided columns"]


def _k12a_edges(cuda):
    return _chip_smoke().k12a_edge_cases(
        torch, np.random.default_rng(14), cuda)


@pytest.mark.parametrize("name", K12A_EDGES)
def test_k12a_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-14 pack cases, bit for bit with
    wire_pack_plain, one launch a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import wire
    cs = _chip_smoke()
    cases = _k12a_edges(cuda)
    assert sorted(cases) == sorted(K12A_EDGES)
    kernels.reset_launch_counts()
    cs.check_k12a(wire, name, *cases[name])
    assert kernels.LAUNCHES["K12a"] == 1


def test_k12a_sizes_alternate_on_one_stream(cuda):
    """Packs of one block, of many blocks and of none take turns on one
    stream (the workspace shared), each bit for bit."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import wire
    cs = _chip_smoke()
    cases = _k12a_edges(cuda)
    order = 3 * ["B = 1048576", "B = 256", "over", "B = 0",
                 "strided columns", "B = 131,072"]
    kernels.reset_launch_counts()
    for name in order:
        cs.check_k12a(wire, name, *cases[name])
    assert kernels.LAUNCHES["K12a"] == len(order)


# ------------------------------------------ K4b and partitions (phase 34)

K4B_EDGES = ["app AJ's first batch", "app AJ's steady state",
             "L = 131072, K = 64", "L = 131072, K = 4096", "L = 1",
             "no valid lane", "every key new", "every key found",
             "INT64_MAX and INT64_MIN", "heavy repeats", "count + n_new > K",
             "eviction", "n_new past K"]


def _k4b_edges(cuda):
    if "k4b" not in _EDGE_CACHE:
        cs = _chip_smoke()
        _EDGE_CACHE["k4b"] = (cs, cs.k4b_edge_cases(
            torch, np.random.default_rng([0, 34]), cuda))
    return _EDGE_CACHE["k4b"]


@pytest.mark.parametrize("name", K4B_EDGES)
def test_k4b_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-34 cases: ids, sorted_keys, sorted_ids and
    count bit for bit against dense_key_lookup_or_insert_plain, one launch
    a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    cs, cases = _k4b_edges(cuda)
    assert sorted(cases) == sorted(K4B_EDGES)
    kernels.reset_launch_counts()
    got = cs.run_k4b_case(groupby, cases[name], plain=False)
    assert kernels.LAUNCHES["K4b"] == 1
    for f, a, b in zip(cs.K4B_FIELDS, got,
                       cs.run_k4b_case(groupby, cases[name], plain=True)):
        assert torch.equal(a, b), f


def test_k4b_sizes_alternate_on_one_stream(cuda):
    """Selections, one-block sorts and single lanes take turns on one
    stream: each call finds the workspace its predecessor left zero."""
    from siddhi_tpu_torch.ops import groupby
    cs, cases = _k4b_edges(cuda)
    names = 3 * ["L = 131072, K = 4096", "L = 1", "every key new",
                 "no valid lane", "n_new past K", "heavy repeats"]
    got = [cs.run_k4b_case(groupby, cases[n], plain=False) for n in names]
    for n, g in zip(names, got):
        for f, a, b in zip(cs.K4B_FIELDS, g,
                           cs.run_k4b_case(groupby, cases[n], plain=True)):
            assert torch.equal(a, b), (n, f)


PARTITION_APPS = {
    "range": ("define stream S (symbol string, price float, volume long);\n"
              "partition with (price < 30.0 as 'low' or price >= 30.0 and "
              "price < 80.0 as 'mid' of S) begin\n"
              "@info(name='q') from S#window.length(5) select symbol, "
              "sum(volume) as v, count() as n insert into Out;\nend;", None),
    "#inner": ("define stream S (symbol string, price float, volume long);\n"
               "partition with (symbol of S) begin\n"
               "from S select symbol, price, count() as n insert into #Acc;\n"
               "@info(name='q') from #Acc[n % 3 == 0]#window.lengthBatch(2) "
               "select symbol, sum(price) as total insert into Out;\nend;",
               None),
    "@purge": ("@app:playback\n"
               "define stream S (symbol string, price float, volume long);\n"
               "@purge(idle.period='50 milliseconds')\n"
               "partition with (symbol of S) begin\n"
               "@info(name='q') from S#window.time(100 milliseconds) "
               "select symbol, sum(volume) as v, count() as n "
               "insert into Out;\nend;", 60),
    "key slots": ("define stream S (symbol string, price float, "
                  "volume long);\n"
                  "partition with (symbol of S) begin\n"
                  "@info(name='q') from S[70.0 > price]#window.length(10) "
                  "select symbol, sum(price) as total, count() as n "
                  "insert into Out;\nend;", None),
}


@pytest.mark.parametrize("name", list(PARTITION_APPS))
def test_partition_app_on_card_matches_cpu(cuda, name):
    """A range partition, an `#inner` stream, `@purge` with time windows
    and the key-slot path (mesh=[device], K4b) on the card against the
    same app on the CPU, event for event; the key-slot path launches K4b
    and K3 once a batch."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    app, hb_every = PARTITION_APPS[name]
    rng = np.random.default_rng(35)
    n, rounds = 400, 4
    rows = [(f"S{int(k)}", float(p), int(v)) for k, p, v in zip(
        rng.integers(0, 40, n * rounds),
        rng.integers(0, 100, n * rounds).astype(np.float32),
        rng.integers(1, 9, n * rounds))]
    outs = []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=128,
            mesh=[dev] if name == "key slots" else None,
            partition_capacity=64)
        got = []
        rt.add_callback("Out", lambda evs, g=got: g.extend(
            (e.timestamp, e.data, e.is_expired) for e in evs))
        h = rt.get_input_handler("S")
        kernels.reset_launch_counts()
        for r in range(rounds):
            for i in range(n):
                h.send(rows[r * n + i], timestamp=1_000 + r * n + i)
            rt.flush()
            if hb_every:
                rt.heartbeat(1_000 + (r + 1) * n + hb_every)
        if dev == "cuda" and name == "key slots":
            # 400 rows a round in batches of 128: 4 batches a round
            assert kernels.LAUNCHES["K4b"] == 4 * rounds
            assert kernels.LAUNCHES["K3 partition"] == 4 * rounds
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) > 0
    for (t0, d0, x0), (t1, d1, x1) in zip(*outs):
        assert (t0, x0, len(d0)) == (t1, x1, len(d1))
        for a, b in zip(d0, d1):
            # float32 sums in another order: rtol 1e-5
            assert (a == pytest.approx(b, rel=1e-5) if isinstance(b, float)
                    else a == b), (d0, d1)


# --------------------- K11b's insert and K10's fused probe in one launch

K11B_EDGES = ["app I's shape", "no free slot",
              "more candidates than free slots", "W = 0",
              "P not a multiple of the block", "more than 32 column jobs",
              "an empty table", "one block"]
K10_PROBE_EDGES = ["app G's shape", "pair_cap overflow",
                   "every lane invalid", "one hot key past k_max",
                   "tags across 2^32", "k_max = 1", "B = 1",
                   "B = 1000, a partial tile",
                   "B = 300000, tiles past the card"]
_ONE_LAUNCH_CACHE = {}


def _one_launch_edges(kind, cuda):
    """chip_smoke.py's K11b or fused K10 probe cases at smaller sizes,
    built once a module."""
    if kind not in _ONE_LAUNCH_CACHE:
        cs = _chip_smoke()
        if kind == "k11b":
            cases = cs.k11b_edge_cases(torch, np.random.default_rng(10),
                                       cuda, W=4096, P=16_384)
        else:
            cases = cs.k10_probe_edge_cases(torch, np.random.default_rng(8),
                                            cuda, B=2048, C=20_000,
                                            cap=8192)
        _ONE_LAUNCH_CACHE[kind] = (cs, cases)
    return _ONE_LAUNCH_CACHE[kind]


def _assert_k11b_case(cs, case, name):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import pattern
    kernels.reset_launch_counts()
    got, gdrop = cs.run_k11b_case(pattern, case, plain=False)
    W = case[1][-2].shape[0]
    assert kernels.LAUNCHES["K11b"] == (
        -(-cs.k11b_jobs(case) // 32) if W else 0), name
    assert kernels.LAUNCHES["K1"] == 0, name
    want, wdrop = cs.run_k11b_case(pattern, case, plain=True)
    assert torch.equal(gdrop, wdrop), name
    for (n, a), (_, b) in zip(cs._pending_tensors(got),
                              cs._pending_tensors(want)):
        assert torch.equal(a, b), (name, n)
    ws = kernels.workspace("k11_pattern", 0, a.device)
    assert int(ws.count_nonzero()) == 0, name


@pytest.mark.parametrize("name", K11B_EDGES)
def test_k11b_edges_match_plain(cuda, name):
    """chip_smoke.py's K11b edges: the whole table and n_drop bit for bit,
    ceil(jobs / 32) launches a call and no K1, the workspace left zero."""
    cs, cases = _one_launch_edges("k11b", cuda)
    assert sorted(cases) == sorted(K11B_EDGES)
    _assert_k11b_case(cs, cases[name], name)


def test_k11b_tables_of_two_sizes_alternate_on_one_stream(cuda):
    """Tables of 16,384, 5,001 and 1,000 slots take turns on one stream:
    each call finds the workspace its predecessor left zero."""
    cs, cases = _one_launch_edges("k11b", cuda)
    for name in 3 * ["app I's shape", "P not a multiple of the block",
                     "more than 32 column jobs", "one block",
                     "no free slot"]:
        _assert_k11b_case(cs, cases[name], name)


@pytest.mark.parametrize("name", K10_PROBE_EDGES)
def test_k10_probe_compact_edges_match_plain(cuda, name):
    """chip_smoke.py's fused K10 probe edges: lanes, rows, pv, the pairs
    past pair_cap and the truncated lanes bit for bit against
    multimap_probe_plain and compact_pairs_plain, one launch a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import join
    cs, cases = _one_launch_edges("k10", cuda)
    assert sorted(cases) == sorted(K10_PROBE_EDGES)
    for _ in range(2):  # the second call finds the workspace zero
        kernels.reset_launch_counts()
        got = cs.run_k10_probe_case(join, cases[name], plain=False)
        assert cs.probe_launches(kernels) == (1, 0, 0)
        for part, a, b in zip(cs.PROBE_COMPACT_PARTS, got,
                              cs.run_k10_probe_case(join, cases[name],
                                                    plain=True)):
            assert torch.equal(a, b), (name, part)
    ws = kernels.workspace("k10_join", 0, cuda)
    assert int(ws.count_nonzero()) == 0


def test_join_step_compacts_in_its_probe_launch(cuda):
    """A multimap join whose step compacts (batch 4,096, k_max 16: pair_cap
    32,768 < 65,536) runs the fused probe and no compact_pairs, and
    matches the CPU run."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    app = """
    define stream L (k int, v double);
    define stream R (k int, v double);
    @info(name = 'bench')
    from L#window.length(20000) as a join R#window.length(20000) as b
    on a.k == b.k
    select a.k as k, a.v as lv, b.v as rv
    insert into OutStream;
    """
    rng = np.random.default_rng(22)
    feeds = [(sid, {"k": rng.integers(0, 3000, 4096).astype(np.int32),
                    "v": rng.uniform(1, 100, 4096)})
             for _ in range(4) for sid in ("L", "R")]
    outs, launches = [], []
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app, batch_size=4096)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data) for e in evs))
        for i, (sid, cols) in enumerate(feeds):
            rt.get_input_handler(sid).send_columns(
                cols, timestamps=np.arange(4096) + 4096 * i)
            rt.flush()
        outs.append(got)
        launches.append(dict(kernels.LAUNCHES))
    assert outs[0] == outs[1] and len(outs[0]) > 4096
    assert launches[0]["K10 probe compact"] == 8
    assert launches[0]["K10 probe"] == 0
    assert launches[0]["K10 compact"] == 0


# ------------------------- the K7 merge, K6 and K7's bounded argsort

MERGE_SHAPES = ["app D's shape", "app C's shape", "app A's shape",
                "app A's shape, expired output"]
MERGE_EDGES = ["ties across three groups", "every lane invalid",
               "every lane valid, one key", "first group empty",
               "a middle group empty", "lengths 1", "one valid lane a group",
               "the one-block limit", "one past the one-block limit",
               "four groups", "int64 hi, negative lo",
               "int64 lo above 32 bits", "more tiles than the grid",
               *(f"lengths 1-300 #{i}" for i in range(6))]
SEARCH_EDGES = [f"{k}, {side}" for k in (
    "N = 0", "N = 1", "empty v", "v of two dimensions", "every key equal",
    "float32 NaN, -0.0, inf", "float64 NaN, -0.0, inf", "int64 extremes",
    "bool", "unsorted a", "int32 a, int64 v", "N = 2^20 + 1")
    for side in ("left", "right")]
BOUNDED_EDGES = ["L = 1", "the one-block limit", "one past it",
                 "every lane invalid", "bound 0", "keys at 0 and the bound",
                 "app D's chunk"]
_MERGE_SEARCH_CACHE = {}


def _merge_search_cases(kind, cuda):
    """chip_smoke.py's phase-6 and phase-36 cases of one kind, built once
    a module."""
    if kind not in _MERGE_SEARCH_CACHE:
        cs = _chip_smoke()
        build = {"shapes": cs.merge_shapes, "merge": cs.merge_edge_cases,
                 "search": cs.search_edge_cases,
                 "search shapes": cs.search_shapes,
                 "bounded": cs.bounded_sort_cases}[kind]
        _MERGE_SEARCH_CACHE[kind] = build(torch, np.random.default_rng(36),
                                          cuda)
    return _MERGE_SEARCH_CACHE[kind]


def _assert_merge_case(keys, valids, name):
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import windows as w
    total = sum(int(k[0].numel()) for k in keys)
    kernels.reset_launch_counts()
    got = w._merge_order(keys, valids)
    assert kernels.LAUNCHES["K7 merge"] == (1 if total else 0), name
    assert kernels.LAUNCHES["K1"] == 0, name
    want = w._merge_order_plain(keys, valids)
    assert got.dtype == want.dtype == torch.int32, name
    assert torch.equal(got, want), name


@pytest.mark.parametrize("name", MERGE_SHAPES)
def test_k7_merge_main_path_shapes_match_plain(cuda, name):
    """The K7 merge at apps D's, C's and A's steps: the order bit for bit
    against _merge_order_plain (plain K1 and K6), one launch, no K1."""
    cases = _merge_search_cases("shapes", cuda)
    assert sorted(cases) == sorted(MERGE_SHAPES)
    _assert_merge_case(*cases[name], name)


@pytest.mark.parametrize("name", MERGE_EDGES)
def test_k7_merge_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-36 merge edges: bit for bit, one launch a
    call (none without a lane), the workspace left zero."""
    from siddhi_tpu_torch import kernels
    cases = _merge_search_cases("merge", cuda)
    assert sorted(cases) == sorted(MERGE_EDGES)
    _assert_merge_case(*cases[name], name)
    ws = kernels.workspace("k7_merge", 0, cuda)
    assert int(ws.count_nonzero()) == 0


def test_k7_merge_sizes_alternate_on_one_stream(cuda):
    """Cooperative and one-block merges of several sizes take turns on one
    stream: each call finds the workspace its predecessor left zero."""
    cases = _merge_search_cases("merge", cuda)
    for name in 3 * ["more tiles than the grid", "lengths 1",
                     "one past the one-block limit", "four groups",
                     "every lane invalid"]:
        _assert_merge_case(*cases[name], name)


@pytest.mark.parametrize("name", SEARCH_EDGES)
def test_k6_edges_match_plain(cuda, name):
    """chip_smoke.py's phase-36 K6 edges at both sides: bit for bit
    against searchsorted32_plain (the JAX walk), one launch a call (none
    for an empty v), shaped like v."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    cases = _merge_search_cases("search", cuda)
    assert sorted(cases) == sorted(SEARCH_EDGES)
    a, v, side = cases[name]
    kernels.reset_launch_counts()
    got = search.searchsorted32(a, v, side)
    assert kernels.LAUNCHES["K6"] == (1 if v.numel() else 0)
    want = search.searchsorted32_plain(a, v, side)
    assert got.shape == v.shape and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_k6_main_path_shapes_match_plain(cuda):
    """K6 at app C's expiry trigger and app M's bucket trigger."""
    from siddhi_tpu_torch.ops import search
    for name, (a, v, side) in _merge_search_cases("search shapes",
                                                 cuda).items():
        assert torch.equal(search.searchsorted32(a, v, side),
                           search.searchsorted32_plain(a, v, side)), name


@pytest.mark.parametrize("name", BOUNDED_EDGES)
def test_stable_argsort_bounded_edges_match_plain(cuda, name):
    """stable_argsort_bounded on the card is K7 (one launch, int32) and
    equals the plain stable sort."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    cases = _merge_search_cases("bounded", cuda)
    assert sorted(cases) == sorted(BOUNDED_EDGES)
    k, bound = cases[name]
    kernels.reset_launch_counts()
    got = search.stable_argsort_bounded(k, bound)
    assert kernels.LAUNCHES["K7 bounded"] == 1
    assert torch.equal(got, search.stable_radix_argsort_plain(k, bound))


def test_k5_and_k5b_sort_on_k7_not_torch(cuda, monkeypatch):
    """The grouped K5 and K5b calls sort their slots with one K7 launch
    each (no torch.sort) and still match their plain versions."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    rng = np.random.default_rng(23)
    L, K = 20_000, 4096
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(cuda)
    resets = torch.zeros(L, dtype=torch.bool, device=cuda)
    cur = torch.zeros((), dtype=torch.int32, device=cuda)
    d = torch.from_numpy(rng.integers(-9, 9, L)).to(cuda)
    pv, pe, po = groupby.grouped_scan_fused_plain(
        [torch.zeros(K, dtype=torch.int64, device=cuda)],
        torch.zeros(K, dtype=torch.int32, device=cuda), slots, [d], valid,
        resets, cur)
    ps, pso = groupby.grouped_scan_plain(
        groupby.init_group_state(K, torch.int64, cuda), slots, d, valid,
        resets, cur, "max")

    def refuse(*a, **kw):
        raise AssertionError("torch.sort on the card's K5 path")

    monkeypatch.setattr(torch, "sort", refuse)
    kernels.reset_launch_counts()
    kv, ke, ko = groupby.grouped_scan_fused(
        [torch.zeros(K, dtype=torch.int64, device=cuda)],
        torch.zeros(K, dtype=torch.int32, device=cuda), slots, [d], valid,
        resets, cur)
    ks, kso = groupby.grouped_scan(
        groupby.init_group_state(K, torch.int64, cuda), slots, d, valid,
        resets, cur, "max")
    assert {c: kernels.LAUNCHES[c] for c in ("K7 K5 sort", "K5",
                                              "K7 K5b sort", "K5b grouped")
            } == {"K7 K5 sort": 1, "K5": 1, "K7 K5b sort": 1,
                  "K5b grouped": 1}
    assert torch.equal(kv[0], pv[0]) and torch.equal(ko[0], po[0])
    assert torch.equal(ke, pe)
    assert torch.equal(ks.values, ps.values) and torch.equal(kso, pso)


STEP_APPS = {
    "sliding time": ("""
        @app:playback
        define stream S (sym string, price double);
        @info(name = 'q')
        from S#window.time(1 sec)
        select sym, sum(price) as total
        group by sym
        insert all events into OutStream;
        """, {"K7 merge": 1, "K6": 1, "K7 K5 sort": 1}),
    "batch": ("""
        define stream S (sym string, price double);
        @info(name = 'q')
        from S#window.lengthBatch(700)
        select sym, sum(price) as total
        group by sym
        insert into OutStream;
        """, {"K7 merge": 1, "K6": 0, "K7 K5 sort": 1}),
}


@pytest.mark.parametrize("name", sorted(STEP_APPS))
def test_window_steps_launch_the_merge_and_search(cuda, name):
    """A sliding time window's step and a lengthBatch step each launch the
    K7 merge once (no K1 inside it), the time window K6 once, the grouped
    sum one K7 sort; outputs equal the CPU run's."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    text, per_step = STEP_APPS[name]
    rng = np.random.default_rng(5)
    feeds = [({"sym": np.array([f"S{i}" for i in rng.integers(0, 40, 2048)],
                               dtype=object),
               "price": rng.uniform(1, 100, 2048)},
              np.arange(2048) + 2048 * r) for r in range(4)]
    outs, counts = [], []
    for dev in ("cuda", "cpu"):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            text, batch_size=2048)
        got = []
        rt.add_callback("OutStream", lambda evs, g=got: g.extend(
            (e.timestamp, e.data, e.is_expired) for e in evs))
        kernels.reset_launch_counts()
        for cols, ts in feeds:
            rt.get_input_handler("S").send_columns(cols, timestamps=ts)
            rt.flush()
        counts.append({k: kernels.LAUNCHES[k] for k in per_step})
        outs.append(got)
        rt.shutdown()
    assert counts[0] == {k: v * len(feeds) for k, v in per_step.items()}
    assert len(outs[0]) == len(outs[1]) and len(outs[0]) > 0
    for (ta, da, ea), (tb, db, eb) in zip(*outs):
        assert (ta, da[0], ea) == (tb, db[0], eb)
        assert da[1] == pytest.approx(db[1], rel=1e-5)
