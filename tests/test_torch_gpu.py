"""Card-only tests: each CUDA kernel against its plain PyTorch version, and
the public API on the card against the CPU. Skipped without a card. On a
machine with one (and no JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

This file imports neither jax nor siddhi_tpu."""

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
