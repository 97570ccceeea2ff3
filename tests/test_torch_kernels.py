"""The port's kernel modules against the JAX functions they replace, on the
CPU (the plain PyTorch version of each kernel; the CUDA kernels themselves
are held against these plain versions in tests/test_torch_gpu.py and
chip_smoke.py).

Inputs are made with numpy from a seed and handed to both sides. Integer
results and table state must be bit-exact. Float results are compared at
rtol 1e-5: the port's segmented scan adds in another order than XLA's
associative_scan tree (tests/test_numeric_parity.py policy for float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.ops import groupby as jgb
from siddhi_tpu.ops import search as jsearch
from siddhi_tpu.ops import windows as jwin
from siddhi_tpu_torch.ops import groupby as tgb
from siddhi_tpu_torch.ops import search as tsearch

FLOAT_RTOL = 1e-5

# jitted references: one compile per shape instead of eager per-op dispatch
_j_lookup = jax.jit(jgb.key_lookup_or_insert)
_j_grouped = jax.jit(jgb.grouped_scan_fused)
_j_ungrouped = jax.jit(jgb.ungrouped_scan_fused)
_j_merge_order = jax.jit(jwin._merge_order)
_j_search = jax.jit(jsearch.searchsorted32, static_argnames="side")


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------- K1


@pytest.mark.parametrize("n,p", [(1, 0.5), (37, 0.0), (64, 1.0), (1000, 0.3),
                                 (4099, 0.7)])
def test_k1_stable_partition_order_matches_jax(n, p):
    live = np.random.default_rng(n).random(n) < p
    want = _np(jsearch.stable_partition_order(jnp.asarray(live)))
    got = tsearch.stable_partition_order(torch.from_numpy(live))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _search_case(case, rng):
    """(a, v) numpy inputs of one searchsorted32 case."""
    if case == "int32 keys":
        return (np.sort(rng.integers(-50, 50, 200)).astype(np.int32),
                rng.integers(-55, 55, 77).astype(np.int32))
    if case == "int64 keys":
        return (np.sort(rng.integers(-2**40, 2**40, 300)),
                rng.integers(-2**40, 2**40, 100))
    if case in ("float32 column", "float64 column"):
        dt = np.float32 if case == "float32 column" else np.float64
        a = rng.normal(0, 10, 250).astype(dt)
        a[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -0.0]
        v = np.concatenate([a[:6], rng.normal(0, 10, 40).astype(dt)])
        return np.sort(a, kind="stable"), v  # NaN last, as the index
    if case == "N = 0":
        return np.zeros(0, np.int64), rng.integers(-3, 3, 9)
    if case == "duplicates":
        return (np.repeat(np.arange(0, 20, 2), 30).astype(np.int64),
                rng.integers(-1, 21, 60))
    if case == "unsorted a":  # the walk's answer, not a count
        return (rng.integers(-20, 20, 150), rng.integers(-25, 25, 60))
    if case == "v of two dimensions":
        return (np.sort(rng.integers(0, 100, 200)).astype(np.int32),
                rng.integers(-5, 105, (7, 11)).astype(np.int32))
    raise AssertionError(case)


SEARCH_CASES = ["int32 keys", "int64 keys", "float32 column",
                "float64 column", "N = 0", "duplicates",
                "v of two dimensions", "unsorted a"]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("case", SEARCH_CASES + ["bounded argsort",
                                                 "bounded argsort, wide"])
def test_search_helpers_match_jax(case, side):
    """The plain K6 walk and the bounded argsort against the JAX functions:
    int32 and int64 keys, float columns with NaN, +-0.0 and +-inf, N = 0,
    duplicates, a two-dimensional v, an unsorted a, both sides; the
    argsort with and
    without its bound, narrow and past the JAX package's packed-sort
    width."""
    rng = np.random.default_rng(SEARCH_CASES.index(case)
                                if case in SEARCH_CASES else 3)
    if case.startswith("bounded argsort"):
        n = 9000 if case.endswith("wide") else 300
        x = rng.integers(0, 50, n).astype(np.int32)
        got = tsearch.stable_argsort_bounded(
            torch.from_numpy(x), 49 if side == "left" else None)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), _np(jsearch.stable_argsort_bounded(jnp.asarray(x))))
        return
    a, v = _search_case(case, rng)
    got = tsearch.searchsorted32(torch.from_numpy(a), torch.from_numpy(v),
                                 side)
    want = _np(_j_search(jnp.asarray(a), jnp.asarray(v), side=side))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_searchsorted32_follows_jax_where_torch_differs():
    """A NaN query and a NaN inside `a` take the JAX walk's answer (every
    compare with NaN false), not torch.searchsorted's (NaN as largest)."""
    a = np.array([1.0, np.nan])
    v = np.array([np.nan, -0.0, 1.0, 5.0])
    for side in ("left", "right"):
        got = tsearch.searchsorted32(torch.from_numpy(a), torch.from_numpy(v),
                                     side).numpy()
        want = _np(_j_search(jnp.asarray(a), jnp.asarray(v), side=side))
        np.testing.assert_array_equal(got, want)
        torch_pos = torch.searchsorted(torch.from_numpy(a),
                                       torch.from_numpy(v),
                                       right=side == "right").numpy()
        assert (got != torch_pos).any()
    assert got[0] == 0  # the NaN query lands at 0


# ------------------------------------------------------------ K7 merge


def _merge_group(rng, n, p, hi=(0, 6), lo=(0, 3), hi_dt=np.int32):
    """(hi, lo, valid) of one lane group, its packed keys nondecreasing as
    a window's groups hold them (lo's low word zero-extended)."""
    h = rng.integers(hi[0], hi[1], n).astype(hi_dt)
    lw = rng.integers(lo[0], lo[1], n).astype(np.int32)
    packed = (h.astype(np.int64) << 32) | (lw.astype(np.int64) & 0xFFFFFFFF)
    order = np.argsort(packed, kind="stable")
    return h[order], lw[order], rng.random(n) < p


MERGE_CASES = {
    "three groups, ties across them": [(120, 0.7), (77, 0.9), (5, 1.0)],
    "every lane invalid": [(50, 0.0), (80, 0.0)],
    "one group empty": [(0, 0.5), (200, 0.6)],
    "a middle group empty": [(150, 0.5), (0, 0.5), (40, 1.0)],
    "lengths 1": [(1, 1.0), (1, 1.0)],
    "lengths 1-300": "random",
    "int64 hi, negative lo": "wide",
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_order_plain_matches_jax(case):
    """_merge_order_plain (plain K1 and K6) against the JAX _merge_order:
    the same int32 permutation, ties across groups in concatenation
    order, invalid lanes after every valid one."""
    from siddhi_tpu_torch.ops import windows as twin
    rng = np.random.default_rng(list(MERGE_CASES).index(case))
    spec = MERGE_CASES[case]
    if spec == "random":
        groups = [_merge_group(rng, int(n), rng.random())
                  for n in rng.integers(1, 301, 2)]
    elif spec == "wide":
        wide = dict(hi=(-2**30, 2**30), lo=(-2**31, 2**31))
        groups = [_merge_group(rng, 400, 0.6, hi_dt=np.int64, **wide),
                  _merge_group(rng, 300, 0.7, **wide)]
    else:
        groups = [_merge_group(rng, n, p) for n, p in spec]
    got = twin._merge_order_plain(
        [(torch.from_numpy(h), torch.from_numpy(lw)) for h, lw, _ in groups],
        [torch.from_numpy(v) for _, _, v in groups])
    want = _np(_j_merge_order(
        [(jnp.asarray(h), jnp.asarray(lw)) for h, lw, _ in groups],
        [jnp.asarray(v) for _, _, v in groups]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------- K3


def test_k3_hash_columns_bit_exact():
    rng = np.random.default_rng(7)
    n = 513
    cols = [
        rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        rng.normal(0, 1e6, n).astype(np.float32),
        rng.normal(0, 1e6, n).astype(np.float64),
        rng.random(n) < 0.5,
    ]
    cols[2][:3] = [-0.0, 0.0, np.inf]
    for k in range(1, len(cols) + 1):
        want = _np(jgb.hash_columns([jnp.asarray(c) for c in cols[:k]]))
        got = tgb.hash_columns([torch.from_numpy(c) for c in cols[:k]])
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------- K4


def _k4_both(K, batches):
    """Run the same key batches through both tables; assert equal state
    and lane results after every batch."""
    jt = jgb.init_key_table(K)
    tt = tgb.init_key_table(K, "cpu")
    for keys, valid in batches:
        jt, jids, jres = _j_lookup(
            jt, jnp.asarray(keys), jnp.asarray(valid))
        tt, tids, tres = tgb.key_lookup_or_insert(
            tt, torch.from_numpy(keys), torch.from_numpy(valid))
        np.testing.assert_array_equal(tt.keys.numpy(), _np(jt.keys))
        np.testing.assert_array_equal(tt.ids.numpy(), _np(jt.ids))
        assert int(tt.count) == int(jt.count)
        assert int(tt.misses) == int(jt.misses)
        np.testing.assert_array_equal(tids.numpy(), _np(jids))
        np.testing.assert_array_equal(tres.numpy(), _np(jres))
    return tt


def _keys(rng, n, distinct):
    pool = rng.integers(-(2**62), 2**62, distinct, dtype=np.int64)
    return pool, pool[rng.integers(0, distinct, n)]


def test_k4_all_new_then_all_present():
    rng = np.random.default_rng(11)
    pool = rng.permutation(
        rng.integers(-(2**62), 2**62, 48, dtype=np.int64))
    valid = np.ones(48, bool)
    valid[::7] = False
    tt = _k4_both(64, [(pool, valid), (pool, np.ones(48, bool))])
    assert int(tt.count) == 48 and int(tt.misses) == 0


def test_k4_duplicates_within_one_batch():
    rng = np.random.default_rng(12)
    _, keys = _keys(rng, 96, 20)
    keys[:4] = np.iinfo(np.int64).max  # the pad value itself is a real key
    _k4_both(32, [(keys, rng.random(96) < 0.9), (keys[::-1].copy(),
                                                  np.ones(96, bool))])


def test_k4_id_space_overflow_counts_misses():
    rng = np.random.default_rng(13)
    _, keys = _keys(rng, 120, 70)
    tt = _k4_both(16, [(keys[:60], np.ones(60, bool)),
                       (keys[60:], np.ones(60, bool))])
    assert int(tt.count) == 16 and int(tt.misses) > 0


def test_k4_contended_small_table():
    # many keys into few slots: claim races and exhausted probe windows
    rng = np.random.default_rng(14)
    batches = []
    for _ in range(4):
        _, keys = _keys(rng, 64, 40)
        batches.append((keys, rng.random(64) < 0.8))
    _k4_both(24, batches)


def test_k4_every_lane_one_new_key_behind_invalid_lanes():
    # one unseen key on every lane, the first lanes invalid: the valid
    # lanes claim one slot together and all win it
    rng = np.random.default_rng(15)
    pool, _ = _keys(rng, 1, 30)
    keys = np.full(80, rng.integers(-(2**62), 2**62, dtype=np.int64))
    valid = rng.random(80) < 0.9
    valid[:20] = False
    tt = _k4_both(32, [(pool, np.ones(30, bool)), (keys, valid)])
    assert int(tt.count) == 31 and int(tt.misses) == 0


# --------------------------------------------------------------------- K5


def _k5_inputs(rng, L, K, n_reset):
    slots = rng.integers(0, K, L).astype(np.int32)
    slots[: L // 8] = rng.integers(0, 3, L // 8)  # long runs of a few keys
    valid = rng.random(L) < 0.85
    resets = np.zeros(L, bool)
    resets[rng.choice(L, n_reset, replace=False)] = True
    valid &= ~resets
    return slots, valid, resets


@pytest.mark.parametrize("L,K,n_reset", [(200, 16, 0), (333, 64, 3),
                                         (1024, 8, 5)])
def test_k5_grouped_scan_fused_matches_jax(L, K, n_reset):
    rng = np.random.default_rng(L)
    slots, valid, resets = _k5_inputs(rng, L, K, n_reset)
    f32 = rng.uniform(-100, 100, L).astype(np.float32)
    i64 = rng.integers(-1000, 1000, L).astype(np.int64)
    vals = [rng.uniform(0, 50, K).astype(np.float32),
            rng.integers(0, 99, K).astype(np.int64)]
    shared = rng.integers(0, 4, K).astype(np.int32)
    epoch = np.int32(2)
    jv, je, jo = _j_grouped(
        [jnp.asarray(v) for v in vals], jnp.asarray(shared),
        jnp.asarray(slots), [jnp.asarray(f32), jnp.asarray(i64)],
        jnp.asarray(valid), jnp.asarray(resets), jnp.asarray(epoch))
    t = torch.from_numpy
    tv, te, to = tgb.grouped_scan_fused(
        [t(v.copy()) for v in vals], t(shared.copy()), t(slots),
        [t(f32), t(i64)], t(valid), t(resets), torch.tensor(epoch))
    np.testing.assert_array_equal(te.numpy(), _np(je))
    np.testing.assert_array_equal(tv[1].numpy(), _np(jv[1]))  # int64 exact
    np.testing.assert_array_equal(to[1].numpy(), _np(jo[1]))
    np.testing.assert_allclose(tv[0].numpy(), _np(jv[0]), rtol=FLOAT_RTOL,
                               atol=1e-3)
    np.testing.assert_allclose(to[0].numpy(), _np(jo[0]), rtol=FLOAT_RTOL,
                               atol=1e-3)


def test_ungrouped_scan_fused_matches_jax():
    rng = np.random.default_rng(21)
    L = 300
    _, valid, resets = _k5_inputs(rng, L, 4, 2)
    d = rng.integers(-9, 9, L).astype(np.int64)
    jv, je, jo = _j_ungrouped(
        [jnp.asarray(np.array([5], np.int64))], jnp.asarray(np.array([1], np.int32)),
        [jnp.asarray(d)], jnp.asarray(valid), jnp.asarray(resets),
        jnp.asarray(np.int32(1)))
    tv, te, to = tgb.ungrouped_scan_fused(
        [torch.tensor([5])], torch.tensor([1], dtype=torch.int32),
        [torch.from_numpy(d)], torch.from_numpy(valid),
        torch.from_numpy(resets), torch.tensor(1, dtype=torch.int32))
    np.testing.assert_array_equal(tv[0].numpy(), _np(jv[0]))
    np.testing.assert_array_equal(te.numpy(), _np(je))
    np.testing.assert_array_equal(to[0].numpy(), _np(jo[0]))
