"""K13e's two routes on the CPU: the equality route's plain version
against the full [B, C] mask (built with numpy's `==`) reduced by
`last_match_plain` and by the JAX reductions of
`TableOutputExecutor._make`, on chip_smoke.py's phase-24 cases at a small
size (NaN, ±0.0 and ±inf in float32 and float64 keys, int64 keys differing
only above bit 32, string codes, composite keys, repeated keys, invalid
lanes, dead rows, B = 1, no live row); the mask route's plain version (a
[B, C], [B, 1], [C] or scalar condition with the valid vectors) against
the JAX reductions; which ON conditions take the equality route; and the
executor's two routes on one state. Outputs must be equal bit for bit."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu_torch
from siddhi_tpu_torch.core import table as ttable
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.table import TableState

EQ_CASES = ["float32 NaN ±0 ±inf", "float64 NaN ±0 ±inf",
            "int64 differing above bit 32", "string codes", "two columns",
            "four columns", "bool beside int32", "repeats in the batch",
            "invalid lanes", "dead rows", "B = 1", "no live row",
            "no lane valid", "every row one key"]


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def eq_cases():
    return _chip_smoke().k13e_eq_edge_cases(
        torch, np.random.default_rng(20), torch.device("cpu"), B=48, C=160,
        ad=False)


@pytest.mark.parametrize("name", EQ_CASES)
def test_eq_plain_matches_the_full_mask(eq_cases, name):
    assert sorted(eq_cases) == sorted(EQ_CASES)
    lane, row, lv, rv = eq_cases[name]
    mask = np.ones((lv.shape[0], rv.shape[0]), bool)
    for a, r in zip(lane, row):
        mask &= a.numpy()[:, None] == r.numpy()[None, :]
    mask &= lv.numpy()[:, None] & rv.numpy()[None, :]
    got = ttable.last_match_eq(lane, row, lv, rv)
    for g, w in zip(got, ttable.last_match_plain(torch.from_numpy(mask))):
        assert torch.equal(g, w)
    jm = jnp.asarray(mask)
    want = ((jm.any(axis=0), (mask.shape[0] - 1)
             - jnp.argmax(jm[::-1, :], axis=0), jm.any(axis=1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name == "repeats in the batch":  # a row's last lane of its key
        b_star = got[1].numpy()
        keys = lane[0].numpy()
        for c in np.nonzero(got[0].numpy())[0]:
            later = keys[b_star[c] + 1:] == row[0].numpy()[c]
            assert not later.any()


MASK_CASES = ["[B, C] sparse", "[B, C] dense", "[B, C], C = 1000",
              "[B, C] transposed view", "[B, C] one column in", "[B, 1]",
              "[C] table-only", "host scalar true", "card scalar false",
              "no lane valid vector", "every lane invalid", "no live row",
              "B = 1", "C = 1"]


@pytest.fixture(scope="module")
def mask_cases():
    return _chip_smoke().k13e_mask_edge_cases(
        torch, np.random.default_rng(21), torch.device("cpu"), B=40, C=120)


@pytest.mark.parametrize("name", MASK_CASES)
def test_mask_plain_matches_the_jax_reductions(mask_cases, name):
    """The mask route's plain version (the condition as evaluated, with
    the valid vectors) against the JAX reductions of the full mask."""
    assert sorted(mask_cases) == sorted(MASK_CASES)
    cond, lv, rv = mask_cases[name]
    B = lv.shape[0] if lv is not None else cond.shape[0]
    mask = np.broadcast_to(cond.numpy(), (B, rv.shape[0])).copy()
    if lv is not None:
        mask &= lv.numpy()[:, None]
    mask &= rv.numpy()[None, :]
    jm = jnp.asarray(mask)
    want = ((jm.any(axis=0), (B - 1) - jnp.argmax(jm[::-1, :], axis=0),
             jm.any(axis=1)))
    got = ttable.last_match(cond, lv, rv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


APP = ("define stream S (k long, s string, v double, n int);\n"
       "define table T (k long, s string, v double, n int);\n"
       "@info(name='q') from S update T set T.v = v on {cond};")


@pytest.mark.parametrize("cond,chosen", [
    ("T.k == k", True),
    ("T.k == k and T.s == s", True),
    ("k == T.k", True),
    ("T.k == S.k and S.s == T.s", True),  # through the stream's name
    ("T.k + 1 == k * 2", True),
    ("T.k == k and T.v > 0.0", False),
    ("T.k == n", False),  # long against int: the compare promotes
    ("T.k == 9", False),  # table-only: the mask route
    ("T.k == k or T.s == s", False),
    ("T.k == k and T.s == s and T.n == n and T.v == v "
     "and T.k + 1 == k + 1", False),  # five compares
])
def test_equality_route_is_chosen(cond, chosen):
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(APP.format(cond=cond), batch_size=8)
    ex = rt.query_runtimes["q"].table_executor
    assert (ex.eq_plan is not None) == chosen


@pytest.mark.parametrize("action", [
    "update T set T.v = T.v + v, T.n = n on T.k == k",
    "update or insert into T set T.v = v on T.k == S.k and T.s == S.s",
    "delete T on T.v == v and S.k == T.k",
])
def test_equality_route_matches_the_mask_route(action):
    """The executor's run with its equality plan and with the plan taken
    away (the mask route) from one state, double keys with NaN and -0.0
    among them: the table and the insert batch bit for bit."""
    text = ("define stream S (k long, s string, v double, n int);\n"
            "@capacity('64')\ndefine table T (k long, s string, v double, "
            "n int);\n"
            f"@info(name='q') from S {action};")
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(text, batch_size=16)
    ex = rt.query_runtimes["q"].table_executor
    assert ex.eq_plan is not None
    rng = np.random.default_rng(len(action))
    C, B = 64, 16
    vals = np.array([0.0, -0.0, np.nan, 1.5, 2.0], np.float32)
    state = TableState(
        {"k": torch.from_numpy(rng.integers(0, 6, C)),
         "s": torch.from_numpy(rng.integers(1, 4, C).astype(np.int32)),
         "v": torch.from_numpy(vals[rng.integers(0, 5, C)]),
         "n": torch.from_numpy(rng.integers(0, 9, C).astype(np.int32))},
        torch.arange(C, dtype=torch.int64),
        torch.from_numpy(rng.random(C) < 0.7))
    out = EventBatch(
        ts=100 + torch.arange(B, dtype=torch.int64),
        cols={"k": torch.from_numpy(rng.integers(0, 8, B)),
              "s": torch.from_numpy(rng.integers(1, 4, B).astype(np.int32)),
              "v": torch.from_numpy(vals[rng.integers(0, 5, B)]),
              "n": torch.from_numpy(rng.integers(0, 9, B).astype(np.int32))},
        valid=torch.from_numpy(rng.random(B) < 0.85),
        types=torch.zeros(B, dtype=torch.int8))
    got, gins = ex.run(state, out)
    plan, ex.eq_plan = ex.eq_plan, None
    want, wins = ex.run(state, out)
    ex.eq_plan = plan
    for k in want.cols:
        assert torch.equal(_bits(got.cols[k]), _bits(want.cols[k])), k
    assert torch.equal(got.valid, want.valid)
    assert (gins is None) == (wins is None)
    changed = not torch.equal(got.valid, state.valid) or any(
        not torch.equal(_bits(got.cols[k]), _bits(state.cols[k]))
        for k in state.cols)
    assert changed  # some event matched a live row
    if gins is not None:
        assert torch.equal(gins.valid, wins.valid)
        assert bool(gins.valid.any())  # and some matched none


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t
