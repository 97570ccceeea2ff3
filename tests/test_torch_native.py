"""The port's native host encoder (siddhi_tpu_torch/csrc/host_columnar.c,
loaded by siddhi_tpu_torch/native.py) against the JAX package's string
table and encoder, and against the port's own Python path: interning with
the pointer-identity memo, transient (UUID) codes and their generations,
restore, row encoding per type with nulls, and the decode helpers
(map_codes, build_events). Codes, strings and values are exact.
"""

import fcntl
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

import siddhi_tpu.core.event as jevent
from siddhi_tpu import native as jnative
from siddhi_tpu.query_api.definition import (Attribute, AttributeType,
                                             StreamDefinition)
from siddhi_tpu_torch import native
from siddhi_tpu_torch.core import event as tevent
from siddhi_tpu_torch.errors import StaleTransientCodeError
from siddhi_tpu_torch.query_api.definition import Attribute as TAttribute
from siddhi_tpu_torch.query_api.definition import \
    AttributeType as TAttributeType
from siddhi_tpu_torch.query_api.definition import \
    StreamDefinition as TStreamDefinition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def python_encoder(monkeypatch):
    """The port with its native extension switched off."""
    monkeypatch.setattr(native, "load", lambda: None)


def _columns(seed: int):
    """Pooled symbol objects, fresh equal strings and None, three ways."""
    rng = np.random.default_rng(seed)
    pool = [f"SYM{i}" for i in range(40)]
    pooled = np.array([pool[i] for i in rng.integers(0, 40, 300)],
                      dtype=object)
    fresh = np.array(["".join(["SYM", str(int(i))])
                      for i in rng.integers(0, 60, 300)], dtype=object)
    mixed = pooled.copy()
    mixed[rng.random(300) < 0.2] = None
    return [pooled, fresh, mixed, pooled]


def test_native_extension_builds_here_and_is_cached_by_source_hash():
    mod = native.load()
    assert mod is not None and native.available()
    assert mod.__name__ == "_siddhi_torch_native"
    built = os.path.dirname(mod.__file__)
    assert os.path.basename(built) == native._build_dir().name
    for fn in ("encode_rows", "idmemo_new", "intern_column", "map_codes",
               "build_events"):
        assert callable(getattr(mod, fn))


def test_disable_switches_select_the_python_encoder():
    code = textwrap.dedent("""
        from siddhi_tpu_torch import native
        print(native.load() is None)
    """)
    for env_kv in ({"SIDDHI_NATIVE": "0"}, {"SIDDHI_TPU_NO_NATIVE": "1"}):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(env_kv)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "True"


def _rebuild_reference() -> None:
    """Build the JAX package's extension afresh (`--force`: a broken
    library that a colliding build left is newer than its source, so an
    ordinary build skips it) into a private directory, then move it into
    the build directory by an atomic rename: a worker that has the old
    file loaded keeps its mapping."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run(
            [sys.executable, "setup.py", "build_ext", "--force",
             "--build-lib", tmp, "--build-temp", os.path.join(tmp, "obj")],
            cwd=jnative._SRC_DIR, check=True, capture_output=True,
            timeout=300)
        os.makedirs(jnative._BUILD_DIR, exist_ok=True)
        for name in os.listdir(tmp):
            if name.endswith(".so"):
                part = os.path.join(jnative._BUILD_DIR, f".{name}.part")
                shutil.copyfile(os.path.join(tmp, name), part)
                os.replace(part, os.path.join(jnative._BUILD_DIR, name))


def _reference_native():
    """The JAX package's native module. Its loader builds the extension
    in place when siddhi_tpu is first imported (`setup.py build_ext` into
    one shared directory, pruning the other hash directories), so test
    workers importing it at once on a fresh tree race: a worker whose
    build collides with another's keeps the Python encoder, and the
    colliding builds can leave a broken library. Load it under an
    exclusive lock on a file beside the build root, so no two callers
    build at once; if it does not import, rebuild it and import it
    after the build."""
    if jnative.native is not None or jnative._DISABLED:
        return jnative.native
    lock = os.path.join(os.path.dirname(jnative._BUILD_ROOT),
                        "_native_build.lock")
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for _ in range(3):
                try:
                    jnative._try_import()
                    break
                except ImportError:
                    _rebuild_reference()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return jnative.native


def test_intern_column_with_memo_matches_jax():
    # the reference encodes natively too
    assert _reference_native() is not None
    jt, tt = jevent.StringTable(), tevent.StringTable()
    for col in _columns(0):
        want = jt.encode_array(col)
        got = tt.encode_array(col)
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert tt._id_memo is not None
    assert tt._to_str == jt._to_str and tt._to_code == jt._to_code


def test_python_encoder_gives_the_same_codes(python_encoder):
    jt, tt = jevent.StringTable(), tevent.StringTable()
    for col in _columns(1):
        assert np.array_equal(tt.encode_array(col), jt.encode_array(col))
    assert tt._id_memo is None
    assert tt._to_str == jt._to_str


def test_transient_codes_generations_and_stale_error():
    jt, tt = jevent.StringTable(), tevent.StringTable()
    for t in (jt, tt):
        t.encode("perm")
    codes = [(jt.encode_transient(f"u{i}", capacity=3),
              tt.encode_transient(f"u{i}", capacity=3)) for i in range(8)]
    assert all(a == b for a, b in codes)
    got = [b for _, b in codes]
    assert got[0] == tevent.StringTable.TRANSIENT_BASE
    assert got[3] == tevent.StringTable.TRANSIENT_BASE + 3  # gen 1, pos 0
    assert tt._transient_gens == jt._transient_gens == [2, 2, 1]
    for c in got[5:]:
        assert tt.decode(c) == jt.decode(c)
    with pytest.raises(StaleTransientCodeError):
        tt.decode(got[0])
    # a live transient string is interned to its transient code, natively
    # and in Python; a recycled one is interned as a new permanent string
    col = np.array(["u7", "u0", None, "perm"], dtype=object)
    assert np.array_equal(tt.encode_array(col), jt.encode_array(col))
    assert tt.encode_array(col)[0] == got[7]


def test_restore_drops_the_memo():
    tt = tevent.StringTable()
    pool = np.array(["A", "B", "C"], dtype=object)
    first = tt.encode_array(pool)
    assert tt._id_memo is not None and first.tolist() == [1, 2, 3]
    tt.restore([None, "C", "B", "A"])  # codes reassigned
    assert tt._id_memo is None
    assert tt.encode_array(pool).tolist() == [3, 2, 1]
    jt = jevent.StringTable()
    jt.encode_array(pool)
    jt.restore([None, "C", "B", "A"])
    assert tt.snapshot() == jt.snapshot()


SCHEMA = (("s", "STRING"), ("i", "INT"), ("l", "LONG"), ("f", "FLOAT"),
          ("d", "DOUBLE"), ("b", "BOOL"))
ROWS = [("x", 1, 2**40, 1.5, 2.25, True),
        (None, None, None, None, None, None),
        ("y", -7, -3, -0.5, 1e10, False),
        ("x", 2**31 - 1, 2**62, 3.0, -1.0, True)]


def _codecs():
    jd = StreamDefinition("S", tuple(Attribute(n, AttributeType[t])
                                     for n, t in SCHEMA))
    td = TStreamDefinition("S", tuple(TAttribute(n, TAttributeType[t])
                                      for n, t in SCHEMA))
    return jevent.StreamCodec(jd), tevent.StreamCodec(td)


def _rows_to_columns_matches_jax():
    jc, tc = _codecs()
    want = jc.rows_to_columns(ROWS, n_pad=6)
    got = tc.rows_to_columns(ROWS, n_pad=6)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    return tc


def test_encode_rows_per_type_with_nulls_matches_jax():
    tc = _rows_to_columns_matches_jax()
    assert tc._native_plan is not None


def test_python_rows_path_matches_jax(python_encoder):
    tc = _rows_to_columns_matches_jax()
    assert tc._native_plan is None


def test_map_codes_and_build_events_match_the_python_decode(monkeypatch):
    _, tc = _codecs()
    cols = tc.rows_to_columns(ROWS)
    ts = np.array([5, 6, 7, 8], np.int64)
    exp = np.array([False, True, False, True])
    tbl = tc.string_tables["s"]
    assert native.load().map_codes(cols["s"], tbl._to_str) == \
        tbl.decode_array(cols["s"].tolist()) == ["x", None, "y", "x"]
    native_events = tevent.events_from_columns(tc, ts, exp, cols)
    monkeypatch.setattr(native, "load", lambda: None)
    python_events = tevent.events_from_columns(tc, ts, exp, cols)
    assert native_events == python_events
    assert all(type(e) is tevent.Event for e in native_events)
    assert native_events[1] == tevent.Event(
        6, (None, 0, 0, 0.0, 0.0, False), is_expired=True)
    assert native_events[0].data[1:] == (1, 2**40, 1.5, 2.25, True)
