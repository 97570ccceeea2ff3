"""Loader for the native host-path extension (`_siddhi_torch_native`).

Builds `csrc/host_columnar.c` at first use with the host C compiler into
`siddhi_tpu_torch/_native_build/<source hash>/` and loads it from there. The
cache is keyed by a hash of the C source and the interpreter's extension
suffix: editing the source makes a new build, so a stale binary never
shadows a newer source. Without a compiler or Python's headers the loader
returns None and the callers run the pure-Python encoder, which gives the
same codes and events. Set SIDDHI_TPU_NO_NATIVE=1 (or SIDDHI_NATIVE=0) to
force the Python path.

This is host code: interning and Event construction run on the CPU on every
device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import shlex
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

_log = logging.getLogger("siddhi_tpu_torch")

SRC = Path(__file__).resolve().parent / "csrc" / "host_columnar.c"
BUILD_ROOT = Path(__file__).resolve().parent / "_native_build"
MODULE = "_siddhi_torch_native"

_lock = threading.Lock()
_loaded: dict = {}  # "module" -> the extension module or None


def disabled() -> bool:
    return bool(os.environ.get("SIDDHI_TPU_NO_NATIVE")) or \
        os.environ.get("SIDDHI_NATIVE", "").strip() == "0"


def _suffix() -> str:
    return sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def _build_dir() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(_suffix().encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(out: Path) -> bool:
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        _log.info("no Python.h under %s: using the Python encoder", include)
        return False
    cc = shlex.split(sysconfig.get_config_var("CC") or "cc")
    if not cc or shutil.which(cc[0]) is None:
        _log.info("no C compiler: using the Python encoder")
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [*cc, "-O3", "-shared", "-fPIC", f"-I{include}", str(SRC),
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        _log.info("native extension build failed, using the Python "
                  "encoder: %s", e)
        return False
    os.replace(tmp, out)  # atomic: concurrent builds agree
    for entry in BUILD_ROOT.iterdir():  # drop superseded builds
        if entry != out.parent:
            shutil.rmtree(entry, ignore_errors=True)
    return True


def _import(path: Path):
    spec = importlib.util.spec_from_file_location(MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load():
    """The extension module, building it on first use; None when it is
    disabled or cannot be built here (the Python encoder runs then)."""
    if "module" in _loaded:
        return _loaded["module"]
    with _lock:
        if "module" not in _loaded:
            mod = None
            if not disabled():
                path = _build_dir() / f"{MODULE}{_suffix()}"
                try:
                    if path.exists() or _build(path):
                        mod = _import(path)
                except ImportError as e:
                    _log.info("native extension import failed: %s", e)
            _loaded["module"] = mod
    return _loaded["module"]


def available() -> bool:
    return load() is not None
