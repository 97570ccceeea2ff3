"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface (`_kernel_build/lib<name>.so`) and loaded
through ctypes. Builds happen at first use, never at import, and all stale
sources compile in parallel (one nvcc process each). A build is reused when
its source, the shared header and the flags are unchanged (content hash).

Nothing here falls back: a missing `nvcc`, a failed build or a failed launch
raises. The plain PyTorch versions in `ops/` run only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernel_build"
SOURCES = ("k1_partition", "k2b_packed_ring", "k3_hash", "k4_keytable",
           "k5_grouped_scan", "k10_join")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel entry point, counted where the wrapper launches
#: them; chip_smoke.py zeroes them before driving the main path
LAUNCHES = {"K1": 0, "K2b pack": 0, "K2b fetch": 0, "K2b append": 0,
            "K2b gather": 0, "K3": 0, "K4": 0, "K5": 0, "K5 ungrouped": 0,
            "K5b grouped": 0, "K5b ungrouped": 0, "K3b": 0, "K10 append": 0,
            "K10 probe": 0, "K10 compact": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_all() -> dict[str, str]:
    """Compile every stale library in parallel; returns name -> compiler
    report (ptxas registers/spills) for the ones compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = BUILD_DIR / f"lib{name}.so"
        stamp = BUILD_DIR / f"lib{name}.sha256"
        digest = _digest(name)
        if so.exists() and stamp.exists() and stamp.read_text() == digest:
            continue
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, stamp, digest)
    logs, failed = {}, []
    for name, (p, tmp, so, stamp, digest) in procs.items():
        out, _ = p.communicate()
        logs[name] = out
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{out}")
            continue
        os.replace(tmp, so)
        stamp.write_text(digest)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            lib.siddhi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.siddhi_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def bind(name: str, fn: str, argtypes: list):
    """ctypes function `fn` of library `name` with its argtypes set (every
    pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(name: str, what: str, rc: int) -> None:
    if rc != 0:
        msg = library(name).siddhi_cuda_error_string(rc)
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({msg.decode() if msg else '?'})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Device/contiguity checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
