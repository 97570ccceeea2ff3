"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface (`_kernel_build/lib<name>.so`) and loaded
through ctypes. Builds happen at first use, never at import, and all stale
sources compile in parallel (one nvcc process each). A build is reused when
its source, the shared headers and the flags are unchanged (content
hash).

Nothing here falls back: a missing `nvcc`, a failed build or a failed launch
raises `KernelError`. The plain PyTorch versions in `ops/` run only for CPU
tensors.

Kernels whose blocks wait for each other in one launch (the look-back
flags of K1 and K5, the grid barriers of K4, K4b, K7, K7's merge, K10,
K12a, K13d and K13e) keep their counters and flags in a `workspace`: one zeroed buffer
per library, device and stream, which every launch leaves zeroed again,
so no launch is spent clearing it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernel_build"
SOURCES = ("k1_partition", "k2b_packed_ring", "k3_hash", "k4_keytable",
           "k4b_dense_keys", "k5_grouped_scan", "k6_search", "k7_radix_sort",
           "k7_merge", "k8_extrema", "k9_hll", "k10_join",
           "k11_pattern", "k11c_absent", "k12a_wire_pack",
           "k13a_expression_walk", "k13b_frequent", "k13c_limiter_ring",
           "k13d_table_insert", "k13e_last_match", "k13f_bucket_scatter",
           "k12b_superstep_pack")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel entry point, counted where the wrapper launches
#: them; chip_smoke.py zeroes them before driving the main path
LAUNCHES = {"K1": 0, "K2b pack": 0, "K2b fetch": 0, "K2b append": 0,
            "K2b gather": 0, "K3": 0, "K4": 0, "K5": 0, "K5 ungrouped": 0,
            "K5b grouped": 0, "K5b ungrouped": 0, "K3b": 0, "K10 append": 0,
            "K10 probe": 0, "K10 probe compact": 0, "K10 compact": 0,
            "K11a": 0,
            "K7 pattern index": 0, "K11b": 0,
            "K11c": 0, "K11d": 0, "K11e": 0,
            "K8": 0, "K8 grouped": 0, "K9 HLL": 0, "K9 HLL estimate": 0,
            "K12a": 0, "K7 session chunk": 0, "K7 sort chunk": 0,
            "K7 rank": 0, "K7 keyed group": 0, "K7 keyed top-E": 0,
            "K7 packed chunk": 0, "K7 frequent key": 0,
            "K7 frequent match": 0, "K13a sliding": 0, "K13a batch": 0,
            "K13b": 0, "K13b grouped snapshot": 0, "K13c append": 0,
            "K13c gather": 0, "K13c snapshot append": 0,
            "K13c snapshot gather": 0, "K7 time-first": 0, "K7 order by": 0,
            "K1 order by": 0, "K5b ordinal": 0, "K5b limit": 0,
            "K13d dedup": 0, "K13d place": 0, "K13e": 0, "K13e eq": 0,
            "K1 table free": 0, "K7 table index": 0,
            "K13b final per group": 0,
            "K13f ingest": 0, "K13f evict": 0, "K13f restore": 0,
            "K3 aggregation": 0, "K4 aggregation": 0, "K12b": 0,
            "K3 partition": 0, "K4b": 0, "K6": 0, "K7 merge": 0,
            "K7 K5 sort": 0, "K7 K5b sort": 0, "K7 bucket order": 0,
            "K7 bounded": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: (library, device index, stream) -> zeroed workspace tensor
_workspaces: dict[tuple, torch.Tensor] = {}
#: (library, function, argtypes, restype) -> the bound ctypes function
_bound: dict[tuple, object] = {}


class KernelError(RuntimeError):
    """A kernel that did not build or did not launch. The async ingress
    feeder lets it propagate instead of declining to the per-batch path:
    that path launches the same kernels."""


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
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


def bind(name: str, fn: str, argtypes: list, restype=ctypes.c_int):
    """ctypes function `fn` of library `name` with its argtypes set (every
    pointer and the stream as c_void_p, so none is cut to 32 bits), bound
    once: later calls return the same function."""
    key = (name, fn, tuple(argtypes), restype)
    f = _bound.get(key)
    if f is None:
        f = library(name)[fn]  # a function object of its own
        f.argtypes = argtypes
        f.restype = restype
        _bound[key] = f
    return f


def check(name: str, what: str, rc: int, device=None) -> None:
    """Raise KernelError for a failed launch; `device` names the device
    whose workspace of library `name` the launch used (dropped, since a
    launch that did not end may leave it dirty)."""
    if rc != 0:
        if device is not None:
            with _lock:
                _workspaces.pop(_workspace_key(name, device), None)
        msg = library(name).siddhi_cuda_error_string(rc)
        raise KernelError(f"{what}: CUDA launch failed with error {rc} "
                           f"({msg.decode() if msg else '?'})")


def _workspace_key(name: str, device, stream_handle=None) -> tuple:
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return name, index, stream_handle or stream()


def workspace(name: str, nbytes: int, device,
              stream_handle: Optional[int] = None) -> torch.Tensor:
    """Library `name`'s workspace on the current stream of `device` (its
    raw handle, `stream()`, where the caller has it): at least `nbytes`,
    zero when first allocated. Its kernels leave it zero when they end
    (tile and barrier counters, flags), so no call clears it; launches on
    one stream run in order, and each stream has its own."""
    key = _workspace_key(name, device, stream_handle)
    with _lock:
        ws = _workspaces.get(key)
        if ws is None or ws.numel() < nbytes:
            ws = torch.zeros(max(nbytes, 256), dtype=torch.uint8,
                             device=device)
            _workspaces[key] = ws
    return ws


def stream() -> int:
    """The current device's current CUDA stream as its raw handle (without
    building a torch Stream object, which costs a few us of host time)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Device/contiguity checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
