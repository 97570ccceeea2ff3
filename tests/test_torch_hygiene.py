"""siddhi_tpu_torch stands apart from the JAX package: importing it (and
chip_smoke.py) loads no `jax` and no `siddhi_tpu` module, and its entry
point runs on the CUDA card unless the caller asks for the CPU — without a
card it raises instead of falling back."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import sys
        import siddhi_tpu_torch, chip_smoke
        import siddhi_tpu_torch.interop, siddhi_tpu_torch.kernels
        import siddhi_tpu_torch.core.aggregation
        import siddhi_tpu_torch.io.record_table
        import siddhi_tpu_torch.ops.bucket_scatter
        import siddhi_tpu_torch.core.ingress, siddhi_tpu_torch.core.superstep
        import siddhi_tpu_torch.ops.superstep_pack
        import siddhi_tpu_torch.core.partition
        import siddhi_tpu_torch.parallel.sharded
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "siddhi_tpu" or m.startswith("siddhi_tpu."))
        print(",".join(bad))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    from siddhi_tpu_torch import SiddhiManager
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SiddhiManager()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SiddhiManager(device="cuda")
    assert SiddhiManager(device="cpu").device.type == "cpu"


def test_wrappers_refuse_cpu_and_cuda_mix():
    # a CUDA wrapper never runs the plain version: it checks its inputs
    from siddhi_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require_cuda("k", torch.zeros(3))


def test_chip_smoke_without_a_card_exits_nonzero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_port_builds_its_own_host_encoder_source():
    # the port reads no file under native/: its loader compiles the copy
    # inside the package, and no module names the reference's source
    from pathlib import Path

    from siddhi_tpu_torch import native
    pkg = Path(REPO) / "siddhi_tpu_torch"
    assert native.SRC == pkg / "csrc" / "host_columnar.c"
    assert native.SRC.exists() and native.BUILD_ROOT.parent == pkg
    for py in pkg.rglob("*.py"):
        text = py.read_text()
        for literal in ('"columnar.c"', '"native"', "'native'",
                        '"native/', "'native/"):
            assert literal not in text, (py, literal)
