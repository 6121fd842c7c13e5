"""The port stands alone: every ``repro_torch`` module and
``chip_smoke.py`` import with ``jax`` and ``repro`` blocked, and
``chip_smoke.py`` refuses to run without a GPU or outside a checkout.
Subprocesses, because this test process has imported jax already
(tests/conftest.py)."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None       # any import of them raises ImportError
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import repro_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro")
            and sys.modules[m] is not None]
print("IMPORTED", len(names))
"""


def test_every_port_module_imports_without_jax_or_repro():
    p = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode == 0, p.stderr[-3000:]
    n = int(p.stdout.split("IMPORTED")[1])
    assert n >= 30          # every module of the package, not a few


def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        p = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert '"ok": true' not in p.stdout


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(tmp_path,
                                                        monkeypatch):
    """The build helper: one library per source, keyed by a hash of the
    source and flags; without nvcc it raises instead of running
    anything else."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    key = build.lib_path("flash_attention").parent.name
    assert key.startswith("flash_attention-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.lib_path("flash_attention").parent.name != key
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("flash_attention")
