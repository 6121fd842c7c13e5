"""Build the CUDA sources of the port (``kernels/csrc/<name>.cu``) and load
them.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go under
``build/kernels/<name>-<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
rebuilds and an unchanged one is reused.  Nothing is
compiled at import time: ``load`` builds on first use, and ``build``
compiles several sources at once, one ``nvcc`` process each, all started
together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_attention", "gcl_loss", "ssd_chunk")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on the machine with the "
            "card")
    return found


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # the shared headers
        h.update(header.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_log(name: str) -> str:
    """The nvcc/ptxas output of the library's build (registers, spills)."""
    return (lib_path(name).parent / "build.log").read_text()


def _build_locked(names: Iterable[str]) -> None:
    """Compile every source of ``names`` that has no library yet: one
    nvcc process per source, started together, then waited on."""
    jobs = []
    for name in dict.fromkeys(names):
        out = lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"{out.name}.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile the named sources in parallel (those not built yet)."""
    with _lock:
        _build_locked(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, compiled first if it is not
    built yet."""
    with _lock:
        if name not in _loaded:
            _build_locked([name])
            _loaded[name] = ctypes.CDLL(str(lib_path(name)))
        return _loaded[name]
