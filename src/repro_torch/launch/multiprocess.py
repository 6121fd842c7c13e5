"""Multi-process runtime (port of ``repro.launch.multiprocess``): joining
the ``torch.distributed`` group, and the harness that spawns a group.

The launcher side (``repro_torch.launch.train --mesh data:N,fsdp:M
--coordinator ADDR --num-processes N*M --process-id K``) calls
:func:`initialize` before building the mesh: one process per rank, each
with one device (``launch.mesh.rank_device`` of its index among the
ranks of its host), the backend by the rule of
``launch.mesh.choose_backend`` (NCCL when every rank has a card of its
own, gloo when ranks share one card or run on the CPU).  Each rank
writes its host name and card count to the rendezvous store before the
group starts, so all ranks apply the rule to the same list.  ``ADDR``
names the store: ``file:///path`` (a FileStore, what the harness uses:
no port is picked, so concurrent groups cannot collide) or
``HOST:PORT`` / ``tcp://HOST:PORT`` (a TCP store served by process
0).  Every process
group has a timeout, so a rank that dies cannot hang its peers forever.

The harness side (:func:`run_train_multiprocess`, also ``python -m
repro_torch.launch.multiprocess --nproc 4 -- <train args>``) spawns the
ranks behind a fresh FileStore in a temporary directory and collects
their outputs; when one rank exits with an error, or the timeout
passes, it kills the whole group.  JAX's ``--local-devices`` (forced
CPU devices per process) has no counterpart: a rank has one device.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch import device as D
from repro_torch.launch import mesh as MS

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the process group's collective timeout (seconds)
GROUP_TIMEOUT = 600.0
_RDZV_TMP: Optional[str] = None     # a one-rank group's store directory


def make_store(coordinator: str, num_processes: int, process_id: int,
               timeout: float):
    """The rendezvous store ``coordinator`` names: ``file:///path`` -> a
    FileStore; ``HOST:PORT`` or ``tcp://HOST:PORT`` -> a TCP store that
    process 0 serves."""
    import torch.distributed as dist
    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):],
                               int(num_processes))
        store.set_timeout(datetime.timedelta(seconds=timeout))
        return store
    addr = coordinator.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad coordinator {coordinator!r} (want "
                         "file:///path or HOST:PORT)")
    return dist.TCPStore(host, int(port), int(num_processes),
                         is_master=process_id == 0,
                         timeout=datetime.timedelta(seconds=timeout))


def initialize(coordinator: Optional[str], num_processes: int = 1,
               process_id: int = 0, device=D.DEFAULT,
               timeout: float = GROUP_TIMEOUT) -> torch.device:
    """Join the process group as rank ``process_id`` of
    ``num_processes``; returns this rank's device (the card of its own,
    or the shared one) and makes it the current CUDA device.  The
    device defaults to the card, and a missing card raises before the
    group is joined (``repro_torch.device.resolve``); pass ``"cpu"`` for
    a CPU rank.  A run with one process and no coordinator gets a
    one-rank group behind a FileStore in a fresh temporary directory."""
    import torch.distributed as dist
    global _RDZV_TMP
    want = D.resolve(device)
    if not coordinator:
        if num_processes > 1:
            raise ValueError("--num-processes > 1 requires --coordinator "
                             "(file:///path or HOST:PORT)")
        _RDZV_TMP = tempfile.mkdtemp(prefix="rdzv-")
        coordinator = f"file://{os.path.join(_RDZV_TMP, 'store')}"
    store = make_store(coordinator, num_processes, process_id, timeout)
    cards = torch.cuda.device_count() if want.type == "cuda" else 0
    store.set(f"rank_host/{process_id}",
              json.dumps([socket.gethostname(), cards]))
    hosts = [tuple(json.loads(store.get(f"rank_host/{r}")))
             for r in range(int(num_processes))]
    dev = MS.rank_device(want, MS.local_rank(hosts, int(process_id)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        MS.choose_backend(hosts), store=store,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout))
    return dev


def shutdown() -> None:
    """Leave the process group (and drop a one-rank group's store)."""
    import torch.distributed as dist
    global _RDZV_TMP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if _RDZV_TMP is not None:
        shutil.rmtree(_RDZV_TMP, ignore_errors=True)
        _RDZV_TMP = None


def run_train_multiprocess(train_args: Sequence[str],
                           num_processes: int = 2, timeout: float = 600.0,
                           env_extra: Optional[dict] = None,
                           module: str = "repro_torch.launch.train",
                           kill_when: Optional[Callable[[], bool]] = None
                           ) -> List[SimpleNamespace]:
    """Spawn ``num_processes`` ranks of ``module`` (``python -m``) with
    the rank flags appended, behind a FileStore in a fresh temporary
    directory, and wait for all of them.  Returns one
    ``SimpleNamespace(returncode, stdout, stderr)`` per rank (rank
    order); failures are reported, not raised.  A rank that exits with
    an error, or the timeout, kills every rank still running: its peers
    would otherwise wait in a collective.  ``kill_when`` (polled while
    the ranks run) returning True SIGKILLs the whole group: the
    crash-and-resume tests."""
    tmp = tempfile.mkdtemp(prefix="mp-")
    coord = f"file://{os.path.join(tmp, 'store')}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if env_extra:
        env.update(env_extra)
    procs, files = [], []
    try:
        for rank in range(num_processes):
            out = open(os.path.join(tmp, f"out{rank}"), "w+")
            err = open(os.path.join(tmp, f"err{rank}"), "w+")
            files.append((out, err))
            cmd = [sys.executable, "-m", module, *train_args,
                   "--coordinator", coord,
                   "--num-processes", str(num_processes),
                   "--process-id", str(rank)]
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=err,
                                          text=True, env=env))
        deadline = time.monotonic() + timeout
        note = ""
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            killed = kill_when is not None and kill_when()
            if failed or killed or time.monotonic() > deadline:
                note = (f"\n[harness] rank {failed[0]} exited "
                        f"{procs[failed[0]].returncode}; killed the group"
                        if failed else "\n[harness] kill_when: killed the "
                        "group" if killed else
                        f"\n[harness] killed after {timeout:.0f}s timeout")
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                break
            time.sleep(0.05)
        results = []
        for p, (out, err) in zip(procs, files):
            p.wait()
            out.seek(0)
            err.seek(0)
            results.append(SimpleNamespace(returncode=p.returncode,
                                           stdout=out.read(),
                                           stderr=err.read() + note))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="spawn an N-rank training run (repro_torch.launch."
                    "train) behind one FileStore")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="arguments forwarded to repro_torch.launch.train "
                         "(prefix with --)")
    args = ap.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    results = run_train_multiprocess(train_args, num_processes=args.nproc,
                                     timeout=args.timeout)
    rc = 0
    for rank, r in enumerate(results):
        print(f"--- rank {rank} (exit {r.returncode}) ---")
        print(r.stdout, end="")
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
