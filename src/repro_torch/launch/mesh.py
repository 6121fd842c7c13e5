"""The (data, fsdp) training mesh (port of the train-mesh part of
``repro.launch.mesh``).

JAX puts the whole mesh in one process and runs the step under
``shard_map``.  Here every rank is one process with one device, so
``--mesh data:N,fsdp:M`` means a ``torch.distributed`` group of N*M
ranks.  Rank ``r`` sits at ``(data, fsdp) = (r // M, r % M)``: the
data-major order of JAX's ``_global_index``, which is also the row-block
order of ``core.distributed.gather_axes`` (it gathers the last axis
first), so ``row_offset = r * b`` masks the right diagonal on any
two-axis mesh.  Each rank holds two subgroups: its ``fsdp`` row (M ranks,
the weight all-gather / gradient reduce-scatter group) and its ``data``
column (N ranks).  An axis of size 1 has no group and its collectives are
the identity, as a size-1 mesh axis is in JAX.

The backend follows one rule (``choose_backend``): NCCL when every rank
has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) and for CPU tensors.  The ranks decide it together
from each rank's host and card count, exchanged through the rendezvous
store, so a group over several hosts of several cards each takes NCCL.  Compute stays on each rank's
device either way.

``fsdp_leaf_dim`` is copied exactly from the JAX module: the checkpoint
reshard guarantee (a save at one mesh shape restores bit-exactly at any
other, in either package) rests on both packages recomputing the same
rule.  The production TPU meshes and the decode shardings have no
counterpart here.
"""
from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

TRAIN_AXES = ("data", "fsdp")


def choose_backend(hosts: Sequence[Tuple[str, int]]) -> str:
    """The group's backend from every rank's ``(host, cards)`` (rank
    order; ``cards`` is the number of cards the rank's host gives it, 0
    for a rank on the CPU): "nccl" when no two ranks share a card, that
    is every rank is on CUDA and no host has more ranks than cards;
    else "gloo" (ranks sharing a card, or CPU tensors).  Every rank
    computes it from the same list, so the group agrees."""
    ranks = collections.Counter(h for h, _ in hosts)
    cards = {}
    for h, c in hosts:
        cards[h] = min(cards.get(h, c), c)
    return ("nccl" if all(cards[h] >= n for h, n in ranks.items())
            else "gloo")


def local_rank(hosts: Sequence[Tuple[str, int]], rank: int) -> int:
    """``rank``'s index among the ranks on its own host."""
    return sum(1 for h, _ in hosts[:rank] if h == hosts[rank][0])


def rank_device(device: torch.device, local: int) -> torch.device:
    """The device of the rank with host-local index ``local``: its own
    card when the host has enough, else the host's cards round-robin
    (ranks share them); the CPU stays the CPU."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def validate_mesh_devices(data: int, fsdp: int, world_size: int) -> None:
    """The mesh must cover every rank of the process group exactly: a
    rank outside it could never feed its sample shard."""
    n = data * fsdp
    if data < 1 or fsdp < 1:
        raise ValueError(f"--mesh data:{data},fsdp:{fsdp}: sizes must be "
                         ">= 1")
    if n != world_size:
        raise ValueError(
            f"--mesh data:{data},fsdp:{fsdp} needs {n} ranks (one process "
            f"each) but the process group has {world_size}.  Launch "
            f"{n} ranks (python -m repro_torch.launch.multiprocess --nproc "
            f"{n} -- ...) or shrink the mesh.")


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (data, fsdp) mesh."""
    data: int
    fsdp: int
    rank: int
    device: torch.device
    backend: Optional[str]          # None: one process, no process group
    groups: Dict[str, object]       # axis -> ProcessGroup (None: size 1)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "fsdp": self.fsdp}

    @property
    def world_size(self) -> int:
        return self.data * self.fsdp

    def axis_size(self, ax: str) -> int:
        return self.shape[ax]

    def axis_index(self, ax: str) -> int:
        return self.rank // self.fsdp if ax == "data" else self.rank % self.fsdp


_CURRENT: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """The mesh the collectives of ``core.distributed`` and
    ``core.shard_state`` run on (one per process)."""
    global _CURRENT
    _CURRENT = mesh


def current_mesh() -> Mesh:
    if _CURRENT is None:
        raise RuntimeError("set_mesh(mesh) (or make_train_mesh) before "
                           "running collectives over mesh axes")
    return _CURRENT


def make_train_mesh(data: int, fsdp: int = 1, *, device=None) -> Mesh:
    """This rank's (data, fsdp) mesh over the initialised process group
    (or over this process alone when none is initialised and the mesh
    has one rank), made the current mesh.  Every rank must call it: the
    subgroups are created collectively, every row and column on every
    rank, in the same order."""
    import torch.distributed as dist
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    validate_mesh_devices(data, fsdp, world)
    device = torch.device("cpu" if device is None else device)
    groups: Dict[str, object] = {"data": None, "fsdp": None}
    if fsdp > 1:
        for d in range(data):
            g = dist.new_group([d * fsdp + j for j in range(fsdp)])
            if rank // fsdp == d:
                groups["fsdp"] = g
    if data > 1:
        for j in range(fsdp):
            g = dist.new_group([i * fsdp + j for i in range(data)])
            if rank % fsdp == j:
                groups["data"] = g
    mesh = Mesh(data, fsdp, rank, device,
                dist.get_backend() if live else None, groups)
    set_mesh(mesh)
    return mesh


def parse_mesh_arg(spec: str):
    """'data:N[,fsdp:M]' -> (N, M).  Axis order is fixed; fsdp defaults
    to 1 (pure data parallelism on the same named-mesh path)."""
    sizes = {"data": None, "fsdp": 1}
    for part in spec.split(","):
        if ":" not in part:
            raise ValueError(f"bad mesh spec {spec!r} (want data:N[,fsdp:M])")
        name, _, val = part.partition(":")
        name = name.strip()
        if name not in sizes:
            raise ValueError(f"unknown mesh axis {name!r} in {spec!r} "
                             f"(train meshes have axes {TRAIN_AXES})")
        sizes[name] = int(val)
    if sizes["data"] is None or sizes["data"] < 1 or sizes["fsdp"] < 1:
        raise ValueError(f"bad mesh spec {spec!r} (want data:N[,fsdp:M], "
                         f"N,M >= 1)")
    return sizes["data"], sizes["fsdp"]


# Leaves that never shard: norms/scales/biases, attention biases, SSM
# scalars, cls/pos embeddings (tiny; gathering them would cost more than
# the memory saved).
_FSDP_REPLICATED = re.compile(
    r"(norm|scale|bias|b[qkv]|b_(in|out)|A_log|dt_bias|/D$|cls|pos)")
FSDP_MIN_ELEMENTS = 1 << 12


def fsdp_leaf_dim(path: str, shape: Sequence[int],
                  size: int) -> Optional[int]:
    """The dim a leaf ZeRO-shards over an fsdp axis of ``size`` (None =
    replicated).  Deterministic in (path, shape, size) only, so that a
    checkpoint reshards across mesh shapes; shared by the sharded train
    step (all-gather axis / reduce-scatter dim), the state layout and the
    per-shard checkpoint files.  Prefers the contraction dim (-2 in the
    x@w convention), then -1, then the largest remaining divisible dim."""
    if size <= 1 or len(shape) < 2:
        return None
    if int(np.prod(shape)) < FSDP_MIN_ELEMENTS:
        return None
    if _FSDP_REPLICATED.search(path):
        return None
    cand = [len(shape) - 2, len(shape) - 1]
    cand += sorted((i for i in range(len(shape) - 2)),
                   key=lambda i: -shape[i])
    for i in cand:
        if shape[i] % size == 0 and shape[i] >= size:
            return i
    return None
