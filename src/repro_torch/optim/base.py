"""Optimizer interface (port of ``repro.optim.base``, paper Proc. 4):

    opt = adamw(beta1=..., ...)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, lr=..., wd=...)

``params`` and ``grads`` are dicts of tensors keyed by parameter name
(``dict(model.named_parameters())``); the state holds f32 moments under
the same names and an int32 step count ``t``.  ``update`` follows the JAX
math step for step and returns new tensors, leaving its inputs as they
were; the train step writes the new values into the module's parameters
in place (under ``torch.no_grad()``), after its non-finite guard has
chosen between them and the old ones.  ``lr``/``wd`` come at update time
so schedules stay outside.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Dict[str, torch.Tensor]], Any]
    update: Callable[..., Any]  # (params, grads, state, *, lr, wd) -> (p, s)
    # True when ``update`` is elementwise per leaf (safe on ZeRO shards);
    # LAMB's whole-leaf trust ratio is not
    shard_safe: bool = True


def tree_zeros_like(params: Dict[str, torch.Tensor]):
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def global_norm(tree: Dict[str, torch.Tensor], *, axes=None,
                sharded_dims=None) -> torch.Tensor:
    """L2 norm over every leaf (f32).  With ``axes`` (mesh axis names)
    the tree holds a rank's shards: the squared sums of the leaves that
    ``sharded_dims`` marks (a dict of the same keys, non-None = sharded)
    are all-reduced over ``axes``, replicated leaves count once, so every
    rank gets the norm of the whole tree."""
    if axes is None or sharded_dims is None:
        sq = sum(torch.sum(torch.square(g.float())) for g in tree.values())
        return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
    from repro_torch.core import shard_state as SS
    sq_rep, sq_shard = [], []
    for k, g in tree.items():
        (sq_rep if sharded_dims[k] is None else sq_shard).append(
            torch.sum(torch.square(g.float())))
    dev = next(iter(tree.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rep = sum(sq_rep, zero)
    shard = SS.psum(sum(sq_shard, zero), tuple(axes))
    return torch.sqrt(rep + shard)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(n, 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, n
