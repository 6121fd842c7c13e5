"""Sharded train state: the (data, fsdp) mesh contract (port of
``repro.core.shard_state``).

One layout, shared by train, eval and checkpoints, as in the JAX
package:

  * the batch, the global sample indices and the FCCO per-sample state
    (log-u buffers, v2's per-sample temperatures and their moments) shard
    by **sample ownership over both axes**: rank ``r`` owns rows
    ``[r * shard, (r + 1) * shard)``, the data-major order of the
    loader's shard-concatenated batches and of
    ``distributed._global_index``;
  * params and optimizer moments ZeRO-shard one dim over ``fsdp`` only
    (replicated across ``data``), per ``launch.mesh.fsdp_leaf_dim`` on
    the JAX params layout (a layer stack is one leaf with a leading
    layer axis), so the shard files of a checkpoint are the JAX
    package's;
  * scalars (step counters, the global tau and its moments) replicate.

A rank's state is the JAX train-state tree with the params (and their
moments) as flat dicts keyed by the JAX paths (``vision/blocks/attn/
wq``), each holding this rank's shard.  The sharded step
(``train_step.make_fsdp_train_step``) all-gathers each sharded weight
over ``fsdp`` at use (``gather_params``, an autograd Function whose
backward reduce-scatters the gradient onto the shard) and
``reduce_grads`` finishes with a shard-sized all-reduce over ``data``:
no all-reduce of a whole gradient leaf anywhere.  ``fsdp=1`` is plain
data parallelism through the same code (every leaf replicates; the
gather is the identity).  The JAX module's remat knob has no counterpart:
the gathered weights are saved for the backward.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.launch.mesh import (
    TRAIN_AXES, Mesh, current_mesh, fsdp_leaf_dim)

# FCCO leaves sharded by sample ownership (their ndim >= 1 leaves)
_SAMPLE_KEYS = ("u1", "u2", "tau1", "tau2", "tau_opt")


# ---------------------------------------------------------------------------
# Collectives over mesh axes (the counterparts of psum / all_gather /
# psum_scatter inside a shard_map)
# ---------------------------------------------------------------------------

def _group(ax: str, mesh: Optional[Mesh] = None):
    return (mesh or current_mesh()).groups[ax]


def all_gather_dim(x: torch.Tensor, ax: str, dim: int = 0,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Tiled all-gather of ``x`` over mesh axis ``ax`` along ``dim``
    (rank order of the axis); the identity on a size-1 axis."""
    import torch.distributed as dist
    g = _group(ax, mesh)
    if g is None:
        return x
    n = dist.get_world_size(g)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xm, group=g)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, ax: str, dim: int = 0,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over mesh axis ``ax``, scattered along ``dim``: this rank
    keeps its block (the transpose of ``all_gather_dim``)."""
    import torch.distributed as dist
    g = _group(ax, mesh)
    if g is None:
        return x
    n = dist.get_world_size(g)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=g)
    return out.movedim(0, dim)


def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
         ) -> torch.Tensor:
    """All-reduce (sum) over each of ``axes`` in turn; returns a new
    tensor (the input is left as it was)."""
    import torch.distributed as dist
    out = x.clone()
    for ax in axes:
        g = _group(ax, mesh)
        if g is not None:
            dist.all_reduce(out, group=g)
    return out


def staged_psum(x: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Hierarchical all-reduce: over ``fsdp`` first, then over ``data``
    (the order of the sharded path's reduce-scatter then data-reduce, so
    replicated and sharded layouts reduce in the same tree)."""
    return psum(x, ("fsdp", "data"), mesh)


# ---------------------------------------------------------------------------
# Layout of every leaf of the train state
# ---------------------------------------------------------------------------

def param_fsdp_dims(params_like, size: int) -> Dict[str, Optional[int]]:
    """{JAX path: the dim the leaf ZeRO-shards over ``fsdp``, or None}
    for a params tree in the JAX layout (nested or flat; leaves with a
    ``.shape``).  Also the all-gather dim in the forward and the
    reduce-scatter dim of its gradient."""
    return {path: fsdp_leaf_dim(path, tuple(leaf.shape), size)
            for path, leaf in flatten(params_like).items()}


def leaf_layouts(state_like, size: int, param_dims=None):
    """{flat path: ("fsdp", dim) | ("sample",) | None (replicated)} for a
    whole train-state tree (JAX layout).  ``param_dims`` overrides the
    params' dims (all None: replicated params on the same mesh, the
    parity oracle of the sharded step)."""
    if param_dims is None:
        param_dims = param_fsdp_dims(state_like["params"], size)
    out = {}
    for path, leaf in flatten(state_like).items():
        top, _, rest = path.partition("/")
        lay = None
        if top == "params":
            d = param_dims[rest]
            lay = None if d is None else ("fsdp", d)
        elif top == "opt" and rest.split("/")[0] in ("m", "v"):
            d = param_dims[rest.partition("/")[2]]
            lay = None if d is None else ("fsdp", d)
        elif (top == "fc" and rest.split("/")[0] in _SAMPLE_KEYS
              and len(leaf.shape) >= 1):
            lay = ("sample",)
        out[path] = lay
    return out


def _local_block(x, lay, mesh: Mesh):
    if lay is None:
        return x
    if lay[0] == "sample":
        k = mesh.world_size
        n = x.shape[0] // k
        return x[mesh.rank * n:(mesh.rank + 1) * n]
    dim = lay[1]
    n = x.shape[dim] // mesh.fsdp
    return x.narrow(dim, mesh.axis_index("fsdp") * n, n)


def _regroup(flat: Dict[str, torch.Tensor]):
    """Flat state paths -> the rank-state structure: nested dicts, with
    the params (and the optimizer moments of them) as flat dicts keyed
    by their JAX paths."""
    params = {p[len("params/"):]: v for p, v in flat.items()
              if p.startswith("params/")}
    opt, rest = {}, {}
    for p, v in flat.items():
        parts = p.split("/")
        if parts[0] == "opt" and parts[1] in ("m", "v"):
            opt.setdefault(parts[1], {})["/".join(parts[2:])] = v
        elif parts[0] != "params":
            rest[p] = v
    state = unflatten(rest)
    state["params"] = params
    state.setdefault("opt", {}).update(opt)
    return state


def shard_train_state(tree, mesh: Mesh, param_dims=None):
    """This rank's shards of a full train state (the JAX-layout tree:
    numpy arrays or tensors, e.g. ``bridge.state_to_tree`` of a seeded
    init or a merged checkpoint restore), copied to ``mesh.device``.
    Every rank must pass the same full state."""
    lays = leaf_layouts(tree, mesh.fsdp, param_dims)
    flat = {}
    for path, leaf in flatten(tree).items():
        t = (leaf if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.array(leaf)))
        flat[path] = _local_block(t, lays[path], mesh).to(
            mesh.device).clone(memory_format=torch.contiguous_format)
    return _regroup(flat)


def gather_train_state(state, mesh: Mesh, param_dims):
    """The full train state (JAX-layout nested tree of tensors on
    ``mesh.device``) from every rank's shards; ``param_dims`` is the
    layout the state was sharded with.  A collective: every rank calls
    it and gets the same values."""
    lays = leaf_layouts(state, mesh.fsdp, param_dims)
    out = {}
    for path, leaf in flatten(state).items():
        lay = lays[path]
        if lay is None:
            out[path] = leaf
        elif lay[0] == "sample":
            out[path] = gather_axes(leaf, TRAIN_AXES, mesh)
        else:
            out[path] = all_gather_dim(leaf, "fsdp", lay[1], mesh)
    return unflatten(out)


def gather_axes(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Tiled all-gather of row blocks over possibly several mesh axes:
    the sample-owned state, the loss engine's feature columns and the
    eval engine's similarity columns alike (both sides of the
    rectangular contract shard identically).  The loop runs *last axis
    first*, so the rows land in first-axis-major order: exactly
    ``distributed._global_index`` and the loader's shard order (looping
    in axis order would misalign ``row_offset`` on any two-axis
    mesh)."""
    for ax in reversed(tuple(axes)):
        x = all_gather_dim(x, ax, 0, mesh)
    return x


def full_params(shards: Dict[str, torch.Tensor], dims, mesh=None
                ) -> Dict[str, torch.Tensor]:
    """The whole params (flat JAX paths) from this rank's shards, with
    no autograd (eval, checkpoints)."""
    return {p: (x if dims[p] is None
                else all_gather_dim(x, "fsdp", dims[p], mesh))
            for p, x in shards.items()}


# ---------------------------------------------------------------------------
# The step's collectives with autograd
# ---------------------------------------------------------------------------

class _GatherParam(torch.autograd.Function):
    """Forward: all-gather over ``fsdp`` along ``dim``.  Backward: the
    gradient reduce-scattered (summed over ``fsdp``) onto this shard."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return all_gather_dim(x, "fsdp", dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, "fsdp", ctx.dim), None


def gather_params(param_shards: Dict[str, torch.Tensor], dims
                  ) -> Dict[str, torch.Tensor]:
    """Every fsdp-sharded leaf all-gathered back to its full shape at its
    use site (tiled along the leaf's shard dim: the exact inverse of the
    shard layout).  Differentiating through the gather reduce-scatters
    the cotangent onto the local shard: the backward's param-gradient
    reduction."""
    return {p: (x if dims[p] is None else _GatherParam.apply(x, dims[p]))
            for p, x in param_shards.items()}


def reduce_grads(grads: Dict[str, torch.Tensor], dims, mesh=None):
    """Finish the gradient reduction for the local shard: leaves whose
    gather backward already reduce-scattered over ``fsdp`` need only the
    shard-sized all-reduce over ``data``; replicated leaves take
    ``staged_psum`` (fsdp first, then data), the same reduction tree as
    the scattered path."""
    return {p: (staged_psum(g, mesh) if dims[p] is None
                else psum(g, ("data",), mesh))
            for p, g in grads.items()}


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def per_device_bytes(tree) -> int:
    """Bytes of ``tree``'s tensors on this rank: the live-buffer view of
    the 1/fsdp shrink."""
    return sum(int(v.numel()) * v.element_size()
               for v in flatten(tree).values()
               if isinstance(v, torch.Tensor))
