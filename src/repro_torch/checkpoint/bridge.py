"""Params bridge between the JAX package's params tree and the port's
modules.

The JAX params are a nested dict keyed by the checkpoint paths
(``vision/blocks/attn/wq``, ``text_blocks/n1/scale``, ...), and each layer
stack holds one array with a leading layer axis.  The port's modules
name their parameters the same way, with a stack as an ``nn.ModuleList``
(``vision.blocks.3.attn.wq``); a stack of stacks, such as the hybrid
LM's ``supers.2.mambas.4.w_in``, is one JAX array with two leading axes
(``supers/mambas/w_in``).  A ``layers.BlockList`` (a ResNet stage) is
not a stack: the JAX tree holds it as a list, each block under its index
(``vision/stage0/1/c1``).  ``model_to_tree`` stacks the layers back
into the JAX form and ``load_tree`` splits them; both copy values bit for
bit (weights keep the JAX layout: (in, out) dense, HWIO conv).
``state_to_tree`` /
``state_from_tree`` do the same for a whole train state, optimizer
moments included, so a train state saved by either package restores in
the other.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.models.layers import BlockList


def _stacks(model: nn.Module) -> set:
    return {name for name, m in model.named_modules()
            if isinstance(m, nn.ModuleList) and not isinstance(m, BlockList)}


def _split_name(stacks: set, name: str):
    """A parameter name -> (its JAX path with the layer indices dropped,
    the tuple of those indices, outermost first).  A stack may hold
    stacks (``supers.2.mambas.4.w_in`` -> ``supers.mambas.w_in``, (2,
    4))."""
    parts = name.split(".")
    path, idx, prefix = [], [], ""
    k = 0
    while k < len(parts):
        prefix = f"{prefix}.{parts[k]}" if prefix else parts[k]
        path.append(parts[k])
        if prefix in stacks:
            k += 1
            prefix = f"{prefix}.{parts[k]}"
            idx.append(int(parts[k]))
        k += 1
    return ".".join(path), tuple(idx)


def named_to_tree(model: nn.Module, named: Dict[str, Any]) -> Dict[str, Any]:
    """Tensors keyed by ``model``'s parameter names (its parameters, or
    optimizer moments of them) -> nested dict in the JAX params layout,
    each layer stack stacked along a new leading axis (a stack of stacks
    along two), each ``BlockList`` a list."""
    stacks = _stacks(model)
    per_path: Dict[str, Dict[tuple, Any]] = {}
    for name, _ in model.named_parameters():
        path, idx = _split_name(stacks, name)
        per_path.setdefault(path, {})[idx] = named[name]
    flat: Dict[str, Any] = {}
    for path, layers in per_path.items():
        if list(layers) == [()]:
            flat[path.replace(".", "/")] = layers[()]
            continue
        dims = tuple(max(i[a] for i in layers) + 1
                     for a in range(len(next(iter(layers)))))
        if len(layers) != int(np.prod(dims)):
            raise ValueError(f"{path}: ragged stack {sorted(layers)}")
        leaves = [layers[i] for i in sorted(layers)]
        flat[path.replace(".", "/")] = torch.stack(leaves).reshape(
            *dims, *leaves[0].shape)
    return unflatten(flat)


def tree_to_named(model: nn.Module, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``named_to_tree``: a JAX-layout tree (numpy arrays
    or tensors) -> tensors keyed by ``model``'s parameter names (views of
    the tree's stacked leaves, on their own device)."""
    stacks = _stacks(model)
    named: Dict[str, Any] = {}

    def split(prefix, parts, t):
        if not parts:
            named[prefix] = t
            return
        name = f"{prefix}.{parts[0]}" if prefix else parts[0]
        if name in stacks:      # one leading axis per stack level
            for i in range(t.shape[0]):
                split(f"{name}.{i}", parts[1:], t[i])
        else:
            split(name, parts[1:], t)

    for path, arr in flatten(tree).items():
        if isinstance(arr, torch.Tensor):
            t = arr
        else:
            a = np.asarray(arr)
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
        split("", path.split("/"), t)
    return named


def model_to_tree(model: nn.Module) -> Dict[str, Any]:
    """Nested dict of tensors in the JAX params layout.  Tensors stay on
    the model's device; stacks are new tensors, other leaves are the
    parameters (detached)."""
    return named_to_tree(model, {n: p.detach()
                                 for n, p in model.named_parameters()})


def load_tree(model: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a JAX-layout params tree (numpy arrays or tensors) into
    ``model`` in place; every parameter must be covered exactly once."""
    model.load_state_dict(tree_to_named(model, tree), strict=True)
    return model


# ---------------------------------------------------------------------------
# The whole train state
# ---------------------------------------------------------------------------

def state_to_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """A train state (``core.train_step``: ``params`` the model, ``opt``
    with per-parameter moments and ``t``, ``fc``, ``step``; the LM state
    of ``launch.steps`` has no ``fc``) -> the JAX train state's tree:
    ``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/t``, ``fc/u1``,
    ``fc/tau``, ``fc/tau_opt/...``, ``step``."""
    model = state["params"]
    opt = {k: (v if k == "t" else named_to_tree(model, v))
           for k, v in state["opt"].items()}
    tree = {"params": model_to_tree(model), "opt": opt, "step": state["step"]}
    if "fc" in state:
        tree["fc"] = state["fc"]
    return tree


def state_from_tree(state: Dict[str, Any], tree: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """Load a JAX-layout train-state tree (e.g. a restored checkpoint of
    either package) into ``state``'s structure: the params go into its
    model in place, every other leaf becomes a tensor on the model's
    device with the dtype of the leaf it replaces.  Returns the new
    state dict."""
    model = state["params"]
    dev = next(model.parameters()).device
    with torch.no_grad():
        load_tree(model, tree["params"])

    def like(old, new):
        if isinstance(old, dict):
            return {k: like(old[k], new[k]) for k in old}
        t = (new if isinstance(new, torch.Tensor)
             else torch.from_numpy(np.array(new)))
        return t.to(device=dev, dtype=old.dtype)

    opt = {}
    for k, v in state["opt"].items():
        if k == "t":
            opt[k] = like(v, tree["opt"][k])
        else:
            named = tree_to_named(model, tree["opt"][k])
            opt[k] = {n: like(v[n], named[n]).contiguous() for n in v}
    out = {"params": model, "opt": opt,
           "step": like(state["step"], tree["step"])}
    if "fc" in state:
        out["fc"] = like(state["fc"], tree["fc"])
    return out
