"""Params bridge between the JAX package's params tree and the port's
modules.

The JAX params are a nested dict keyed by the checkpoint paths
(``vision/blocks/attn/wq``, ``text_blocks/n1/scale``, ...), and each layer
stack holds one array with a leading layer axis.  The port's modules
name their parameters the same way, with a stack as an ``nn.ModuleList``
(``vision.blocks.3.attn.wq``).  ``model_to_tree`` stacks the layers back
into the JAX form and ``load_tree`` splits them; both copy values bit for
bit (weights keep the JAX (in, out) layout).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.checkpoint import flatten, unflatten


def _stacks(model: nn.Module):
    return [name for name, m in model.named_modules()
            if isinstance(m, nn.ModuleList)]


def model_to_tree(model: nn.Module) -> Dict[str, Any]:
    """Nested dict of tensors in the JAX params layout (layer stacks
    stacked along a new leading axis).  Tensors stay on the model's
    device; stacks are new tensors, other leaves are the parameters."""
    stacks = _stacks(model)
    flat: Dict[str, Any] = {}
    per_stack: Dict[str, Dict[str, list]] = {s: {} for s in stacks}
    for name, p in model.named_parameters():
        stack = next((s for s in stacks if name.startswith(s + ".")), None)
        if stack is None:
            flat[name.replace(".", "/")] = p.detach()
            continue
        _, rest = name[len(stack) + 1:].split(".", 1)   # drop layer index
        per_stack[stack].setdefault(rest, []).append(p.detach())
    for stack, leaves in per_stack.items():
        for rest, layers in leaves.items():
            flat[f"{stack}.{rest}".replace(".", "/")] = torch.stack(layers)
    return unflatten(flat)


def load_tree(model: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a JAX-layout params tree (numpy arrays or tensors) into
    ``model`` in place; every parameter must be covered exactly once."""
    stacks = _stacks(model)
    state: Dict[str, Any] = {}
    for path, arr in flatten(tree).items():
        dotted = path.replace("/", ".")
        stack = next((s for s in stacks if dotted.startswith(s + ".")), None)
        if isinstance(arr, torch.Tensor):
            t = arr
        else:
            a = np.asarray(arr)
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
        if stack is None:
            state[dotted] = t
            continue
        rest = dotted[len(stack) + 1:]
        for i in range(t.shape[0]):
            state[f"{stack}.{i}.{rest}"] = t[i]
    model.load_state_dict(state, strict=True)
    return model
