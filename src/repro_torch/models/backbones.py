"""Backbone assembly (port of the CLIP branch of
``repro.models.backbones``): ``init_params``, ``param_shapes``,
``params_from_tree`` and ``encode_pair``.  The port's "params" are the
``CLIP`` module; the JAX-layout tree is its checkpoint form (see
``checkpoint.bridge``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as D
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.models import clip as C
from repro_torch.models import precision as PR


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "clip":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (only clip)")


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device=None) -> C.CLIP:
    """Random params from a seeded (CPU) generator, moved to ``device``
    (default: the card; see ``repro_torch.device.resolve``)."""
    _check_family(cfg)
    device = D.resolve(device)
    return C.init_clip(cfg, gen).to(device)


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The JAX-layout params tree as ``meta`` tensors (shapes only, no
    allocation), the ``tree_like`` of a checkpoint restore."""
    _check_family(cfg)
    with torch.device("meta"):
        return bridge.model_to_tree(C.CLIP(cfg))


def params_from_tree(cfg: ArchConfig, tree: Dict[str, Any],
                     device=None) -> C.CLIP:
    """A model on ``device`` (default: the card) holding a restored
    JAX-layout params tree."""
    _check_family(cfg)
    device = D.resolve(device)
    with torch.device("meta"):
        model = C.CLIP(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        bridge.load_tree(model, tree)
    return model


def encode_pair(model: C.CLIP, cfg: ArchConfig, batch, *, impl="flash",
                precision=PR.F32):
    _check_family(cfg)
    return C.encode_pair(model, batch, impl=impl, precision=precision)
