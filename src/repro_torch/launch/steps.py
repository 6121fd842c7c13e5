"""Step builders of the hybrid LM's inference path (port of the prefill
and serve builders of ``repro.launch.steps``).

    make_prefill_step(cfg, impl)  -> prefill_step(model, batch)
        forward, last-position logits (B, 1, V)
    make_serve_step(cfg, shape)   -> serve_step(model, state, token, pos)
        one token through the KV caches and SSM states

Both run under ``torch.inference_mode``.  ``impl="flash"``, the default,
is the path through the hand-written kernels (K3 in the shared attention
block, K4 in every Mamba2 layer); ``"chunked"``/``"naive"`` are the plain
PyTorch paths (the JAX package's default is ``"chunked"``).
``donated_jit`` has no counterpart (PyTorch runs eagerly) and the LM
train step waits for the training slice of the hybrid family.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import backbones as BB

LONG_WINDOW = 8192          # sliding window for long_500k on attention archs


def needs_window_override(cfg: ArchConfig, shape: InputShape) -> bool:
    """long_500k on archs with quadratic attention -> sliding window."""
    return (shape.name == "long_500k"
            and cfg.family in ("dense", "moe", "vlm", "audio")
            and not cfg.sliding_window)


def decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    return LONG_WINDOW if needs_window_override(cfg, shape) else None


def make_prefill_step(cfg: ArchConfig, *, impl="flash"):
    def prefill_step(model, batch):
        with torch.inference_mode():
            return BB.prefill_logits(model, cfg, batch, impl=impl)
    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: InputShape):
    wo = decode_window(cfg, shape)

    def serve_step(model, state, token, pos):
        with torch.inference_mode():
            return BB.decode_step(model, cfg, state, token, pos,
                                  window_override=wo)
    return serve_step
