"""Step builders of the LM backbones (port of ``repro.launch.steps``).

    make_lm_train_step(cfg, ...)  -> (train_step(state, batch), optimizer)
        the next-token objective: ``backbones.lm_loss``, autograd, AdamW
        under ``lr_warmup_cosine(lr, 500, total_steps)``
    init_lm_train_state(cfg, gen, opt, device)
        -> {"params": model, "opt": moments, "step": 0}
    make_prefill_step(cfg, impl)  -> prefill_step(model, batch)
        forward, last-position logits (B, 1, V)
    make_serve_step(cfg, shape)   -> serve_step(model, state, token, pos)
        one token through the KV caches and SSM states

Prefill and decode run under ``torch.inference_mode``; the LM train step
under autograd, where ``forward_hidden`` recomputes in the backward (the
hybrid's, the vlm's and the audio model's layers and the xLSTM's mLSTM
blocks one by one, the dense and MoE stacks in JAX's groups); its
metrics are ``lm_loss``'s: ``ce`` and, for the MoE LMs, ``moe_lb`` and
``moe_z``.  The vlm's batch
carries ``image_embeds`` and the audio's ``frames`` (the JAX tests'
stub inputs) beside ``tokens`` and ``labels``.  ``impl="flash"``, the
default, is the path through the hand-written kernels (K3 in every
dense layer, in the hybrid's shared attention block, in every attention
block of the MoE LMs and in every self- and cross-attention of the vlm
and the audio model, K4 in every Mamba2 layer; the xLSTM runs none);
``"chunked"``/``"naive"`` are the plain PyTorch
paths (the JAX package's default is ``"chunked"``).  ``donated_jit`` has
no counterpart (PyTorch runs eagerly; the LM step updates the model's
parameters in place), nor has ``make_contrastive_train_step``: the
contrastive step of an LM backbone is ``core.train_step.make_train_step``
on the launcher's ``TrainStepConfig``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import train_step as TS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.models import backbones as BB
from repro_torch.models.precision import get_precision
from repro_torch.optim import adamw

LONG_WINDOW = 8192          # sliding window for long_500k on attention archs


def needs_window_override(cfg: ArchConfig, shape: InputShape) -> bool:
    """long_500k on archs with quadratic attention -> sliding window."""
    return (shape.name == "long_500k"
            and cfg.family in ("dense", "moe", "vlm", "audio")
            and not cfg.sliding_window)


def decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    return LONG_WINDOW if needs_window_override(cfg, shape) else None


def init_lm_train_state(cfg: ArchConfig, gen: torch.Generator, opt,
                        device=None):
    """The LM train state on ``device`` (default: the card): random
    params from ``gen``, the optimizer's moments and the step count."""
    device = D.resolve(device)
    model = BB.init_params(cfg, gen, device)
    return {"params": model,
            "opt": opt.init({k: p.detach()
                             for k, p in model.named_parameters()}),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_lm_train_step(cfg: ArchConfig, *, lr=1e-4, wd=0.1,
                       total_steps=10_000, impl="flash", precision=None,
                       device=None):
    """``train_step(state, batch) -> (state, {"loss", "ce", ...})`` on
    ``device`` (default: the card), and its optimizer.  A parameter the
    loss does not reach (``ctr_proj``, ``pair_proj``) has a zero
    gradient, as under ``jax.grad``; the model's parameters are updated
    in place, every other leaf of the returned state is new."""
    opt = adamw()
    lr_fn = lr_warmup_cosine(lr, 500, total_steps)
    prec = get_precision(precision or cfg.precision)
    device = D.resolve(device)

    def train_step(state, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        model = state["params"]
        params = {k: p.detach() for k, p in model.named_parameters()}
        with torch.enable_grad():
            loss, metrics = BB.lm_loss(model, cfg, batch, impl=impl,
                                       precision=prec)
            grads = TS.param_grads(loss, model)
        new_params, opt_state = opt.update(params, grads, state["opt"],
                                           lr=lr_fn(state["step"]), wd=wd)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(new_params[k])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return ({"params": model, "opt": opt_state,
                 "step": state["step"] + 1},
                {"loss": loss.detach(), **metrics})

    return train_step, opt


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
