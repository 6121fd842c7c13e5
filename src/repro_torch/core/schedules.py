"""Schedules (port of ``repro.core.schedules``): the inner LR (gamma)
schedules of Section 5 and the model LR schedule of Appendix B.  Each
returns ``fn(step)`` giving a 0-dim f32 tensor on the step's device
(``step`` an int tensor or a Python int)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def gamma_constant(gamma_value: float):
    def fn(step):
        s = _step(step)
        return torch.tensor(gamma_value, dtype=torch.float32, device=s.device)
    return fn


def gamma_cosine(gamma_min: float, steps_per_epoch: int, decay_epochs: int):
    """gamma_t = 0.5 (1 + cos(pi * epoch / E)) (1 - gamma_min) +
    gamma_min, held within an epoch, gamma_min after E epochs."""
    def fn(step):
        epoch = torch.div(_step(step), steps_per_epoch,
                          rounding_mode="floor").float()
        frac = torch.clamp_max(epoch / decay_epochs, 1.0)
        return (0.5 * (1.0 + torch.cos(math.pi * frac)) * (1.0 - gamma_min)
                + gamma_min)
    return fn


def lr_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                     min_lr: float = 0.0):
    """Linear warmup to peak, cosine decay to min_lr."""
    def fn(step):
        step = _step(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_lr + 0.5 * (1.0 + torch.cos(math.pi * frac)) * (
            peak_lr - min_lr)
        return torch.where(step < warmup_steps, warm, cos)
    return fn
