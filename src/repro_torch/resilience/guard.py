"""Non-finite guards (port of ``repro.resilience.guard``, the device
half): ``all_finite`` (also used by the serving engine), and the train
step's ``step_ok`` / ``select_state`` / ``grad_nonfinite_rate``.

A rejected step is a **bitwise no-op**: ``select_state`` picks, leaf by
leaf with ``torch.where`` on the device, the old tensor's bytes wherever
the predicate is False, so params, optimizer moments, the FCCO log-u
buffers, the taus and every counter come out as they went in, and no
host sync is needed to decide.  The host-side ``SpikeDetector`` and the
launcher's rollback come with the resilience slice of the port.
"""
from __future__ import annotations

import torch


def all_finite(x: torch.Tensor) -> torch.Tensor:
    """The all-finite flag of ``x`` as a 0-dim bool tensor on its device:
    computing it does not wait for the device, and the caller reads it
    once (``bool(flag)``) where the host needs it."""
    return torch.isfinite(x).all()


def step_ok(loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
    """True iff the step loss and the global gradient norm are finite."""
    return torch.isfinite(loss).all() & torch.isfinite(grad_norm).all()


def select_state(ok: torch.Tensor, old_state, new_state):
    """Per-leaf ``torch.where(ok, new, old)`` over nested dicts of
    tensors (the same structure on both sides)."""
    if isinstance(new_state, dict):
        return {k: select_state(ok, old_state[k], v)
                for k, v in new_state.items()}
    return torch.where(ok, new_state, old_state)


def grad_nonfinite_rate(grads) -> torch.Tensor:
    """Fraction of non-finite gradient elements over the tree (a dict of
    tensors)."""
    leaves = list(grads.values())
    bad = sum(torch.sum(~torch.isfinite(g.float())) for g in leaves)
    total = sum(g.numel() for g in leaves)
    return torch.as_tensor(bad, dtype=torch.float32) / max(total, 1)
