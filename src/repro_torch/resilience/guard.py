"""Non-finite guards (port of ``repro.resilience.guard``).  The device
half: ``all_finite`` (also used by the serving engine), and the train
step's ``step_ok`` / ``select_state`` / ``grad_nonfinite_rate``.

A rejected step is a **bitwise no-op**: ``select_state`` picks, leaf by
leaf with ``torch.where`` on the device, the old tensor's bytes wherever
the predicate is False, so params, optimizer moments, the FCCO log-u
buffers, the taus and every counter come out as they went in, and no
host sync is needed to decide.

The host half, ``SpikeDetector`` (its own copy of the JAX package's,
which imports no JAX), watches the per-step loss and skip flag and
escalates: ``rollback_after`` consecutive bad steps (skipped,
non-finite, or a spike against a robust EMA) make the launcher roll back
to its last verified checkpoint and replay the deterministic stream.
"""
from __future__ import annotations

import math

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


class SpikeDetector:
    """Host-side robust loss-spike detector with consecutive-failure
    escalation.

    ``update(loss, skipped) -> bool`` returns True when the run should
    roll back to its last checkpoint: ``rollback_after`` consecutive bad
    steps, where a step is bad when it was guard-skipped, its loss is
    non-finite, or its loss deviates from the robust EMA by more than
    ``zmax`` mean-absolute-deviations.  The EMA (mean + MAD) learns only
    from healthy steps, so a diverging run cannot drag the baseline up
    under itself; the first ``warmup`` healthy steps never flag a spike.
    ``rollback_after=0`` disables escalation (the detector still
    tracks)."""

    def __init__(self, rollback_after: int = 0, ema: float = 0.9,
                 zmax: float = 10.0, warmup: int = 10):
        assert 0.0 < ema < 1.0
        self.rollback_after = int(rollback_after)
        self.ema = float(ema)
        self.zmax = float(zmax)
        self.warmup = int(warmup)
        self.reset()

    def reset(self):
        """Forget everything: called after a rollback, so the replayed
        segment re-warms the baseline instead of re-triggering."""
        self.mean = 0.0
        self.mad = 0.0
        self.n_good = 0
        self.consecutive_bad = 0

    def update(self, loss: float, skipped: bool = False) -> bool:
        loss = float(loss)
        bad = bool(skipped) or not math.isfinite(loss)
        if not bad and self.n_good >= self.warmup:
            bad = abs(loss - self.mean) > self.zmax * max(self.mad, 1e-8)
        if bad:
            self.consecutive_bad += 1
        else:
            self.consecutive_bad = 0
            a = self.ema if self.n_good > 0 else 0.0
            self.mean = a * self.mean + (1.0 - a) * loss
            self.mad = (a * self.mad
                        + (1.0 - a) * abs(loss - self.mean))
            self.n_good += 1
        return (self.rollback_after > 0
                and self.consecutive_bad >= self.rollback_after)
