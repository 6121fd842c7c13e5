"""Non-finite guards (port of ``repro.resilience.guard``; only
``all_finite`` so far, used by the serving engine)."""
from __future__ import annotations

import torch


def all_finite(x: torch.Tensor) -> torch.Tensor:
    """The all-finite flag of ``x`` as a 0-dim bool tensor on its device:
    computing it does not wait for the device, and the caller reads it
    once (``bool(flag)``) where the host needs it."""
    return torch.isfinite(x).all()
