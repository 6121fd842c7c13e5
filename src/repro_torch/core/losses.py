"""Loss-layer primitives (port of ``repro.core.losses``; only
``l2_normalize`` so far, the FCCO loss comes with the training slice)."""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8
                 ) -> torch.Tensor:
    """f32 L2 normalisation, the norm clamped at ``eps``."""
    x = x.float()
    n = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp_min(n, eps)
