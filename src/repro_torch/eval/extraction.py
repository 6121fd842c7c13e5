"""Embedding extraction for serving (port of
``repro.eval.extraction.make_serve_encode_fn``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import losses as LS
from repro_torch.resilience import guard


def make_serve_encode_fn(encode_fn: Callable) -> Callable:
    """Single-tower encode for the serving engine: encode + f32 L2
    normalisation + an all-finite flag over the normalised embeddings,
    all on the device under ``torch.inference_mode``.  The flag is what
    turns a NaN batch into a typed retryable error on the host instead of
    a silently wrong embedding.

    encode_fn: (params, batch) -> (b, E) unnormalised.  Returns
    (params, batch) -> (e_normalised, ok) with ``ok`` a 0-dim bool
    tensor."""

    def fwd(params, batch):
        with torch.inference_mode():
            e = LS.l2_normalize(encode_fn(params, batch))
            return e, guard.all_finite(e)
    return fwd
