"""Embedding extraction over an eval split, and the serving encode
(port of ``repro.eval.extraction``).

Reuses the tower fast path end to end: the caller supplies an
``encode_pair_fn(params, batch)`` built on ``backbones.encode_pair`` with
the training-consistent ``impl`` (the flash-attention kernel) and
``precision`` knobs; extraction runs it under ``torch.inference_mode``
and streams host batches through ``data.pipeline.DevicePrefetcher``, so
batch assembly and the host-to-device copy overlap the tower forward.

Ragged tail contract: the last batch is padded up to ``batch_size`` by
repeating index 0; the padded rows are computed and *discarded* before
concatenation, so the returned arrays are exactly (n, E) and padding can
never leak into metrics.

On the (data, fsdp) mesh the params are a rank's shards:
``sharded_params`` gathers them over ``fsdp`` on the device (never
through the host) into the model the extraction runs, the counterpart
of the JAX jit consuming the training layout.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import losses as LS
from repro_torch.data.pipeline import DevicePrefetcher
from repro_torch.resilience import guard


def extract_pair_embeddings(encode_pair_fn: Callable, params, dataset, *,
                            batch_size: int = 64, prefetch: int = 2,
                            device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Run the two towers over the whole split on ``device`` (default:
    the card).

    encode_pair_fn: (params, batch) -> (e1, e2) unnormalised; dataset:
    ``.n`` + ``.batch(idx)``.  Returns (e1n, e2n) host f32 (n, E),
    L2-normalised in f32 under any tower precision policy.  (The JAX
    signature's ``jit_fn``, a compiled forward shared across calls, has
    no counterpart: nothing here is compiled.)"""
    dev = D.resolve(device)
    n = int(dataset.n)
    batch_size = min(batch_size, n)
    fn = make_extract_fn(encode_pair_fn)

    def host_batches():
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            valid = len(idx)
            if valid < batch_size:
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - valid, idx.dtype)])
            yield valid, dataset.batch(idx)

    def to_device(item):
        valid, batch = item
        return valid, {k: _put(np.ascontiguousarray(v), dev)
                       for k, v in batch.items()}

    stream = (DevicePrefetcher(host_batches(), depth=prefetch,
                               transform=to_device)
              if prefetch > 0 else map(to_device, host_batches()))
    outs1, outs2 = [], []
    try:
        for valid, batch in stream:
            e1n, e2n = fn(params, batch)
            outs1.append(e1n[:valid].cpu().numpy())
            outs2.append(e2n[:valid].cpu().numpy())
    finally:
        if isinstance(stream, DevicePrefetcher):
            stream.close()
    return np.concatenate(outs1), np.concatenate(outs2)


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> ``dev``; to the card through pinned memory with a
    non-blocking copy."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def sharded_params(cfg, shards, param_dims, mesh=None, device=None):
    """The model whose weights are a rank's param shards (flat JAX paths)
    gathered over ``fsdp`` on the device: a collective, every rank of
    the fsdp row calls it."""
    from repro_torch.checkpoint import unflatten
    from repro_torch.core import shard_state as SS
    from repro_torch.models import backbones as BB
    full = SS.full_params({k: v.detach() for k, v in shards.items()},
                          param_dims, mesh)
    dev = next(iter(full.values())).device if device is None else device
    return BB.params_from_tree(cfg, unflatten(full), dev)


def make_extract_fn(encode_pair_fn: Callable) -> Callable:
    """The tower pair forward + f32 L2 normalisation under
    ``torch.inference_mode``: (params, batch) -> (e1n, e2n)."""
    def fwd(params, batch):
        with torch.inference_mode():
            e1, e2 = encode_pair_fn(params, batch)
            return LS.l2_normalize(e1), LS.l2_normalize(e2)
    return fwd


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
