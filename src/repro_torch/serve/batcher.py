"""Pad-to-bucket micro-batch compute over the serve encode function.

Every micro-batch is padded up to the smallest power-of-two bucket that
fits, so a server with ``max_batch=8`` only ever runs the shapes {1, 2,
4, 8}.  Padding repeats row 0 and the padded rows are sliced off before
results fan back out.  Each bucket goes to the server's device with one
host-to-device copy per payload field, and its embeddings come back with
one device-to-host copy (plus the one-element finiteness flag).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.eval.extraction import make_serve_encode_fn
from repro_torch.serve.errors import NonFiniteEmbedding


def bucket_sizes(max_batch: int) -> List[int]:
    """Powers of two up to and including max_batch (itself appended if
    not a power of two)."""
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def pick_bucket(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


def stack_pad(payloads: List[Dict], bucket: int) -> Dict:
    """Stack per-sample payload dicts into one (bucket, ...) batch,
    padding by repeating sample 0."""
    keys = payloads[0].keys()
    out = {}
    for k in keys:
        rows = [np.asarray(p[k]) for p in payloads]
        rows += [rows[0]] * (bucket - len(rows))
        out[k] = np.stack(rows)
    return out


class BucketCompute:
    """Callable (params, payloads) -> (embeddings (n, E) f32 host, ok).

    ``poison=True`` is the chaos hook: it NaNs one input row after
    stacking, a transient fault the finiteness guard must catch."""

    def __init__(self, encode_fn: Callable, max_batch: int,
                 device: torch.device):
        self.buckets = bucket_sizes(max_batch)
        self.device = device
        self._fn = make_serve_encode_fn(encode_fn)

    def __call__(self, params, payloads: List[Dict], *,
                 poison: bool = False) -> Tuple[np.ndarray, bool]:
        n = len(payloads)
        bucket = pick_bucket(n, self.buckets)
        batch = stack_pad(payloads, bucket)
        if poison:
            for k, v in batch.items():
                if np.issubdtype(v.dtype, np.floating):
                    v = v.copy()
                    v[0] = np.nan
                    batch[k] = v
                    break
        dev = {k: torch.from_numpy(v).to(self.device)
               for k, v in batch.items()}
        e, ok = self._fn(params, dev)
        if not bool(ok):
            raise NonFiniteEmbedding(
                f"non-finite embeddings in bucket of {bucket}")
        return e[:n].cpu().numpy(), True
