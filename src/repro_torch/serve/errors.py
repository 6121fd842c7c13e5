"""Typed request outcomes for the serving engine.

The serving contract (``repro_torch.serve.engine``) is that every submitted
request terminates in exactly one of two ways: a ``ServeResult`` whose
embedding is bit-exact (fresh compute or a digest-verified cache hit),
or a ``ServeRejection`` subclass whose ``code`` says *why* — never a
wrong answer, never a silent drop.  The three rejection codes:

    OVERLOADED   the bounded admission queue is full — backpressure;
                 the client should retry with its own backoff
    DEADLINE     the request's deadline cannot be met (at admission,
                 from the queue-depth x service-time estimate, or in
                 the batcher when the deadline expired while queued) —
                 shed *before* burning compute
    UNAVAILABLE  compute is down (circuit breaker open, non-finite
                 batches exhausted the retry budget, or the server is
                 shutting down) and no cached result exists

``NonFiniteEmbedding`` is the internal *retryable* compute fault: the
on-device finiteness flag came back False.  It never reaches a client
directly — it either retries into a success or is wrapped in
``Unavailable`` (with the original error as ``__cause__``) when the
retry budget runs out.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


class ServeRejection(Exception):
    """Base of all typed rejections; ``code`` is the wire-level tag."""
    code = "UNAVAILABLE"


class Overloaded(ServeRejection):
    code = "OVERLOADED"


class DeadlineExceeded(ServeRejection):
    code = "DEADLINE"


class Unavailable(ServeRejection):
    code = "UNAVAILABLE"


class NonFiniteEmbedding(Exception):
    """Retryable transient compute fault (on-device all-finite flag False)."""


@dataclasses.dataclass
class ServeResult:
    """One completed response.  ``path`` says which mechanism served it
    (``"compute"`` — fresh forward — or ``"cache"`` — a digest-verified
    content-hash hit, bitwise equal to fresh compute under
    ``params_step``); ``params_step`` is the checkpoint step of the
    params that produced the bytes (hot reload swaps it atomically)."""
    embedding: np.ndarray
    path: str
    params_step: int
    attempts: int = 1
    latency: float = 0.0


def content_hash(payload: dict) -> str:
    """Deterministic content hash of a request payload (dict of
    per-sample arrays): blake2b over sorted (key, dtype, shape, raw
    bytes).  Two payloads share a hash iff they are bitwise-identical
    inputs, which is what lets the cache promise bit-exact responses."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(payload):
        a = np.ascontiguousarray(payload[key])
        h.update(key.encode())
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()
