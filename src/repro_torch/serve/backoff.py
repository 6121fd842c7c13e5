"""Retry with exponential backoff and deterministic jitter.

The batcher wraps each micro-batch compute in ``retry_call``: a
transient fault (non-finite embeddings, i.e. ``NonFiniteEmbedding``)
sleeps an exponentially growing, jittered delay and retries; anything
else — or running out of budget — re-raises the *original* error so the
caller (and ultimately the client) sees the typed root cause, not the
last retry's wrapper.

Jitter is multiplicative-positive (``delay * (1 + jitter*u)``, u ~
U[0,1) from the caller's seeded Generator), so below the cap the
schedule is strictly monotone as long as ``factor >= 1 + jitter`` —
enforced at construction; at the cap consecutive delays may reorder
within the jitter band, which is why ``max_total`` is the bound tests
rely on, not per-step ordering.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 2          # retries *after* the first attempt
    base: float = 0.01            # first delay, seconds
    factor: float = 2.0           # exponential growth per retry
    cap: float = 0.25             # per-delay ceiling (pre-jitter)
    jitter: float = 0.5           # u ~ U[0,1): delay *= 1 + jitter*u

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base <= 0 or self.factor < 1 or self.cap < self.base:
            raise ValueError("need base > 0, factor >= 1, cap >= base")
        if not 0 <= self.jitter or self.factor < 1 + self.jitter:
            raise ValueError(
                "need 0 <= jitter and factor >= 1 + jitter "
                "(monotone schedule below the cap)")

    def delays(self, rng: np.random.Generator) -> Iterator[float]:
        """The jittered delay before retry i, i in [0, max_retries)."""
        for i in range(self.max_retries):
            d = min(self.cap, self.base * self.factor ** i)
            yield d * (1.0 + self.jitter * float(rng.random()))

    def max_total(self) -> float:
        """Upper bound on total sleep across the whole budget."""
        return sum(min(self.cap, self.base * self.factor ** i)
                   * (1.0 + self.jitter)
                   for i in range(self.max_retries))


def retry_call(fn: Callable, policy: RetryPolicy,
               rng: np.random.Generator, *,
               sleep: Callable[[float], None],
               retryable: tuple) -> Tuple[object, int]:
    """Call ``fn(attempt)`` with up to ``policy.max_retries`` retries on
    ``retryable`` exceptions.  Returns (result, attempts).  When the
    budget is exhausted the **first** captured error is re-raised (the
    root cause; later attempts' errors are usually echoes of it)."""
    first_err = None
    delays = policy.delays(rng)
    for attempt in range(policy.max_retries + 1):
        try:
            return fn(attempt), attempt + 1
        except retryable as e:  # noqa: PERF203 - retry loop
            if first_err is None:
                first_err = e
            if attempt >= policy.max_retries:
                raise first_err
            sleep(next(delays))
    raise first_err  # pragma: no cover - loop always returns or raises
