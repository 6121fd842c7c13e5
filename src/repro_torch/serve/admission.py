"""Admission control: bounded queue, typed rejection, deadline shedding.

Requests are admitted or rejected *synchronously* at ``offer`` time —
the cheapest place to say no.  Three gates, in order:

  1. server closed           -> Unavailable
  2. queue at capacity       -> Overloaded   (backpressure, bounded RAM)
  3. deadline infeasible     -> DeadlineExceeded — from the current
     queue depth and a service-time EMA: if the batches ahead of this
     request already spend past its deadline, shedding now is strictly
     better than computing an answer nobody will read.

``pop_batch`` is the batcher side: blocks for work, then fills a batch
up to ``max_size`` within ``max_wait`` of the first item — continuous
micro-batching's latency/throughput dial.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.serve.errors import (
    DeadlineExceeded, Overloaded, ServeRejection, ServeResult, Unavailable,
)


class Future:
    """Single-assignment result slot bridging client and batcher
    threads.  ``result(timeout)`` blocks; resolution is either a
    ``ServeResult`` or a ``ServeRejection`` instance to raise."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._error: Optional[ServeRejection] = None

    def resolve(self, result: ServeResult) -> None:
        self._result = result
        self._event.set()

    def reject(self, error: ServeRejection) -> None:
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class Request:
    payload: Dict                  # name -> per-sample np array
    key: str                       # content hash (cache key suffix)
    deadline: Optional[float]      # absolute clock() time, or None
    future: Future
    submitted: float = 0.0


class ServiceTimeEstimator:
    """EMA of per-batch compute time, seeded with a prior so the first
    admission decisions are sane before any batch has completed.  Only
    healthy computes update it (retries/faults would inflate the
    estimate and turn a transient fault into a shedding storm)."""

    def __init__(self, prior: float = 0.02, alpha: float = 0.2):
        self._value = float(prior)
        self._alpha = float(alpha)
        self._lock = threading.Lock()

    def update(self, dt: float) -> None:
        with self._lock:
            self._value += self._alpha * (float(dt) - self._value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class AdmissionQueue:
    def __init__(self, capacity: int, max_batch: int,
                 estimator: ServiceTimeEstimator, clock=time.monotonic):
        if capacity < 1 or max_batch < 1:
            raise ValueError("capacity and max_batch must be >= 1")
        self.capacity = capacity
        self.max_batch = max_batch
        self.estimator = estimator
        self._clock = clock
        self._queue: "deque[Request]" = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.stats = {"admitted": 0, "shed_overload": 0,
                      "shed_deadline": 0, "rejected_closed": 0}

    def offer(self, req: Request) -> None:
        """Admit or raise a typed rejection. Never blocks."""
        with self._cond:
            if self._closed:
                self.stats["rejected_closed"] += 1
                raise Unavailable("server is shutting down")
            if len(self._queue) >= self.capacity:
                self.stats["shed_overload"] += 1
                raise Overloaded(
                    f"admission queue full ({self.capacity} waiting)")
            if req.deadline is not None:
                batches_ahead = len(self._queue) // self.max_batch + 1
                eta = self._clock() + batches_ahead * self.estimator.value
                if eta > req.deadline:
                    self.stats["shed_deadline"] += 1
                    raise DeadlineExceeded(
                        f"infeasible deadline: eta {eta:.3f} > "
                        f"deadline {req.deadline:.3f}")
            req.submitted = self._clock()
            self._queue.append(req)
            self.stats["admitted"] += 1
            self._cond.notify()

    def pop_batch(self, max_size: int, max_wait: float) -> List[Request]:
        """Block until work exists (or closed), then drain up to
        ``max_size`` requests, waiting at most ``max_wait`` after the
        first for stragglers.  [] means closed-and-empty: batcher exits.
        On a closed queue remaining items are still drained, so shutdown
        never silently drops an admitted request."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return []
                self._cond.wait(timeout=0.05)
            batch = [self._queue.popleft()]
            deadline = self._clock() + max_wait
            while len(batch) < max_size:
                if self._queue:
                    batch.append(self._queue.popleft())
                    continue
                if self._closed:
                    break
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(remaining, 0.05))
            return batch

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)
