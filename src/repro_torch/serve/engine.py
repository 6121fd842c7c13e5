"""The serving engine: admission -> micro-batching -> guarded compute.

One batcher thread owns the accelerator.  Client threads call
``submit`` (async, returns a ``Future``) or ``request`` (sync); the
batcher drains the admission queue into pad-to-bucket micro-batches and
resolves each request's future with either a bit-exact ``ServeResult``
or a typed ``ServeRejection``.  The failure-handling layers compose as:

  admission   bounded queue (Overloaded), deadline feasibility
              (DeadlineExceeded), breaker ``fail_fast`` (Unavailable or
              a cache hit) — all synchronous, all before any compute
  batcher     re-checks deadlines (shed what expired while queued),
              breaker ``allow`` gates compute, per-batch retry with
              exponential backoff turns a transient NaN into a clean
              answer, exhausted budgets trip the breaker
  cache       "{params_step}:{content_hash}" -> digest-verified bytes;
              consulted first on submit and as the degraded path when
              the breaker is open — a hit is bitwise-equal to fresh
              compute, and the response says ``path="cache"``
  reload      ``ParamsStore.snapshot`` per batch: hot reload swaps
              params between batches, never under one

``chaos`` is the fault-injection hook (``compute_delay``,
``compute_poison``, ``on_cache_put``); ``None`` in normal serving.

``close()`` is the no-silent-drop guarantee: the queue stops admitting
(new submits -> Unavailable), the batcher drains everything already
admitted, then exits; every future is resolved or rejected by then.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch import device as D
from repro_torch.serve.admission import (
    AdmissionQueue, Future, Request, ServiceTimeEstimator,
)
from repro_torch.serve.backoff import RetryPolicy, retry_call
from repro_torch.serve.batcher import BucketCompute
from repro_torch.serve.breaker import CircuitBreaker
from repro_torch.serve.cache import EmbeddingCache
from repro_torch.serve.errors import (
    DeadlineExceeded, NonFiniteEmbedding, ServeResult, Unavailable,
    content_hash,
)
from repro_torch.serve.reload import ParamsStore


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8             # largest bucket (bounds batch shapes)
    max_wait: float = 0.002        # batcher linger after first request
    queue_capacity: int = 64       # admission bound
    default_deadline: Optional[float] = None   # relative seconds
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker_failures: int = 3
    breaker_reset: float = 1.0
    breaker_probes: int = 1
    cache_capacity: int = 1024
    estimator_prior: float = 0.02
    seed: int = 0


class EmbedServer:
    def __init__(self, encode_fn: Callable, params, step: int,
                 cfg: Optional[ServeConfig] = None, *,
                 chaos=None, clock=time.monotonic, sleep=time.sleep,
                 heartbeat=None, watchdog=None, device=None):
        """``device``: where the towers run; ``None`` means the card
        (``repro_torch.device.resolve``)."""
        self.cfg = cfg = cfg or ServeConfig()
        self._clock = clock
        self._sleep = sleep
        self._chaos = chaos
        self._heartbeat = heartbeat
        self._watchdog = watchdog
        self.store = ParamsStore(params, step)
        self.estimator = ServiceTimeEstimator(prior=cfg.estimator_prior)
        self.queue = AdmissionQueue(cfg.queue_capacity, cfg.max_batch,
                                    self.estimator, clock=clock)
        self.breaker = CircuitBreaker(cfg.breaker_failures,
                                      cfg.breaker_reset,
                                      cfg.breaker_probes, clock=clock)
        self.cache = EmbeddingCache(
            cfg.cache_capacity,
            fault_hook=(chaos.on_cache_put if chaos is not None else None))
        self.compute = BucketCompute(encode_fn, cfg.max_batch,
                                     D.resolve(device))
        self._rng = np.random.default_rng(cfg.seed)
        self._n_batches = 0
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "served_compute": 0, "served_cache": 0,
                      "shed_deadline_batcher": 0, "unavailable": 0,
                      "retries": 0, "batch_failures": 0, "batches": 0}
        self._batcher_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._batcher_loop,
                                        daemon=True, name="serve-batcher")
        self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, payload: Dict, deadline: Optional[float] = None
               ) -> Future:
        """Admit one request.  ``deadline`` is relative seconds (falls
        back to cfg.default_deadline; None = no deadline).  Typed
        rejections raise *synchronously*; an accepted request always
        gets its future resolved eventually."""
        with self._lock:
            self.stats["submitted"] += 1
        key = content_hash(payload)
        fut = Future()
        # Cache first: a verified hit is bit-exact and free, and it is
        # also the graceful-degradation path while the breaker is open.
        step = self.store.step
        cached = self.cache.get(f"{step}:{key}")
        if cached is not None:
            with self._lock:
                self.stats["served_cache"] += 1
            fut.resolve(ServeResult(cached, "cache", step))
            return fut
        if self.breaker.fail_fast():
            with self._lock:
                self.stats["unavailable"] += 1
            raise Unavailable("circuit breaker open, no cached result")
        if deadline is None:
            deadline = self.cfg.default_deadline
        abs_deadline = (self._clock() + deadline
                        if deadline is not None else None)
        req = Request(payload=payload, key=key, deadline=abs_deadline,
                      future=fut)
        self.queue.offer(req)   # raises Overloaded / DeadlineExceeded
        return req.future

    def request(self, payload: Dict, deadline: Optional[float] = None,
                timeout: float = 30.0) -> ServeResult:
        return self.submit(payload, deadline).result(timeout)

    # ------------------------------------------------------------ batcher
    def _serve_degraded(self, req: Request) -> None:
        """Compute is gated off: serve from cache or reject typed."""
        step = self.store.step
        cached = self.cache.get(f"{step}:{req.key}")
        if cached is not None:
            with self._lock:
                self.stats["served_cache"] += 1
            req.future.resolve(ServeResult(cached, "cache", step))
        else:
            with self._lock:
                self.stats["unavailable"] += 1
            req.future.reject(
                Unavailable("circuit breaker open, no cached result"))

    def _process_batch(self, batch) -> None:
        now = self._clock()
        # Shed requests whose deadline can no longer be met: already
        # queued past it, or one more service time would overshoot.
        live = []
        for req in batch:
            if (req.deadline is not None
                    and now + self.estimator.value > req.deadline):
                with self._lock:
                    self.stats["shed_deadline_batcher"] += 1
                req.future.reject(DeadlineExceeded(
                    "deadline expired while queued"))
            else:
                live.append(req)
        if not live:
            return
        if not self.breaker.allow():
            for req in live:
                self._serve_degraded(req)
            return
        self._n_batches += 1
        n_batch = self._n_batches
        with self._lock:
            self.stats["batches"] += 1
        params, pstep = self.store.snapshot()
        if self._chaos is not None:
            delay = self._chaos.compute_delay(n_batch)
            if delay > 0:
                self._sleep(delay)
        payloads = [r.payload for r in live]

        def attempt_fn(attempt: int):
            poison = (attempt == 0 and self._chaos is not None
                      and self._chaos.compute_poison(n_batch))
            t0 = self._clock()
            emb, _ = self.compute(params, payloads, poison=poison)
            return emb, self._clock() - t0
        try:
            (emb, dt), attempts = retry_call(
                attempt_fn, self.cfg.retry, self._rng,
                sleep=self._sleep, retryable=(NonFiniteEmbedding,))
        except NonFiniteEmbedding as e:
            self.breaker.record_failure()
            with self._lock:
                self.stats["batch_failures"] += 1
                self.stats["unavailable"] += len(live)
            err = Unavailable(f"compute failed after retries: {e}")
            err.__cause__ = e
            for req in live:
                req.future.reject(err)
            return
        self.breaker.record_success()
        self.estimator.update(dt)
        with self._lock:
            self.stats["retries"] += attempts - 1
            self.stats["served_compute"] += len(live)
        now = self._clock()
        for i, req in enumerate(live):
            row = np.ascontiguousarray(emb[i])
            self.cache.put(f"{pstep}:{req.key}", row)
            req.future.resolve(ServeResult(
                row, "compute", pstep, attempts=attempts,
                latency=now - req.submitted))
        if self._heartbeat is not None:
            self._heartbeat.beat(n_batch)

    def _batcher_loop(self) -> None:
        try:
            while True:
                if self._watchdog is not None:
                    self._watchdog.beat()
                batch = self.queue.pop_batch(self.cfg.max_batch,
                                             self.cfg.max_wait)
                if not batch:   # closed and fully drained
                    return
                self._process_batch(batch)
        except BaseException as e:  # defensive: never strand futures
            self._batcher_error = e
            self.queue.close()
            while True:
                rest = self.queue.pop_batch(self.cfg.max_batch, 0.0)
                if not rest:
                    break
                for req in rest:
                    req.future.reject(
                        Unavailable(f"batcher crashed: {e!r}"))
            raise

    # ----------------------------------------------------------- shutdown
    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, drain every admitted request, stop the
        batcher.  After close() returns no future is left pending."""
        self.queue.close()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():   # pragma: no cover - defensive
            raise RuntimeError("batcher failed to drain before timeout")
        if self._batcher_error is not None:
            raise RuntimeError("batcher crashed") from self._batcher_error

    def snapshot_stats(self) -> Dict:
        with self._lock:
            out = dict(self.stats)
        out.update({f"queue_{k}": v for k, v in self.queue.stats.items()})
        out.update({f"cache_{k}": v for k, v in self.cache.stats.items()})
        out["breaker_transitions"] = dict(self.breaker.transitions)
        out["breaker_state"] = self.breaker.state
        out["params_step"] = self.store.step
        out["service_time_est"] = self.estimator.value
        # Conservation check inputs: every submit ends in exactly one
        # of these buckets (or raised synchronously at admission).
        out["completed"] = out["served_compute"] + out["served_cache"]
        return out
