"""Circuit breaker over the batcher's compute path.

State machine: CLOSED --(fail_threshold consecutive batch failures)-->
OPEN --(reset_timeout elapses)--> HALF_OPEN --(``probes`` consecutive
probe successes)--> CLOSED, or --(any probe failure)--> OPEN with a
fresh timer.

Two read points with different mutation rights:

  * ``allow()`` — called by the **batcher** before computing a batch.
    In HALF_OPEN it consumes one of the limited probe slots, so only
    the component that will actually report an outcome may call it.
  * ``fail_fast()`` — called at **admission**.  Never mutates: it
    reports whether a request arriving now would find compute down, so
    the engine can shed (or serve from cache) without stealing probe
    slots from the batcher and wedging the half-open recovery.
"""
from __future__ import annotations

import threading
import time

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(self, fail_threshold: int = 3, reset_timeout: float = 1.0,
                 probes: int = 1, clock=time.monotonic):
        if fail_threshold < 1 or probes < 1:
            raise ValueError("fail_threshold and probes must be >= 1")
        self._lock = threading.Lock()
        self._clock = clock
        self.fail_threshold = fail_threshold
        self.reset_timeout = float(reset_timeout)
        self.probes = probes
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_inflight = 0
        self._probe_successes = 0
        self.transitions = {"opened": 0, "half_opened": 0, "closed": 0}

    # -- internal: OPEN -> HALF_OPEN promotion on timer (lock held) --
    def _maybe_half_open(self):
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._state = HALF_OPEN
            self._probes_inflight = 0
            self._probe_successes = 0
            self.transitions["half_opened"] += 1

    def _trip(self):
        self._state = OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._probes_inflight = 0
        self._probe_successes = 0
        self.transitions["opened"] += 1

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def fail_fast(self) -> bool:
        """Non-mutating admission check: True when a request arriving
        now should not count on fresh compute (OPEN, or HALF_OPEN with
        every probe slot taken)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == OPEN:
                return True
            if self._state == HALF_OPEN:
                return self._probes_inflight >= self.probes
            return False

    def allow(self) -> bool:
        """Batcher-side gate: may this batch be computed?  Consumes a
        probe slot in HALF_OPEN; the batcher MUST follow up with
        ``record_success``/``record_failure``."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes_inflight < self.probes:
                self._probes_inflight += 1
                return True
            return False

    def record_success(self):
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes_inflight -= 1
                self._probe_successes += 1
                if self._probe_successes >= self.probes:
                    self._state = CLOSED
                    self._consecutive_failures = 0
                    self.transitions["closed"] += 1
            else:
                self._consecutive_failures = 0

    def record_failure(self):
        with self._lock:
            if self._state == HALF_OPEN:
                self._trip()
            elif self._state == CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.fail_threshold:
                    self._trip()
