"""Liveness: heartbeat file + hung-step watchdog.

Preemptible/shared-cluster runs die in two observably different ways: the
process is killed (the checkpoint layer owns that), or it silently stalls
— a wedged collective, a deadlocked host thread, an NFS hang.  The
``Heartbeat`` makes the second kind visible from *outside* the process (a
supervisor stats one JSON file) and the ``StepWatchdog`` makes it visible
from *inside*: when no step completes for ``timeout`` seconds it dumps
every thread's stack to stderr and invokes an optional callback, without
ever killing the run itself (the supervisor owns that policy).
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
from typing import Callable, Optional


class Heartbeat:
    """Atomically rewrites ``path`` with ``{"step", "time", "pid"}``.

    ``beat(step)`` is called from the train loop once per step; writes
    are throttled to at most one per ``interval`` seconds (the final
    ``close()`` always writes) and go tmp-file + ``os.replace`` so a
    reader never sees a torn file."""

    def __init__(self, path: str, interval: float = 5.0):
        self.path = path
        self.interval = float(interval)
        self._last_write = 0.0
        self.last_step: Optional[int] = None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def _write(self, step):
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "time": time.time(),
                       "pid": os.getpid()}, f)
        os.replace(tmp, self.path)
        self._last_write = time.monotonic()

    def beat(self, step: int):
        self.last_step = int(step)
        if time.monotonic() - self._last_write >= self.interval:
            self._write(step)

    def close(self):
        if self.last_step is not None:
            self._write(self.last_step)


class StepWatchdog:
    """Daemon thread that fires when ``beat()`` goes quiet.

    The owning loop calls ``beat()`` after every completed unit of
    progress — a train step, a served micro-batch (``label`` names the
    unit in the dump message) — and if ``timeout`` seconds pass without
    one, the watchdog dumps all thread stacks (``faulthandler``) and
    calls ``on_hang(seconds_stalled)`` once per stall (re-arming when
    beats resume).  It never signals or kills anything — it exists to
    turn "the job produced no output for an hour" into an actionable
    traceback."""

    def __init__(self, timeout: float, on_hang: Optional[Callable] = None,
                 poll: float = 1.0, label: str = "step"):
        assert timeout > 0
        self.timeout = float(timeout)
        self.on_hang = on_hang
        self.label = str(label)
        self._poll = float(poll)
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self):
        self._last = time.monotonic()
        self._fired = False

    def _message(self, stalled: float) -> str:
        return (f"[watchdog] no {self.label} completed in {stalled:.0f}s; "
                "dumping thread stacks")

    def _run(self):
        while not self._stop.wait(self._poll):
            stalled = time.monotonic() - self._last
            if stalled >= self.timeout and not self._fired:
                self._fired = True
                print(self._message(stalled), file=sys.stderr, flush=True)
                try:
                    faulthandler.dump_traceback(file=sys.stderr)
                except Exception:
                    pass
                if self.on_hang is not None:
                    try:
                        self.on_hang(stalled)
                    except Exception:
                        pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
