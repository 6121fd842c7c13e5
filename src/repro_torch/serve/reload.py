"""Hot checkpoint reload: shadow restore, atomic swap, reject-on-bad.

``ParamsStore`` is the single source of truth for which params serve
traffic.  The batcher snapshots (params, step) per batch, so an
in-flight batch always finishes on the params it started with, and the
watcher swaps new params in atomically under the store lock.

``CheckpointWatcher`` polls the checkpoint directory.  Candidates come
from ``checkpoint.available_steps`` (existence only) on purpose: a
complete but corrupt checkpoint must be attempted so that its digest
failure is observed, counted and the step blacklisted, with the old
params still serving.  The restore goes through the digest-verified
``checkpoint.restore_subtree``; ``materialize`` turns the restored
numpy tree into params on the serving device.  ``fault_hook(attempt,
directory, step)`` runs before each restore attempt (the chaos hook
``ChaosInjector.on_reload``, which corrupts the n-th candidate).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch import checkpoint as CK


class ParamsStore:
    def __init__(self, params, step: int):
        self._lock = threading.Lock()
        self._params = params
        self._step = int(step)

    def snapshot(self):
        """(params, step) as one consistent pair."""
        with self._lock:
            return self._params, self._step

    def swap(self, params, step: int) -> None:
        with self._lock:
            self._params = params
            self._step = int(step)

    @property
    def step(self) -> int:
        with self._lock:
            return self._step


class CheckpointWatcher:
    def __init__(self, directory: str, like, store: ParamsStore, *,
                 materialize: Callable, prefix: str = "params",
                 poll_interval: float = 1.0,
                 fault_hook: Optional[Callable[[int, str, int], None]] = None):
        self.directory = directory
        self.like = like
        self.store = store
        self.materialize = materialize   # numpy tree -> params
        self.prefix = prefix
        self.poll_interval = float(poll_interval)
        self._fault_hook = fault_hook  # chaos: corrupt the n-th candidate
        self._rejected = set()
        self._attempts = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"reloads": 0, "reload_rejected": 0}

    def poll_once(self) -> Optional[int]:
        """One poll: restore + swap the newest unseen step if any.
        Returns the step swapped in, else None."""
        steps = CK.available_steps(self.directory)
        current = self.store.step
        candidates = [s for s in steps
                      if s > current and s not in self._rejected]
        if not candidates:
            return None
        step = max(candidates)
        self._attempts += 1
        try:
            if self._fault_hook is not None:
                self._fault_hook(self._attempts, self.directory, step)
            tree, got_step, _meta = CK.restore_subtree(
                self.directory, self.like, self.prefix, step=step)
            if got_step != step:
                raise ValueError(f"asked for step {step}, got {got_step}")
            params = self.materialize(tree)
        except Exception as e:  # digest mismatch, bad metadata, ...
            # Blacklist the step and keep serving the old params; a
            # later (higher) checkpoint will be attempted normally.
            self._rejected.add(step)
            self.stats["reload_rejected"] += 1
            print(f"[serve] checkpoint step {step} rejected: {e}",
                  flush=True)
            return None
        self.store.swap(params, step)
        self.stats["reloads"] += 1
        print(f"[serve] hot-reloaded params at step {step}", flush=True)
        return step

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # pragma: no cover - defensive
                print(f"[serve] watcher poll error: {e}", flush=True)
            self._stop.wait(self.poll_interval)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-ckpt-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
