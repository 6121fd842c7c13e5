"""Sharded, epoch-shuffled, index-carrying data pipeline (port of
``repro.data.pipeline``; numpy only, so index plans and batches equal the
JAX package's bit for bit).

Each worker owns a contiguous shard of the dataset (samples
[k*n/K, (k+1)*n/K)), matching the sharding of the FCCO u buffers.  With
``owned_shards`` a process assembles only its own shards' rows of each
global batch (a rank of the (data, fsdp) mesh owns one shard); the
yielded index plan stays global.

``DevicePrefetcher`` wraps any step iterator with a producer thread that
assembles host batches and starts the host->device copy ``depth`` steps
ahead (the launcher's transform copies from pinned host memory with
``non_blocking=True``), so the copy overlaps the previous step's compute.
When the producer stops (end, error or ``close()``) it closes the wrapped
iterator, so a generator's cleanup, such as the streaming loader's decode
pool shutdown, runs at once.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ShardedLoader:
    dataset: object            # .batch(idx) -> dict, .n
    global_batch: int
    n_shards: int = 1
    seed: int = 0
    # multi-process ownership: when set, only these shard ids' rows of
    # each global batch are assembled here (``steps`` / ``epoch`` batches
    # hold len(owned_shards) * local_batch rows); ``idx`` stays global
    owned_shards: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        self.n = self.dataset.n
        if self.n % self.n_shards or self.global_batch % self.n_shards:
            raise ValueError(
                f"n {self.n} and global_batch {self.global_batch} must "
                f"split evenly over {self.n_shards} shards")
        self.shard_size = self.n // self.n_shards
        self.local_batch = self.global_batch // self.n_shards
        if self.local_batch > self.shard_size:
            raise ValueError(
                f"local batch {self.local_batch} (global_batch "
                f"{self.global_batch} / {self.n_shards} shards) exceeds "
                f"the per-shard sample count {self.shard_size} (n "
                f"{self.n} / {self.n_shards}): steps_per_epoch would be "
                "0 and the loader could never yield a full batch.  "
                "Lower --global-batch or raise --n-samples.")
        if self.owned_shards is not None:
            bad = [k for k in self.owned_shards
                   if not 0 <= k < self.n_shards]
            if bad:
                raise ValueError(
                    f"owned_shards {bad} outside [0, {self.n_shards})")

    @property
    def steps_per_epoch(self) -> int:
        return self.shard_size // self.local_batch

    def _epoch_perms(self, epoch: int):
        """Per-(epoch, shard) permutations keyed by SeedSequence spawn
        keys (collision-free)."""
        per_shard = []
        for k in range(self.n_shards):
            ss = np.random.SeedSequence(self.seed, spawn_key=(epoch, k))
            rng = np.random.Generator(np.random.PCG64(ss))
            per_shard.append(k * self.shard_size
                             + rng.permutation(self.shard_size))
        return per_shard

    def _step_idx(self, per_shard, step: int) -> np.ndarray:
        return np.concatenate([
            p[step * self.local_batch:(step + 1) * self.local_batch]
            for p in per_shard])

    def _owned_rows(self, idx: np.ndarray) -> np.ndarray:
        """The rows of a global index batch assembled here: shard k owns
        rows [k * local_batch, (k + 1) * local_batch) of the
        shard-concatenated batch (all rows when ``owned_shards`` is
        unset)."""
        if self.owned_shards is None:
            return idx
        L = self.local_batch
        idx = np.asarray(idx)
        return np.concatenate([idx[k * L:(k + 1) * L]
                               for k in self.owned_shards])

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, dict]]:
        """Yields (global indices (global_batch,), batch dict) with the
        per-shard sub-batches concatenated in shard order."""
        per_shard = self._epoch_perms(epoch)
        for step in range(self.steps_per_epoch):
            idx = self._step_idx(per_shard, step)
            yield idx, self.dataset.batch(self._owned_rows(idx))

    def _index_steps(self, n_steps: int, start: int = 0):
        """The index-only step plan: (epoch, step, idx) for steps
        [``start``, ``n_steps``); whole epochs before ``start`` draw no
        permutation."""
        step = 0
        epoch = 0
        while step < n_steps:
            if step + self.steps_per_epoch <= start:
                step += self.steps_per_epoch
                epoch += 1
                continue
            per_shard = self._epoch_perms(epoch)
            for e_step in range(self.steps_per_epoch):
                if step >= n_steps:
                    return
                if step >= start:
                    yield epoch, step, self._step_idx(per_shard, e_step)
                step += 1
            epoch += 1

    def steps(self, n_steps: int, start: int = 0):
        """(epoch, step, idx, batch) for steps [``start``, ``n_steps``).
        ``start`` is the resume fast-forward, positionally identical to
        filtering a full run: whole epochs before it draw no permutation
        and skipped steps assemble no batch.  ``batch`` holds the owned
        rows only; ``idx`` is global."""
        for epoch, step, idx in self._index_steps(n_steps, start):
            yield epoch, step, idx, self.dataset.batch(
                self._owned_rows(idx))


# ---------------------------------------------------------------------------
# Host->device prefetch
# ---------------------------------------------------------------------------

_STOP = object()


class DevicePrefetcher:
    """Prefetch over any finite iterator: a daemon producer thread pulls
    items, applies ``transform`` (the host->device copy) and parks up to
    ``depth`` of them in a bounded queue.  Producer exceptions re-raise on
    the consumer side at the position they occurred; order is the
    wrapped iterator's.  ``close()`` releases the producer early."""

    def __init__(self, iterator: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._transform = transform
        self._stop = threading.Event()
        self._done = False

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in iterator:
                    if not put(self._transform(item)
                               if self._transform else item):
                        return
            except BaseException as e:  # surfaced on the consumer thread
                if not put(e):
                    return
            finally:
                # a generator's own cleanup (the streaming loader's decode
                # pool) runs here, on the thread that iterated it
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
            put(_STOP)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def close(self):
        """Release the producer after an early exit; drops queued items."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _STOP:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item
