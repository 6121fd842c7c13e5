"""Seeded, deterministic fault injection for the crash-recovery battery
(the port's own copy of ``repro.resilience.chaos``, which imports no JAX:
the same spec and seed give the same decision at every step or
occurrence, and ``nan_batch`` poisons the same row).  Both sets of hooks
are wired: the training hooks by ``repro_torch.launch.train --chaos``
(``on_loader`` and ``poison_batch`` in the host stream before the H2D
copy, ``on_decode`` in the streaming loader's decode workers,
``pre_step`` before each step, ``checkpoint_event`` as the checkpoint
writer's fault hook), the serving hooks by ``repro_torch.serve`` and
``launch/serve_embed.py --chaos``.

A chaos spec is a comma-separated list of faults, each firing **at most
once per process** (so a rollback replay inside one process does not
re-trigger the same fault, while a killed-and-restarted process decides
afresh from its own ``--chaos`` flag):

    nan_batch@K        poison one (seeded) row of the host batch of
                       loader step K with NaN before the H2D transfer —
                       the loss and every gradient go non-finite, the
                       step guard must turn the step into a bitwise
                       no-op
    loader_raise@K     raise RuntimeError out of the loader stream at
                       step K (exercises DevicePrefetcher error
                       propagation and clean shutdown)
    decode_raise@K     raise RuntimeError inside a streaming decode
                       worker while it assembles the batch of step K
                       (exercises error propagation through the decode
                       pool *and* the prefetcher: the exception must
                       surface on the consumer thread at that step,
                       with no deadlock and no leaked workers)
    kill@K             SIGKILL the process immediately before running
                       step K (mid-run crash; resume must replay to the
                       uninterrupted trajectory bit-for-bit)
    sigterm@K          deliver SIGTERM to the process immediately
                       before step K (deterministic preemption: the
                       launcher must finish the in-flight step, write a
                       final synchronous checkpoint and exit cleanly)
    kill_save@EVENT[:N]
                       SIGKILL at the N-th occurrence (1-based, default
                       1) of checkpoint fault point EVENT.  The
                       checkpoint writer announces, per save:
                       ``pre_npz`` (nothing written yet), ``mid_npz``
                       (a tmp array file written, not yet renamed —
                       once per array file), ``npz`` (an array file
                       atomically in place), ``mid_sidecar`` /
                       ``sidecar`` (same for the json), ``latest``
                       (marker updated), ``done``.

Serving faults (the ``repro_torch.serve`` engine's chaos battery; K counts
the engine's computed micro-batches / cache insertions / reload
attempts, 1-based):

    compute_nan@K      NaN-poison the input of the K-th computed
                       micro-batch (first attempt only — a retry
                       recomputes clean), so the in-jit finiteness
                       check must turn it into a typed retryable error,
                       never a silently wrong embedding
    slow_batch@K:MS    sleep MS milliseconds before computing micro-
                       batch K (a transient compute stall: deadline-
                       aware admission must shed what can no longer be
                       served in time; completed responses stay exact)
    cache_corrupt@K    flip a byte of the K-th embedding-cache
                       insertion's stored payload after its digest is
                       recorded — a later read must detect the mismatch
                       and fall through to recompute
    reload_bad_ckpt@K  flip a byte of the candidate checkpoint's npz on
                       the K-th hot-reload attempt, before the digest-
                       verified restore — the watcher must reject the
                       swap and keep serving the old params

Everything is deterministic in (spec, seed, step/occurrence): the same
spec kills the same run at the same byte, which is what lets the battery
compare a killed-and-resumed run bit-for-bit against an uninterrupted
one.  ``truncate_file`` / ``flip_byte`` are the offline corruption
helpers the integrity tests use on checkpoint files directly.
"""
from __future__ import annotations

import os
import re
import signal
from typing import Dict, Optional

import numpy as np

_FAULT_RE = re.compile(
    r"^(nan_batch|loader_raise|decode_raise|kill|sigterm"
    r"|compute_nan|cache_corrupt|reload_bad_ckpt)@(\d+)$")
_KILL_SAVE_RE = re.compile(r"^kill_save@([a-z_]+)(?::(\d+))?$")
_SLOW_BATCH_RE = re.compile(r"^slow_batch@(\d+):(\d+(?:\.\d+)?)$")


def _real_kill():
    os.kill(os.getpid(), signal.SIGKILL)


class ChaosInjector:
    """Holds the parsed faults and exposes one hook per injection site.
    ``kill_fn`` is the process-kill action (SIGKILL by default); tests
    that simulate kills in-process replace it with a raiser."""

    def __init__(self, spec: str, seed: int = 0, kill_fn=None):
        self.spec = spec
        self.seed = int(seed)
        self.kill_fn = kill_fn or _real_kill
        self._nan_steps: Dict[int, bool] = {}
        self._raise_steps: Dict[int, bool] = {}
        self._decode_steps: Dict[int, bool] = {}
        self._kill_steps: Dict[int, bool] = {}
        self._sigterm_steps: Dict[int, bool] = {}
        self._kill_saves: Dict[str, Dict[int, bool]] = {}
        self._event_counts: Dict[str, int] = {}
        self._compute_nan: Dict[int, bool] = {}
        self._cache_corrupt: Dict[int, bool] = {}
        self._reload_bad: Dict[int, bool] = {}
        self._slow_ms: Dict[int, float] = {}
        self._slow_fired: Dict[int, bool] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _FAULT_RE.match(part)
            if m:
                table = {"nan_batch": self._nan_steps,
                         "loader_raise": self._raise_steps,
                         "decode_raise": self._decode_steps,
                         "kill": self._kill_steps,
                         "sigterm": self._sigterm_steps,
                         "compute_nan": self._compute_nan,
                         "cache_corrupt": self._cache_corrupt,
                         "reload_bad_ckpt": self._reload_bad}[m.group(1)]
                table[int(m.group(2))] = False
                continue
            m = _KILL_SAVE_RE.match(part)
            if m:
                occ = int(m.group(2) or 1)
                self._kill_saves.setdefault(m.group(1), {})[occ] = False
                continue
            m = _SLOW_BATCH_RE.match(part)
            if m:
                self._slow_ms[int(m.group(1))] = float(m.group(2))
                self._slow_fired[int(m.group(1))] = False
                continue
            raise ValueError(f"unparseable chaos fault {part!r} in "
                             f"{spec!r}")

    def _fire_once(self, table, key) -> bool:
        if key in table and not table[key]:
            table[key] = True
            return True
        return False

    # -- injection sites ----------------------------------------------------

    def on_loader(self, step: int) -> None:
        """Called per loader step; raises when a loader fault is due."""
        if self._fire_once(self._raise_steps, step):
            raise RuntimeError(f"chaos: injected loader failure at step "
                               f"{step}")

    def on_decode(self, step: int) -> None:
        """Called from inside a streaming decode worker (first chunk of
        a batch); raises when a decode fault is due for that step."""
        if self._fire_once(self._decode_steps, step):
            raise RuntimeError(f"chaos: injected decode failure at step "
                               f"{step}")

    def poison_batch(self, step: int, batch: dict) -> dict:
        """NaN-poison one seeded row of the first float array of the
        batch at the configured step (a copy; the dataset's buffers are
        untouched)."""
        if not self._fire_once(self._nan_steps, step):
            return batch
        batch = dict(batch)
        for key in sorted(batch):
            arr = np.asarray(batch[key])
            if np.issubdtype(arr.dtype, np.floating):
                rng = np.random.RandomState(self.seed * 9973 + step)
                row = int(rng.randint(arr.shape[0])) if arr.ndim else 0
                poisoned = np.array(arr, copy=True)
                poisoned[row] = np.nan
                batch[key] = poisoned
                return batch
        raise ValueError("chaos: nan_batch found no float array to poison")

    def pre_step(self, step: int) -> None:
        if self._fire_once(self._sigterm_steps, step):
            os.kill(os.getpid(), signal.SIGTERM)
        if self._fire_once(self._kill_steps, step):
            self.kill_fn()

    def checkpoint_event(self, event: str) -> None:
        """The checkpoint writer's fault hook: counts occurrences of
        each save event and kills on the configured one."""
        n = self._event_counts.get(event, 0) + 1
        self._event_counts[event] = n
        if self._fire_once(self._kill_saves.get(event, {}), n):
            self.kill_fn()

    # -- serving injection sites (repro_torch.serve) ------------------------

    def compute_poison(self, n_batch: int) -> bool:
        """True when the ``n_batch``-th computed micro-batch's input is
        due for NaN poisoning (the engine poisons the first attempt only;
        a retry recomputes clean)."""
        return self._fire_once(self._compute_nan, n_batch)

    def compute_delay(self, n_batch: int) -> float:
        """Seconds to stall before computing micro-batch ``n_batch``
        (0.0 when no ``slow_batch`` fault is due)."""
        if self._fire_once(self._slow_fired, n_batch):
            return self._slow_ms[n_batch] / 1000.0
        return 0.0

    def on_cache_put(self, n_put: int) -> bool:
        """True when the ``n_put``-th embedding-cache insertion should
        have a payload byte flipped (after its digest is recorded)."""
        return self._fire_once(self._cache_corrupt, n_put)

    def on_reload(self, n_attempt: int, directory: str,
                  step: int) -> None:
        """Called by the hot-reload watcher before its ``n_attempt``-th
        restore; flips one mid-file byte of the candidate step's npz
        when a ``reload_bad_ckpt`` fault is due, so the digest-verified
        restore must reject it."""
        if self._fire_once(self._reload_bad, n_attempt):
            path = os.path.join(directory, f"ckpt_{step:08d}.npz")
            flip_byte(path, os.path.getsize(path) // 2)


def parse_chaos(spec: Optional[str], seed: int = 0,
                kill_fn=None) -> Optional[ChaosInjector]:
    if not spec:
        return None
    return ChaosInjector(spec, seed=seed, kill_fn=kill_fn)


# ---------------------------------------------------------------------------
# Offline corruption helpers (integrity tests)
# ---------------------------------------------------------------------------

def truncate_file(path: str, keep_bytes: int) -> None:
    """Truncate ``path`` to its first ``keep_bytes`` bytes (a crash
    mid-write on a filesystem that committed only a prefix)."""
    with open(path, "rb+") as f:
        f.truncate(keep_bytes)


def flip_byte(path: str, offset: int) -> None:
    """XOR-flip one byte of ``path`` (bit rot / torn sector)."""
    with open(path, "rb+") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
