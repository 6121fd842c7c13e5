"""Bounded, digest-verified embedding cache — the degraded path.

Keys are ``"{params_step}:{content_hash}"`` (``errors.content_hash``),
so a hot params reload can never serve stale-params embeddings: the
step changes, every old key simply stops matching.

Every entry stores its own CRC32 (over dtype + shape + raw bytes, the
same digest recipe as the checkpoint sidecars).  ``get`` re-verifies on
every hit: a corrupted entry is *detected*, evicted, counted, and
reported as a miss — the engine then recomputes, so cache corruption
degrades to extra work, never to wrong bytes.  This is what lets the
engine serve cache hits while the circuit breaker is open and still
keep the bit-exactness contract.
"""
from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np


def _digest(a: np.ndarray) -> int:
    crc = zlib.crc32(str((a.dtype.str, a.shape)).encode())
    return zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)


class EmbeddingCache:
    def __init__(self, capacity: int = 1024,
                 fault_hook: Optional[Callable[[int], bool]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # key -> (buffer bytearray, dtype str, shape, crc)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self._fault_hook = fault_hook   # chaos: corrupt the n-th put
        self._n_puts = 0
        self.stats = {"hits": 0, "misses": 0, "corrupt": 0, "puts": 0,
                      "evictions": 0}

    def put(self, key: str, emb: np.ndarray) -> None:
        emb = np.ascontiguousarray(emb)
        buf = bytearray(emb.tobytes())
        crc = _digest(emb)
        with self._lock:
            self._n_puts += 1
            # The digest is recorded from the true bytes *before* the
            # chaos hook mutates the buffer — exactly the bit-rot model
            # (payload flips after write) the digest exists to catch.
            if self._fault_hook is not None and self._fault_hook(self._n_puts):
                buf[len(buf) // 2] ^= 0xFF
            self._entries.pop(key, None)
            self._entries[key] = (buf, emb.dtype.str, emb.shape, crc)
            self.stats["puts"] += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats["evictions"] += 1

    def get(self, key: str) -> Optional[np.ndarray]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats["misses"] += 1
                return None
            buf, dtype, shape, crc = entry
            a = np.frombuffer(bytes(buf), dtype=dtype).reshape(shape)
            if _digest(a) != crc:
                del self._entries[key]
                self.stats["corrupt"] += 1
                self.stats["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            return a.copy()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
