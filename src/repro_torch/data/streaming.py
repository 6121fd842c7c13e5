"""Webdataset-style sharded streaming data pipeline (the port's own copy
of ``repro.data.streaming``, which imports no JAX: the same shard format
and ``FORMAT_VERSION``, so each package reads the other's shards bitwise,
and the same index plan).

Samples live in shard files on disk and are decoded (and augmented) on
the fly, per batch, by a bounded worker pool, while every determinism
invariant of the in-memory path survives bit for bit.

Shard directory layout::

    index.json          sidecar: record schema, shard table, augment spec
    shard-00000.bin     samples [0, S)          (fixed-size records)
    shard-00001.bin     samples [S, 2S) ...

Records are **fixed-size**: each sample's fields (sorted by name) are
raw C-order bytes at the dtype/shape recorded once in the sidecar, so
the byte address of global sample ``i`` is O(1) arithmetic::

    file = shards[i // samples_per_shard]
    off  = (i % samples_per_shard) * record_size

— index-addressability is a property of the *format*, not of an
in-memory offset table (the sidecar stays a few hundred bytes at any
sample count).  Reads go through ``os.pread`` on per-file descriptors:
thread-safe with no seek state, so decode workers share handles freely.

On-the-fly augmentation: the sidecar can carry an ``augment`` spec
(currently ``gaussian_noise``: field, scale, seed, stream-label).  The
decode stage re-applies it with the *same* per-sample counter-based
Philox keying as the in-memory datasets (``repro_torch.data.rng``), so a
stream of materialized-clean + decode-augmented samples is
**bit-identical** to the in-memory oracle — storing f32 noise for the
315M-pair scale would triple the bytes for no information.

Ownership contract: ``StreamingLoader`` inherits ``ShardedLoader``'s
index plan verbatim — same per-(epoch, shard) SeedSequence-keyed
permutations, same data-major shard concatenation (== the FCCO u-shard
layout from ``core/shard_state.py``), same O(1)-per-skipped-step
``steps(n, start=)`` fast-forward.  What changes is batch *assembly*:
up to ``decode_ahead`` upcoming batches are decoded concurrently on a
``workers``-thread pool (each batch split into per-worker chunks) and
yielded strictly in stream order; a decode exception surfaces on the
consumer at the position it occurred, exactly like ``DevicePrefetcher``.

Writer CLI (materialize a synthetic dataset for tests/benches)::

    PYTHONPATH=src python -m repro_torch.data.streaming \
        --out /tmp/shards --arch clip-vitb32-cc12m --reduced --n 2048
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.data import rng as R
from repro_torch.data.pipeline import ShardedLoader

FORMAT_VERSION = 1
INDEX_NAME = "index.json"
DEFAULT_SAMPLES_PER_SHARD = 256


def _shard_name(k: int) -> str:
    return f"shard-{k:05d}.bin"


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Sidecar schema
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One record field: fixed dtype/shape, raw C-order bytes."""
    name: str
    dtype: str
    shape: tuple

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)
                   * np.dtype(self.dtype).itemsize)


def _fields_of(sample: Dict[str, np.ndarray]) -> List[FieldSpec]:
    return [FieldSpec(k, np.asarray(v).dtype.str,
                      tuple(np.asarray(v).shape))
            for k, v in sorted(sample.items())]


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write_shards(out_dir: str, dataset, *,
                 samples_per_shard: int = DEFAULT_SAMPLES_PER_SHARD,
                 augment: Optional[dict] = None,
                 write_batch: int = 64,
                 meta: Optional[dict] = None) -> str:
    """Materialize ``dataset`` (``.n``, ``.batch(idx)``) into a shard
    directory.  Every file goes tmp + ``os.replace``; the index sidecar
    is written **last**, so a crash mid-materialization leaves a
    directory the reader refuses (no sidecar) rather than a silently
    short dataset.

    ``augment`` records a decode-time augmentation spec (see
    ``apply_augment``); pass it when ``dataset`` yields *clean* samples
    whose noise should be re-applied on the fly."""
    os.makedirs(out_dir, exist_ok=True)
    n = int(dataset.n)
    probe = dataset.batch(np.asarray([0]))
    fields = [FieldSpec(f.name, f.dtype, f.shape[1:])
              for f in _fields_of(probe)]
    record_size = sum(f.nbytes for f in fields)

    n_files = (n + samples_per_shard - 1) // samples_per_shard
    for k in range(n_files):
        lo, hi = k * samples_per_shard, min((k + 1) * samples_per_shard, n)
        parts = []
        for b0 in range(lo, hi, write_batch):
            idx = np.arange(b0, min(b0 + write_batch, hi))
            batch = dataset.batch(idx)
            for j in range(len(idx)):
                for f in fields:
                    arr = np.ascontiguousarray(
                        np.asarray(batch[f.name][j], np.dtype(f.dtype)))
                    parts.append(arr.tobytes())
        _atomic_write(os.path.join(out_dir, _shard_name(k)),
                      b"".join(parts))

    sidecar = {
        "version": FORMAT_VERSION,
        "n": n,
        "samples_per_shard": samples_per_shard,
        "record_size": record_size,
        "fields": [dataclasses.asdict(f) for f in fields],
        "shards": [{"file": _shard_name(k),
                    "n": min((k + 1) * samples_per_shard, n)
                    - k * samples_per_shard}
                   for k in range(n_files)],
        "augment": augment,
        "meta": meta or {},
    }
    _atomic_write(os.path.join(out_dir, INDEX_NAME),
                  json.dumps(sidecar, indent=1).encode("utf-8"))
    return out_dir


def write_contrastive_shards(ds, out_dir: str, *,
                             samples_per_shard: int =
                             DEFAULT_SAMPLES_PER_SHARD) -> str:
    """Materialize a ``ContrastiveDataset`` with the image noise left to
    decode time: shards hold the clean rendered prototypes, the sidecar
    holds the (scale, seed, stream) of the per-sample Gaussian augment —
    the streamed batches are bit-identical to ``ds.batch``."""

    class _Clean:
        n = ds.n

        @staticmethod
        def batch(idx):
            return {"images": ds.clean_images(np.asarray(idx)),
                    "texts": ds.texts(np.asarray(idx))}

    augment = {"kind": "gaussian_noise", "field": "images",
               "scale": float(ds.noise), "seed": int(ds.seed),
               "stream": ds.IMAGE_STREAM}
    return write_shards(out_dir, _Clean(), augment=augment,
                        samples_per_shard=samples_per_shard,
                        meta={"source": "ContrastiveDataset",
                              "n_classes": int(ds.n_classes)})


# ---------------------------------------------------------------------------
# Decode-time augmentation
# ---------------------------------------------------------------------------

def apply_augment(spec: Optional[dict], batch: Dict[str, np.ndarray],
                  idx) -> Dict[str, np.ndarray]:
    """Re-apply a sidecar augment spec to a decoded batch, keyed by the
    samples' global indices: the same ``repro_torch.data.rng`` primitive
    the in-memory datasets use, hence bitwise-identical output."""
    if spec is None:
        return batch
    if spec["kind"] == "gaussian_noise":
        key = R.stream_key(spec["seed"], spec["stream"])
        out = dict(batch)
        out[spec["field"]] = R.add_gaussian_noise(
            batch[spec["field"]], spec["scale"], key, idx)
        return out
    raise ValueError(f"unknown augment kind {spec['kind']!r}")


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class StreamingDataset:
    """Index-addressable reader over a shard directory.

    Implements the dataset protocol (``.n``, ``.batch(idx)``) so it
    drops into ``ShardedLoader``/``StreamingLoader`` unchanged.  Decode
    is thread-safe (``os.pread`` on shared per-shard descriptors, no
    mutable read state), and ``decodes`` counts decoded samples — the
    counting-decoder hook the fast-forward tests assert O(1) skip with.
    """

    def __init__(self, root: str):
        self.root = root
        index_path = os.path.join(root, INDEX_NAME)
        if not os.path.exists(index_path):
            raise FileNotFoundError(
                f"{root!r} has no {INDEX_NAME}: not a shard directory "
                "(or its materialization crashed before the sidecar — "
                "the writer commits it last)")
        with open(index_path, "r", encoding="utf-8") as f:
            self.index = json.load(f)
        if self.index.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"shard format version {self.index.get('version')!r} != "
                f"{FORMAT_VERSION} in {index_path}")
        self.n = int(self.index["n"])
        self.samples_per_shard = int(self.index["samples_per_shard"])
        self.record_size = int(self.index["record_size"])
        self.fields = [FieldSpec(f["name"], f["dtype"], tuple(f["shape"]))
                       for f in self.index["fields"]]
        self.augment = self.index.get("augment")
        self._shards = self.index["shards"]
        self._fds: Dict[int, int] = {}
        self._fd_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.decodes = 0                       # counting decoder (tests)

    # -- raw record IO ------------------------------------------------------

    def _fd(self, k: int) -> int:
        with self._fd_lock:
            fd = self._fds.get(k)
            if fd is None:
                path = os.path.join(self.root, self._shards[k]["file"])
                fd = os.open(path, os.O_RDONLY)
                self._fds[k] = fd
            return fd

    def read_record(self, i: int) -> bytes:
        if not 0 <= i < self.n:
            raise IndexError(f"sample {i} out of range [0, {self.n})")
        k, r = divmod(int(i), self.samples_per_shard)
        buf = os.pread(self._fd(k), self.record_size,
                       r * self.record_size)
        if len(buf) != self.record_size:
            raise IOError(
                f"short read of sample {i} from shard {k}: got "
                f"{len(buf)} of {self.record_size} bytes (truncated "
                "shard file?)")
        return buf

    def _decode(self, i: int) -> Dict[str, np.ndarray]:
        buf = self.read_record(i)
        out, off = {}, 0
        for f in self.fields:
            out[f.name] = np.frombuffer(
                buf, np.dtype(f.dtype), count=int(np.prod(f.shape,
                                                          dtype=np.int64)),
                offset=off).reshape(f.shape)
            off += f.nbytes
        with self._count_lock:   # exact under concurrent decode workers
            self.decodes += 1
        return out

    # -- dataset protocol ---------------------------------------------------

    def batch(self, idx) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx).reshape(-1)
        rows = [self._decode(i) for i in idx]
        stacked = {f.name: np.stack([r[f.name] for r in rows])
                   for f in self.fields}
        return apply_augment(self.augment, stacked, idx)

    def close(self) -> None:
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Pipelined loader
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamingLoader(ShardedLoader):
    """``ShardedLoader`` index contract + a bounded decode worker pool.

    The (epoch, step, idx) plan is inherited verbatim — the streaming
    loader is stream-identical (indices AND batches, bitwise) to the
    in-memory loader over the same samples for the same (seed,
    global_batch, n_shards).  ``steps`` pipelines decode: up to
    ``decode_ahead`` batches are in flight on ``workers`` threads, each
    batch split into per-worker chunks, results concatenated and
    yielded strictly in order.  ``fault_hook(step)`` (chaos battery)
    runs inside the first decode task of each batch, so an injected
    fault propagates the worker-pool path, not the caller's.

    The pool lives inside the generator: early exit (``close`` on a
    wrapping ``DevicePrefetcher``, an exception, GC) cancels pending
    futures and shuts the executor down via the generator's finally.
    """
    workers: int = 4
    decode_ahead: int = 4
    fault_hook: Optional[Callable[[int], None]] = None

    def _decode_chunk(self, step: int, idx_chunk: np.ndarray,
                      first: bool) -> Dict[str, np.ndarray]:
        if first and self.fault_hook is not None:
            self.fault_hook(step)
        return self.dataset.batch(idx_chunk)

    def _submit(self, ex: ThreadPoolExecutor, step: int, idx):
        rows = self._owned_rows(np.asarray(idx))
        n_chunks = max(1, min(self.workers,
                              len(rows) // max(1, self.local_batch // 2)))
        chunks = np.array_split(rows, n_chunks)
        return [ex.submit(self._decode_chunk, step, c, j == 0)
                for j, c in enumerate(chunks)]

    @staticmethod
    def _gather(futs) -> Dict[str, np.ndarray]:
        parts = [f.result() for f in futs]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}

    def steps(self, n_steps: int, start: int = 0):
        ex = ThreadPoolExecutor(max_workers=self.workers,
                                thread_name_prefix="decode")
        pending = collections.deque()
        plan = self._index_steps(n_steps, start)
        try:
            while True:
                while len(pending) < max(1, self.decode_ahead):
                    nxt = next(plan, None)
                    if nxt is None:
                        break
                    epoch, step, idx = nxt
                    pending.append((epoch, step, idx,
                                    self._submit(ex, step, idx)))
                if not pending:
                    return
                epoch, step, idx, futs = pending.popleft()
                yield epoch, step, idx, self._gather(futs)
        finally:
            for *_, futs in pending:
                for f in futs:
                    f.cancel()
            ex.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# Writer CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import ContrastiveDataset

    ap = argparse.ArgumentParser(
        description="materialize a synthetic ContrastiveDataset into a "
                    "streaming shard directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--arch", default="clip-vitb32-cc12m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--n-classes", type=int, default=64)
    ap.add_argument("--samples-per-shard", type=int,
                    default=DEFAULT_SAMPLES_PER_SHARD)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ds = ContrastiveDataset(
        n=args.n, image_size=cfg.clip.image_size,
        context_length=cfg.clip.context_length,
        vocab_size=cfg.vocab_size, n_classes=args.n_classes,
        seed=args.seed)
    out = write_contrastive_shards(
        ds, args.out, samples_per_shard=args.samples_per_shard)
    sd = StreamingDataset(out)
    print(f"wrote {sd.n} samples x {sd.record_size} B in "
          f"{len(sd.index['shards'])} shard files to {out}")
    sd.close()
    return out


if __name__ == "__main__":
    main()
