"""Checkpoints in the JAX package's on-disk format.

A step is ``ckpt_XXXXXXXX.npz`` (``np.savez``, stored, not compressed:
f32 weights barely compress, and zlib runs on one core; one array per
leaf, keyed by its ``/``-joined path such as ``params/vision/blocks/
attn/wq``) plus the sidecar ``ckpt_XXXXXXXX.json`` with ``order``,
``metadata``, per-leaf CRC32 ``digests`` and, for an fsdp-sharded save,
``shards`` (``ckpt_XXXXXXXX.shardKKofNN.npz`` files merged here along
the recorded dim).  A ``latest`` marker names the newest step.  Every
write goes tmp-file then ``os.replace``, in the order arrays, sidecar,
marker, so a crash leaves the previous step intact.  A checkpoint the
JAX package wrote restores here and the reverse: ``np.load`` reads a
stored npz as it reads the JAX package's compressed ones.

Trees are nested ``dict``s (sorted key order, as JAX flattens them) and
``list``s (index order, the index a part of the path, as in the JAX
package's ``vision/stage0/1/c1``) whose leaves are numpy arrays or
tensors; restores return numpy arrays.

Sharded saves (``save_sharded``, the (data, fsdp) mesh of
``core.shard_state``) write the JAX package's format: shard file ``k``
holds every fsdp-sharded leaf's k-th piece along the dim recorded in the
sidecar.  With more than one rank, every rank writes its block of the
sample-sharded leaves (the FCCO u and v2 tau buffers) to a rank-tagged
file ``ckpt_XXXXXXXX.rankRRofPP.npz`` plus a commit meta with the
block's digest and global start; rank 0 writes the shard files, waits on
a filesystem-polling barrier for every rank's commit meta, folds them
into the sidecar (``ranks``) and only then writes ``latest``, so the
marker never names a step some rank has not finished.  Restore merges
both (concatenation along the recorded dims, rank blocks in start
order), so a step saved at one mesh shape restores bit-exactly at any
other, in either package.

Every save is a synchronous host snapshot (``_snapshot`` /
``_snapshot_sharded``: leaves copied to numpy; a sharded save's fsdp
gathers, collectives, run here on the calling thread) followed by the one
write path (``_write_step``).  ``AsyncCheckpointer`` takes owned copies
in ``save`` and runs the writes on one worker thread, in order, with the
retention of ``prune_checkpoints`` (newest ``keep_last`` plus every
``keep_every``-th step) after each; a writer error is latched and raised
by the next ``save`` or ``wait``.  ``set_fault_hook`` installs a callback
that every write announces its stages to, in the JAX package's order and
names: ``pre_npz``, then per file ``mid_npz`` (tmp written) and ``npz``
(renamed; rank files too, followed by ``mid_rank_meta`` / ``rank_meta``),
``mid_sidecar`` / ``sidecar``, ``mid_latest`` / ``latest``, ``done``; the
chaos battery (``repro_torch.resilience.chaos``) kills the process at
them.
"""
from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.(npz|json)$")


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> {path: leaf}: dict keys sorted at every
    level, list items in order under their index."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten``: a level whose keys are exactly ``0``
    ... ``n-1`` becomes a list."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _lists(out)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and set(node) == {str(i) for i in range(len(node))}:
        return [node[str(i)] for i in range(len(node))]
    return node


_FAULT_HOOK: Optional[Callable[[str], None]] = None


def set_fault_hook(fn: Optional[Callable[[str], None]]) -> None:
    """Install ``fn(event)``, called at every write stage of every save
    (``None`` removes it)."""
    global _FAULT_HOOK
    _FAULT_HOOK = fn


def _fault(event: str) -> None:
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(event)


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array on the host.  A CUDA tensor is copied
    (``.cpu()`` waits for the stream, so the bytes are those of this
    moment); a CPU tensor's ``.numpy()`` and ``np.asarray`` alias the
    leaf, so ``copy=True`` takes an owned buffer (what an async save
    needs: the optimizer updates the live tensors in place)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            return t.cpu().numpy()
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return np.array(a, copy=True) if copy else a


def _digest(arr: np.ndarray) -> int:
    """CRC32 over dtype + shape + raw bytes (the JAX package's recipe)."""
    a = np.ascontiguousarray(arr)
    h = zlib.crc32(str((a.dtype.str, a.shape)).encode())
    return zlib.crc32(a.tobytes(), h)


def _atomic_replace(path: str, write_fn, kind: str) -> None:
    """``write_fn(tmp)`` then ``os.replace``, with the fault events
    ``mid_<kind>`` (tmp written, not renamed) and ``<kind>`` around the
    rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        _fault(f"mid_{kind}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    _fault(kind)


def _shard_file(directory: str, step: int, k: int, n: int) -> str:
    return os.path.join(directory,
                        f"ckpt_{step:08d}.shard{k:02d}of{n:02d}.npz")


def _rank_file(directory: str, step: int, r: int, p: int) -> str:
    return os.path.join(directory,
                        f"ckpt_{step:08d}.rank{r:02d}of{p:02d}.npz")


def _rank_meta_file(directory: str, step: int, r: int, p: int) -> str:
    return os.path.join(directory,
                        f"ckpt_{step:08d}.rank{r:02d}of{p:02d}.meta.json")


def _step_files(directory: str, step: int, nshards: int) -> List[str]:
    if nshards == 1:
        return [os.path.join(directory, f"ckpt_{step:08d}.npz")]
    return [_shard_file(directory, step, k, nshards)
            for k in range(nshards)]


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_meta(directory: str, step: int) -> Optional[Dict]:
    return _read_json(os.path.join(directory, f"ckpt_{step:08d}.json"))


def _wait_for(pred, timeout: float, what: str):
    """Filesystem-polling barrier: poll ``pred()`` until it returns
    something truthy (returned), raising after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"multi-process checkpoint barrier timed out after "
                f"{timeout:.0f}s waiting for {what} (a peer rank died or "
                "fell behind)")
        time.sleep(0.05)


def _collect_rank_metas(directory: str, step: int, p: int):
    metas = []
    for r in range(p):
        m = _read_json(_rank_meta_file(directory, step, r, p))
        if m is None or m.get("step") != step or m.get("count") != p:
            return None
        metas.append(m)
    return metas


def _sidecar_committed(directory: str, step: int, p: int) -> bool:
    meta = _read_meta(directory, step)
    return bool(meta and meta.get("step") == step
                and int(meta.get("ranks", {}).get("count", 0)) == p)


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    def write(tmp):
        # through a handle: savez would append ".npz" to the tmp name
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    _atomic_replace(path, write, "npz")


def _write_json(path: str, obj, kind: str) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)
    _atomic_replace(path, write, kind)


def _write_step(directory: str, step: int, pieces, dims, order,
                metadata: Optional[Dict], keep_last: int = 0,
                keep_every: int = 0, local=None, process_index: int = 0,
                process_count: int = 1,
                barrier_timeout: float = 120.0) -> List[str]:
    """The one write path, under sync and async saves alike: array
    file(s), then the digest-carrying sidecar, then the ``latest``
    marker, then retention (``keep_last > 0``).  ``pieces``: {key: [array
    per shard piece]}; ``local``: {key: (global start, block)} of this
    rank's sample-sharded leaves (multi-process only).  Runs no
    collective: ranks meet on the filesystem, so it may run on a worker
    thread."""
    os.makedirs(directory, exist_ok=True)
    local = local or {}
    mp = process_count > 1
    _fault("pre_npz")
    if mp:
        r, p = process_index, process_count
        _savez(_rank_file(directory, step, r, p),
               {key: blk for key, (_, blk) in local.items()})
        _write_json(_rank_meta_file(directory, step, r, p), {
            "step": step, "rank": r, "count": p,
            "arrays": {key: {"start": int(start), "digest": _digest(blk)}
                       for key, (start, blk) in local.items()}},
            "rank_meta")
        if r != 0:
            _wait_for(lambda: _sidecar_committed(directory, step, p),
                      barrier_timeout, f"sidecar commit of step {step}")
            _fault("done")
            return [_rank_file(directory, step, r, p)]
    nshards = max((len(v) for v in pieces.values()), default=1)
    paths = _step_files(directory, step, nshards)
    for k, path in enumerate(paths):
        _savez(path, {key: parts[k] for key, parts in pieces.items()
                      if k < len(parts)})
    meta = {"step": step, "order": order, "metadata": metadata or {},
            "digests": {key: [_digest(a) for a in parts]
                        for key, parts in pieces.items()}}
    if nshards > 1:
        meta["shards"] = {"count": nshards, "dims": dims}
    if mp:
        metas = _wait_for(
            lambda: _collect_rank_metas(directory, step, process_count),
            barrier_timeout,
            f"all {process_count} rank metas of step {step}")
        meta["ranks"] = {
            "count": process_count,
            "arrays": {key: {"dim": 0, "parts": sorted(
                [{"rank": m["rank"], "start": m["arrays"][key]["start"],
                  "digest": m["arrays"][key]["digest"]} for m in metas],
                key=lambda d: d["start"])}
                for key in metas[0]["arrays"]}}
    _write_json(os.path.join(directory, f"ckpt_{step:08d}.json"), meta,
                "sidecar")

    def write_latest(tmp):
        with open(tmp, "w") as f:
            f.write(str(step))

    _atomic_replace(os.path.join(directory, "latest"), write_latest,
                    "latest")
    if keep_last > 0:
        prune_checkpoints(directory, keep_last=keep_last,
                          keep_every=keep_every)
    _fault("done")
    return paths


def _snapshot(tree: Any, copy: bool = False):
    """(pieces, dims, order, local) of a whole tree on the host: one
    piece per leaf, in the sorted key order of ``flatten``."""
    flat = flatten(tree)
    return ({k: [_host(v, copy)] for k, v in flat.items()}, {}, list(flat),
            {})


def save(directory: str, tree: Any, step: int,
         metadata: Optional[Dict] = None) -> str:
    """Single-file save of a nested dict of arrays/tensors.  Returns the
    npz path."""
    pieces, dims, order, _ = _snapshot(tree)
    return _write_step(directory, step, pieces, dims, order, metadata)[0]


def _snapshot_sharded(state: Any, mesh, param_dims, copy: bool = False):
    """(pieces, dims, order, local) of one rank's (data, fsdp) train
    state on the host, for ``_write_step`` with ``process_index =
    mesh.rank`` and ``process_count = mesh.world_size``.  Every rank of
    the mesh calls it for the same step: rank 0's fsdp row gathers the
    fsdp pieces (collectives, on the calling thread)."""
    from repro_torch.core import shard_state as SS
    lays = SS.leaf_layouts(state, mesh.fsdp, param_dims)
    flat = flatten(state)
    mp = mesh.world_size > 1
    # rank 0 writes the shard files; only its fsdp row gathers for it,
    # and only rank 0 copies the pieces to the host
    writer = mesh.rank == 0
    gathers = mesh.axis_index("data") == 0
    pieces, dims, local = {}, {}, {}
    # JAX's key order: sorted at every level of the nested tree
    order = list(flatten(unflatten(dict.fromkeys(flat))))
    for key in order:
        leaf, lay = flat[key], lays[key]
        if lay is not None and lay[0] == "fsdp":
            dims[key] = lay[1]
            if gathers:
                full = SS.all_gather_dim(leaf, "fsdp", lay[1], mesh)
                if writer:
                    pieces[key] = [_host(c, copy) for c in
                                   torch.chunk(full, mesh.fsdp, dim=lay[1])]
                del full
        elif lay is not None and mp:
            local[key] = (mesh.rank * leaf.shape[0], _host(leaf, copy))
        elif writer:
            pieces[key] = [_host(leaf, copy)]
    return pieces, dims, order, local


def save_sharded(directory: str, state: Any, step: int, mesh, param_dims,
                 metadata: Optional[Dict] = None,
                 barrier_timeout: float = 120.0) -> List[str]:
    """Per-shard save of one rank's (data, fsdp) train state
    (``core.shard_state``): every rank of the mesh calls it for the same
    step.  Shard file ``k`` holds the k-th fsdp piece of every sharded
    leaf; replicated leaves go whole into shard 0 (rank 0 writes the
    shard files and the sidecar); sample-sharded leaves go whole into
    shard 0 on a one-rank mesh and into this rank's rank-tagged file
    otherwise.  ``param_dims`` is the layout the state was sharded with.
    Degenerates to the single-npz format when nothing is fsdp-sharded
    and the mesh has one rank."""
    pieces, dims, order, local = _snapshot_sharded(state, mesh, param_dims)
    return _write_step(directory, step, pieces, dims, order, metadata,
                       local=local, process_index=mesh.rank,
                       process_count=mesh.world_size,
                       barrier_timeout=barrier_timeout)


class AsyncCheckpointer:
    """Background checkpoint writer.  ``save`` takes the host snapshot
    synchronously, into owned buffers (after it returns, the live state
    may change freely; a sharded snapshot's gathers run here, on the
    calling thread, never on the worker), and queues the write for one
    worker thread, so the step loop does not wait for the npz writes.

    Saves are written in submission order, each followed by retention
    (``keep_last`` / ``keep_every``, as ``prune_checkpoints``).  A writer
    error is latched and raised by the next ``save`` or ``wait``.
    ``wait()`` drains the queue (before a rollback's restore, and at
    shutdown); ``close()`` waits and stops the worker."""

    def __init__(self, directory: str, keep_last: int = 0,
                 keep_every: int = 0, process_index: int = 0,
                 process_count: int = 1, barrier_timeout: float = 120.0):
        self.directory = directory
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.barrier_timeout = float(barrier_timeout)
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                step, pieces, dims, order, local, metadata = job
                _write_step(self.directory, step, pieces, dims, order,
                            metadata, keep_last=self.keep_last,
                            keep_every=self.keep_every, local=local,
                            process_index=self.process_index,
                            process_count=self.process_count,
                            barrier_timeout=self.barrier_timeout)
            except BaseException as e:   # latched; raised on the caller
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write failed in {self.directory}"
            ) from err

    def save(self, tree: Any, step: int, metadata: Optional[Dict] = None,
             mesh=None, param_dims=None) -> None:
        """Queue a save of ``tree`` (a nested dict of arrays / tensors)
        at ``step``; with ``mesh``, of one rank's (data, fsdp) train
        state, as ``save_sharded`` (every rank calls it)."""
        self._raise_pending()
        if mesh is not None:
            snap = _snapshot_sharded(tree, mesh, param_dims, copy=True)
        else:
            snap = _snapshot(tree, copy=True)
        self._q.put((step, *snap, metadata))

    def wait(self) -> None:
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=60.0)


def prune_checkpoints(directory: str, keep_last: int,
                      keep_every: int = 0) -> List[int]:
    """Delete every complete step except the newest ``keep_last`` and
    (``keep_every > 0``) every step divisible by ``keep_every``, with
    their shard, rank and rank-meta files.  Partial steps are left alone
    (discovery ignores them).  Returns the deleted steps."""
    if keep_last <= 0:
        return []
    steps = available_steps(directory)
    protect = set(steps[-keep_last:])
    if keep_every > 0:
        protect |= {s for s in steps if s % keep_every == 0}
    deleted = []
    for s in steps:
        if s in protect:
            continue
        meta = _read_meta(directory, s) or {}
        n = int(meta.get("shards", {}).get("count", 1))
        for p in _step_files(directory, s, n):
            if os.path.exists(p):
                os.remove(p)
        nranks = int(meta.get("ranks", {}).get("count", 0))
        for r in range(nranks):
            for p in (_rank_file(directory, s, r, nranks),
                      _rank_meta_file(directory, s, r, nranks)):
                if os.path.exists(p):
                    os.remove(p)
        sidecar = os.path.join(directory, f"ckpt_{s:08d}.json")
        if os.path.exists(sidecar):
            os.remove(sidecar)
        deleted.append(s)
    return deleted


def _is_complete(directory: str, step: int) -> bool:
    meta = _read_meta(directory, step)
    if meta is None:
        return False
    ranks = meta.get("ranks")
    if ranks and not all(
            os.path.exists(_rank_file(directory, step, r,
                                      int(ranks["count"])))
            for r in range(int(ranks["count"]))):
        return False
    shards = meta.get("shards")
    n = int(shards["count"]) if shards else 1
    return all(os.path.exists(p) for p in _step_files(directory, step, n))


def available_steps(directory: str) -> List[int]:
    """All complete steps (array files and sidecar exist), ascending.
    Existence only; ``latest_step`` also verifies digests."""
    if not os.path.isdir(directory):
        return []
    steps = set()
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and _is_complete(directory, int(m.group(1))):
            steps.add(int(m.group(1)))
    return sorted(steps)


def _load_verified(directory: str, step: int):
    """Load and digest-verify one step; raises on any damage."""
    meta = _read_meta(directory, step)
    if meta is None:
        raise FileNotFoundError(f"no sidecar for step {step} in {directory}")
    shards = meta.get("shards")
    n = int(shards["count"]) if shards else 1
    dims = shards["dims"] if shards else {}
    digests = meta.get("digests")
    parts = []
    for k, path in enumerate(_step_files(directory, step, n)):
        with np.load(path) as f:
            shard = {key: f[key] for key in f.files}
        if digests is not None:
            for key, arr in shard.items():
                want = digests.get(key)
                if want is None or k >= len(want):
                    raise ValueError(
                        f"step {step}: array {key!r} (shard {k}) has no "
                        "recorded digest")
                if _digest(arr) != int(want[k]):
                    raise ValueError(
                        f"step {step}: digest mismatch for {key!r} in "
                        f"{os.path.basename(path)}")
        parts.append(shard)
    if n == 1:
        data = dict(parts[0])
    else:
        # merge of an fsdp-sharded save: concatenate along the recorded
        # dim (the merged arrays do not depend on the saving mesh shape)
        data = {}
        for key in parts[0]:
            if key in dims:
                data[key] = np.concatenate(
                    [p[key] for p in parts if key in p], axis=int(dims[key]))
            else:
                data[key] = parts[0][key]
    ranks = meta.get("ranks")
    if ranks:
        # sample-sharded leaves of a multi-process step: digest-verify
        # every rank block and merge in global (start) order
        p = int(ranks["count"])
        per_rank = []
        for r in range(p):
            with np.load(_rank_file(directory, step, r, p)) as f:
                per_rank.append({key: f[key] for key in f.files})
        for key, info in ranks["arrays"].items():
            blocks = []
            for part in info["parts"]:
                arr = per_rank[int(part["rank"])].get(key)
                if arr is None:
                    raise ValueError(
                        f"step {step}: array {key!r} missing from rank "
                        f"{part['rank']} file")
                if _digest(arr) != int(part["digest"]):
                    raise ValueError(
                        f"step {step}: digest mismatch for {key!r} in rank "
                        f"{part['rank']} file")
                blocks.append(arr)
            data[key] = (np.concatenate(blocks, axis=int(info["dim"]))
                         if len(blocks) > 1 else blocks[0])
    return data, meta


def read_metadata(directory: str, step: int) -> Dict:
    """The user metadata dict of one step's sidecar, without reading any
    array bytes; raises ``FileNotFoundError`` when the sidecar is absent
    or unparseable."""
    meta = _read_meta(directory, step)
    if meta is None:
        raise FileNotFoundError(
            f"no readable sidecar for step {step} in {directory}")
    return dict(meta.get("metadata", {}))


def verify_step(directory: str, step: int) -> bool:
    try:
        _load_verified(directory, step)
        return True
    except Exception:  # any damage: truncation, bad zip, digest
        return False


def latest_step(directory: str) -> Optional[int]:
    """Newest step that verifies (the ``latest`` marker is a hint)."""
    candidates = set(available_steps(directory))
    try:
        with open(os.path.join(directory, "latest")) as f:
            candidates.add(int(f.read().strip()))
    except (OSError, ValueError):
        pass
    for step in sorted(candidates, reverse=True):
        if verify_step(directory, step):
            return step
    return None


def _load(directory: str, step: Optional[int]):
    """Explicit ``step``: exactly that step.  ``None``: the newest step
    that loads and verifies, falling back past damaged ones."""
    if step is not None:
        data, meta = _load_verified(directory, step)
        return data, step, meta
    tried = []
    for cand in sorted(available_steps(directory), reverse=True):
        try:
            data, meta = _load_verified(directory, cand)
            return data, cand, meta
        except Exception as e:  # demoted: fall back to the next-newest
            tried.append(f"step {cand}: {e}")
    detail = "; ".join(tried) if tried else f"no checkpoint in {directory}"
    raise FileNotFoundError(
        f"no restorable checkpoint in {directory} ({detail})")


def _fill(tree_like: Any, data, key_prefix: str = "") -> Any:
    out = {}
    for path, leaf in flatten(tree_like).items():
        key = key_prefix + path
        arr = data[key]
        if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        out[path] = arr
    return unflatten(out)


def restore(directory: str, tree_like: Any,
            step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (leaves with a
    ``.shape``, e.g. meta tensors).  Returns (tree of numpy arrays,
    step, metadata)."""
    data, step, meta = _load(directory, step)
    return _fill(tree_like, data), step, meta["metadata"]


def restore_subtree(directory: str, tree_like: Any, prefix: str,
                    step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore only the sub-tree saved under top-level key ``prefix``
    (e.g. ``"params"`` of a train-state checkpoint)."""
    data, step, meta = _load(directory, step)
    pre = f"{prefix}/" if prefix else ""
    return _fill(tree_like, data, pre), step, meta["metadata"]
