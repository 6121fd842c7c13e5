"""Checkpoints in the JAX package's on-disk format.

A step is ``ckpt_XXXXXXXX.npz`` (``np.savez_compressed``, one array per
leaf, keyed by its ``/``-joined path such as ``params/vision/blocks/
attn/wq``) plus the sidecar ``ckpt_XXXXXXXX.json`` with ``order``,
``metadata``, per-leaf CRC32 ``digests`` and, for an fsdp-sharded save,
``shards`` (``ckpt_XXXXXXXX.shardKKofNN.npz`` files merged here along
the recorded dim).  A ``latest`` marker names the newest step.  Every
write goes tmp-file then ``os.replace``, in the order arrays, sidecar,
marker, so a crash leaves the previous step intact.  A checkpoint the
JAX package wrote restores here and the reverse.

Trees are nested ``dict``s (sorted key order, as JAX flattens them)
whose leaves are numpy arrays or tensors; restores return numpy arrays.
Multi-process (rank-tagged) checkpoints are not read by this port yet.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.(npz|json)$")


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {path: leaf}, keys sorted at every level."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _digest(arr: np.ndarray) -> int:
    """CRC32 over dtype + shape + raw bytes (the JAX package's recipe)."""
    a = np.ascontiguousarray(arr)
    h = zlib.crc32(str((a.dtype.str, a.shape)).encode())
    return zlib.crc32(a.tobytes(), h)


def _atomic_replace(path: str, write_fn) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _shard_file(directory: str, step: int, k: int, n: int) -> str:
    return os.path.join(directory,
                        f"ckpt_{step:08d}.shard{k:02d}of{n:02d}.npz")


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


def save(directory: str, tree: Any, step: int,
         metadata: Optional[Dict] = None) -> str:
    """Single-file save of a nested dict of arrays/tensors.  Returns the
    npz path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    path_npz = os.path.join(directory, f"ckpt_{step:08d}.npz")

    def write_npz(tmp):
        # through a handle: savez would append ".npz" to the tmp name
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)

    _atomic_replace(path_npz, write_npz)
    meta = {"step": step, "order": list(arrays), "metadata": metadata or {},
            "digests": {k: [_digest(a)] for k, a in arrays.items()}}

    def write_json(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _atomic_replace(os.path.join(directory, f"ckpt_{step:08d}.json"),
                    write_json)

    def write_latest(tmp):
        with open(tmp, "w") as f:
            f.write(str(step))

    _atomic_replace(os.path.join(directory, "latest"), write_latest)
    return path_npz


def _is_complete(directory: str, step: int) -> bool:
    meta = _read_meta(directory, step)
    if meta is None:
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
    if meta.get("ranks"):
        raise ValueError(
            f"step {step} is a multi-process (rank-tagged) checkpoint, "
            "which this port does not read yet")
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
        return parts[0], meta
    # merge of an fsdp-sharded save: concatenate along the recorded dim
    data = {}
    for key in parts[0]:
        if key in dims:
            data[key] = np.concatenate([p[key] for p in parts if key in p],
                                       axis=int(dims[key]))
        else:
            data[key] = parts[0][key]
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
