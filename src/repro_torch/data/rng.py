"""Per-sample counter-based RNG for index-addressable data.

The data-layer contract (ROADMAP: FCCO per-sample u state, resume
bit-identity, the chaos battery) is that sample ``i``'s content is a
pure function of ``(dataset seed, i)`` — never of which other samples
share its batch, or of the order batches were drawn in.  Per-batch
``RandomState(seed + idx[0])`` seeding violates that (the bug this
module replaces): the same global index yielded different bytes under
different batch compositions.

The fix is counter-based (Philox) keying:

  * a 128-bit **key** identifies the random stream — derived from the
    dataset seed plus a stream label (``"contrastive/images"``, ...)
    via ``SeedSequence`` so distinct datasets/fields never share a
    stream (no process-salted ``hash()`` anywhere);
  * sample ``i`` draws from counter block ``[0, 0, 0, i]`` — numpy's
    Philox counter is little-endian (draws increment word 0), so each
    sample owns 2**192 draws before any overlap, and generating sample
    ``i`` is O(1) regardless of batch composition — the property the
    streaming pipeline's on-the-fly decode/augment leans on.

Both the in-memory synthetic datasets and the streaming pipeline's
augment stage call the same helpers here, which is what makes a
materialized-then-augmented stream bit-identical to the in-memory
oracle.
"""
from __future__ import annotations

import zlib

import numpy as np


def stream_key(seed: int, stream: str) -> np.ndarray:
    """128-bit Philox key for the (dataset seed, stream label) pair.

    The label goes through crc32 (stable across processes, unlike
    ``hash``) into a ``SeedSequence`` so keys are well-mixed even for
    adjacent seeds."""
    ss = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, zlib.crc32(stream.encode("utf-8"))])
    return ss.generate_state(2, np.uint64)


def sample_generator(key, index: int) -> np.random.Generator:
    """The Generator owning global sample ``index``'s counter block."""
    return np.random.Generator(
        np.random.Philox(key=key, counter=[0, 0, 0, int(index)]))


def per_sample_normal(key, idx, shape, dtype=np.float32) -> np.ndarray:
    """(len(idx), *shape) standard normals; row j is a pure function of
    (key, idx[j]) — independent of the rest of ``idx``."""
    idx = np.asarray(idx).reshape(-1)
    out = np.empty((len(idx),) + tuple(shape), dtype)
    for j, i in enumerate(idx):
        out[j] = sample_generator(key, i).standard_normal(
            tuple(shape), dtype=dtype)
    return out


def add_gaussian_noise(base, scale: float, key, idx) -> np.ndarray:
    """``base + scale * N(0, 1)`` with per-sample counter-based noise.

    The single augment primitive shared by the in-memory datasets and
    the streaming pipeline's decode stage: identical (base, scale, key,
    idx) means identical bytes, whichever side computes it."""
    base = np.asarray(base)
    noise = per_sample_normal(key, idx, base.shape[1:], np.float32)
    return base + np.float32(scale) * noise
