"""Resolution / token-length curricula over the host batch stream (the
port's own copy of ``repro.data.curriculum``, which imports no JAX: the
same schedule and batch give the same bytes).

The two highest-leverage throughput tricks from the related work
(PAPERS.md) as step-keyed schedules applied host-side, so they compose
with any dataset (in-memory or streaming) and cost nothing on device:

  * RECLIP-style small-image training: train most steps at a reduced
    resolution, step the resolution up on a schedule.  Images shrink by
    **block-mean pooling** (exact area average — the inverse of the
    synthetic datasets' block upsampling, and the same pooling the ViT
    applies to its positional-embedding grid), so the scheduled sizes
    must divide the stored size.
  * inverse-scaling-law token/patch-length reduction: truncate the text
    context to a scheduled length (the towers slice their positional
    embeddings to the input length).

A schedule is ``"STEP:VALUE[,STEP:VALUE...]"`` — the value at step s is
the entry with the largest STEP <= s (the first entry must be step 0).
Each distinct (image size, context length) stage is a new input shape
for the towers (on the card: new sequence lengths for the attention
kernel).  The loader's index stream and the FCCO u ownership
are untouched — the curriculum transforms batch *content* only, after
the (indices, batch) contract is already fixed.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Schedule = List[Tuple[int, int]]


def parse_schedule(spec: Optional[str]) -> Optional[Schedule]:
    """``"0:16,300:32"`` -> [(0, 16), (300, 32)]; None/"" -> None."""
    if not spec:
        return None
    out: Schedule = []
    for part in spec.split(","):
        try:
            step, value = part.strip().split(":")
            out.append((int(step), int(value)))
        except ValueError:
            raise ValueError(
                f"unparseable schedule entry {part!r} in {spec!r} "
                "(want STEP:VALUE[,STEP:VALUE...])")
    out.sort()
    if out[0][0] != 0:
        raise ValueError(
            f"schedule {spec!r} must define a value at step 0")
    if len({s for s, _ in out}) != len(out):
        raise ValueError(f"schedule {spec!r} has duplicate steps")
    return out


def schedule_value(sched: Optional[Schedule], step: int) -> Optional[int]:
    """The value in force at ``step`` (None when no schedule)."""
    if not sched:
        return None
    value = sched[0][1]
    for s, v in sched:
        if s <= step:
            value = v
        else:
            break
    return value


def shrink_images(images: np.ndarray, size: int) -> np.ndarray:
    """(B, H, W, C) -> (B, size, size, C) by exact block-mean pooling.
    ``H``/``W`` must be divisible by ``size`` (deterministic, no
    resampling filter ambiguity)."""
    b, h, w, c = images.shape
    if (h, w) == (size, size):
        return images
    if h % size or w % size:
        raise ValueError(
            f"curriculum image size {size} must divide the stored size "
            f"({h}x{w})")
    fh, fw = h // size, w // size
    x = images.reshape(b, size, fh, size, fw, c)
    return x.mean(axis=(2, 4), dtype=images.dtype)


def truncate_tokens(tokens: np.ndarray, length: int) -> np.ndarray:
    """(B, S) -> (B, length): keep the context prefix."""
    if length >= tokens.shape[1]:
        return tokens
    return tokens[:, :length]


def apply_curriculum(batch: dict, step: int,
                     image_sched: Optional[Schedule] = None,
                     context_sched: Optional[Schedule] = None) -> dict:
    """Apply the schedules in force at ``step`` to a host batch (a new
    dict; untouched fields pass through by reference)."""
    if not image_sched and not context_sched:
        return batch
    out = dict(batch)
    size = schedule_value(image_sched, step)
    if size is not None and "images" in out:
        out["images"] = shrink_images(out["images"], size)
    ctx = schedule_value(context_sched, step)
    if ctx is not None and "texts" in out:
        out["texts"] = truncate_tokens(out["texts"], ctx)
    return out
