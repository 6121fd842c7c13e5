"""Metric primitives shared by the zero-shot classifier and retrieval
(port of ``repro.eval.metrics``).

Deterministic tie rule (the exactness contract of the whole eval engine):
every top-k selection orders candidates by **(score descending, index
ascending)**.  The JAX package sorts the pair ``(-score, index)``
lexicographically; here one stable ``torch.sort`` of ``-score`` over
candidates laid out in ascending index gives the same order (never
``torch.topk``, which orders ties arbitrarily).  Top-k under a fixed total
order is a *selection*, so the streaming chunked scan in
``repro_torch.eval.retrieval`` equals the dense oracle here bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import losses as LS
from repro_torch.kernels.gcl_loss import gcl_pair_stats


def lex_topk(scores: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense top-k oracle under the (score desc, index asc) tie rule.

    scores: (b, n).  Returns (top_scores (b, k) f32, top_idx (b, k)
    int64).  Materialises the full (b, n) score matrix: the streaming scan
    in ``repro_torch.eval.retrieval`` is the production path; this is the
    exact reference it is tested against."""
    k = min(k, scores.shape[1])
    neg, idx = torch.sort(-scores.float(), dim=-1, stable=True)
    return -neg[:, :k], idx[:, :k]


def recall_at_k(top_idx: torch.Tensor, gold: torch.Tensor,
                ks: Sequence[int], valid: Optional[torch.Tensor] = None,
                prefix: str = "r@") -> dict:
    """R@k from ranked candidate indices.

    top_idx: (b, k_max) indices ordered best-first; gold: (b,) the correct
    index per row; valid: optional (b,) bool mask (padded rows excluded
    from the mean).  Returns {f"{prefix}{k}": 0-dim f32 tensor}: exact 0/1
    hits summed and divided in f32, as the JAX package does."""
    hits = top_idx == gold[:, None].to(top_idx.device)
    if valid is None:
        w = None
        denom = torch.tensor(float(top_idx.shape[0]), dtype=torch.float32,
                             device=top_idx.device)
    else:
        w = valid.to(top_idx.device).float()
        denom = torch.clamp_min(w.sum(), 1.0)
    out = {}
    for k in ks:
        kk = min(k, top_idx.shape[1])
        got = hits[:, :kk].any(dim=1).float()
        out[f"{prefix}{k}"] = (got if w is None else got * w).sum() / denom
    return out


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5),
                  valid: Optional[torch.Tensor] = None) -> dict:
    """Top-k classification accuracy under the shared tie rule.

    logits: (b, C); labels: (b,) int.  Returns {f"top{k}": scalar}."""
    _, idx = lex_topk(logits, max(ks))
    return recall_at_k(idx, labels, ks, valid=valid, prefix="top")


def contrastive_eval_loss(e1n, e2n, tau=0.07, *, loss_impl="dense"):
    """The GCL batch value over an eval set, log-domain (exact at any
    tau): mean_i tau * log(mean_{j!=i} exp(z_ij)) averaged over both
    sides.  ``loss_impl`` mirrors the training knob: "dense" builds the
    (N, N) pair matrix through ``losses.row_stats``, "fused" streams it
    through K1 (``kernels.gcl_loss.gcl_pair_stats``, square form; its
    plain version for CPU tensors).  Returns a 0-dim f32 tensor."""
    n = e1n.shape[0]
    t = torch.full((n,), tau, dtype=torch.float32, device=e1n.device)
    if loss_impl == "fused":
        stats = LS.RowStats(*gcl_pair_stats(e1n, e2n, t, t))
    elif loss_impl == "dense":
        stats = LS.row_stats(e1n, e2n, e1n, e2n, t, t)
    else:
        raise ValueError(f"loss_impl must be 'dense' or 'fused', "
                         f"got {loss_impl!r}")
    lg1, lg2 = LS.log_g(stats)
    return 0.5 * (torch.mean(t * lg1) + torch.mean(t * lg2))
