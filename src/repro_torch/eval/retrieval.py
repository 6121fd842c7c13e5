"""Exact global image<->text retrieval by a streaming chunked top-k scan
(port of ``repro.eval.retrieval``, single device).

Memory contract: the (N_rows, N_cols) similarity matrix is **never
materialised**.  Columns stream through the scan in chunks of ``chunk``:
each step computes one (rows, chunk) similarity block with one plain
``rows @ block.T`` (a product outside any kernel in the JAX package
too), merges it into the running per-row top-k carry by one stable sort
of the (k + chunk) candidates' negated scores, and truncates back to k.
Peak live intermediate is O(rows * (k + chunk)), independent of N_cols.

Exactness: the carry holds earlier chunks' columns, all of lower index
than the block's, in (score desc, index asc) order, so the candidates
are laid out in ascending index among equal scores and the stable sort
is the (score desc, index asc) order of ``repro_torch.eval.metrics``:
the scan equals the dense ``lex_topk`` oracle bit for bit, for any chunk
size, given bit-equal similarity blocks.  Invalid columns (past
``n_cols``) get the key (+inf, N) and can never be selected.

The sharded forms of the JAX module (``make_sharded_topk``,
``sharded_retrieval_topk``, ``sharded_retrieval_recalls``) come with the
port's mesh.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.eval import metrics as M

CHUNK = 1024     # default column-chunk size of the streaming scan


def streaming_topk(rows, cols, k, *, chunk=CHUNK, n_cols=None):
    """Per-row top-k of ``rows @ cols.T`` without materialising it.

    rows: (b, d); cols: (Np, d) on the same device, possibly padded:
    ``n_cols`` gives the number of valid columns (default: all).  Returns
    (scores (b, k) f32, idx (b, k) int64) ordered by (score desc, index
    asc)."""
    b = rows.shape[0]
    n_all = int(cols.shape[0])
    N = n_all if n_cols is None else int(n_cols)
    k = min(k, N)
    rows = rows.float()
    cols = cols.float()
    dev = rows.device
    neg_c = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
    idx_c = torch.full((b, k), N, dtype=torch.int64, device=dev)
    for start in range(0, n_all, chunk):
        block = cols[start:start + chunk]
        ids = start + torch.arange(block.shape[0], device=dev)
        ok = ids < N
        s = (rows @ block.T).neg_()
        if start + block.shape[0] > N:
            s.masked_fill_(~ok, float("inf"))
        cand = torch.cat([neg_c, s], dim=1)
        del s
        neg, order = torch.sort(cand, dim=1, stable=True)
        del cand
        # candidate position -> column index for the k kept only (no
        # (b, k + chunk) index array): the carry's first, then the block's
        pos = order[:, :k]
        blk = (pos - k).clamp_min(0)
        idx_c = torch.where(pos >= k,
                            torch.where(ok[blk], start + blk, N),
                            torch.gather(idx_c, 1, pos.clamp_max(k - 1)))
        neg_c = neg[:, :k].contiguous()
        del neg, order
    return -neg_c, idx_c


def retrieval_topk(e1n, e2n, k, *, chunk=CHUNK):
    """Both retrieval directions, single device.  Returns
    ((s_i2t, i_i2t), (s_t2i, i_t2i)), each (N, k)."""
    return (streaming_topk(e1n, e2n, k, chunk=chunk),
            streaming_topk(e2n, e1n, k, chunk=chunk))


def retrieval_recalls(e1n, e2n, ks: Sequence[int] = (1, 5, 10), *,
                      chunk=CHUNK) -> dict:
    """Exact global R@k, both directions, gold = diagonal pairing.
    Returns {"i2t_r@k": ..., "t2i_r@k": ...} for each k."""
    N = e1n.shape[0]
    (_, i1), (_, i2) = retrieval_topk(e1n, e2n, min(max(ks), N),
                                      chunk=chunk)
    gold = torch.arange(N, device=i1.device)
    out = M.recall_at_k(i1, gold, ks, prefix="i2t_r@")
    out.update(M.recall_at_k(i2, gold, ks, prefix="t2i_r@"))
    return out
