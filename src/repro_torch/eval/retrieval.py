"""Exact global image<->text retrieval by a streaming chunked top-k scan
(port of ``repro.eval.retrieval``).

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

Sharded form: the loss engine's rectangular (local rows x gathered
columns) shape over the same mesh axes: each rank takes its block of
rows by sample ownership, all-gathers the column blocks
(``core.distributed.gather_axes``, global order) and streams its own
rows' scan; the per-row results depend only on the row and the gathered
columns, so the gathered output equals the single-device scan bit for
bit.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import distributed as DI
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


def make_sharded_topk(axes, k, *, chunk=CHUNK, n_cols=None, mesh=None):
    """For this rank of the mesh: local rows vs gathered columns.
    ``n_cols``: global number of *valid* columns (default: all gathered)
    so that zero pad rows are never candidates.  Returns fn(rows_local,
    cols_local) -> (scores, idx) for the local rows."""
    axes = tuple(axes)

    def fn(rows_local, cols_local):
        cols = DI.gather_axes(cols_local, axes, mesh)
        n = (cols_local.shape[0] * DI.axis_prod(axes, mesh)
             if n_cols is None else n_cols)
        return streaming_topk(rows_local, cols, k, chunk=chunk, n_cols=n)

    return fn


def sharded_retrieval_topk(mesh, axes, e1n, e2n, k, *, chunk=CHUNK,
                           n_valid=None):
    """Both directions over the mesh: every rank passes the same global
    (N, d) embeddings (N a multiple of the axes' product: pad upstream,
    ``n_valid`` excludes the pad rows from candidacy), scans its own
    block of rows against the gathered columns, and gets the global
    results back (gathered rows).  Equal to ``retrieval_topk`` bit for
    bit."""
    axes = tuple(axes)
    K = DI.axis_prod(axes, mesh)
    b = e1n.shape[0] // K
    lo = DI._global_index(axes, mesh) * b
    e1l, e2l = e1n[lo:lo + b], e2n[lo:lo + b]
    topk = make_sharded_topk(axes, k, chunk=chunk, n_cols=n_valid,
                             mesh=mesh)
    s1, i1 = topk(e1l, e2l)
    s2, i2 = topk(e2l, e1l)
    s1, i1, s2, i2 = (DI.gather_axes(x, axes, mesh) for x in (s1, i1, s2,
                                                              i2))
    return (s1, i1), (s2, i2)


def sharded_retrieval_recalls(mesh, axes, e1n, e2n,
                              ks: Sequence[int] = (1, 5, 10), *,
                              chunk=CHUNK) -> dict:
    """R@k via the sharded scan.  A ragged N is padded with zero rows up
    to the axes' product; pad rows are excluded from column candidacy
    and masked out of the recall means, so the valid rows' results equal
    the unpadded single-device scan's bit for bit."""
    N = e1n.shape[0]
    K = DI.axis_prod(tuple(axes), mesh)
    pad = (-N) % K
    if pad:
        z = torch.zeros((pad, e1n.shape[1]), dtype=e1n.dtype,
                        device=e1n.device)
        e1n, e2n = torch.cat([e1n, z]), torch.cat([e2n, z])
    (_, i1), (_, i2) = sharded_retrieval_topk(
        mesh, axes, e1n, e2n, min(max(ks), N), chunk=chunk, n_valid=N)
    gold = torch.arange(N + pad, device=i1.device)
    valid = gold < N
    out = M.recall_at_k(i1, gold, ks, valid=valid, prefix="i2t_r@")
    out.update(M.recall_at_k(i2, gold, ks, valid=valid, prefix="t2i_r@"))
    return out
