"""The FCCO loss engine (port of ``repro.core.distributed``):
``make_fcco_loss_op`` on one device (``axes=None``) or over mesh axes,
the dense closed-form backward ``_dense_local_grads``, and the
DDP-style baselines ``make_allgather_ad_pair_loss`` and
``make_mbcl_loss``.

The op is one ``torch.autograd.Function``.  Its forward computes the row
stats exactly once (K1, ``kernels.gcl_loss.gcl_pair_stats``, with
``loss_impl="fused"``; dense torch with ``"dense"``), then the log-domain
u update, the log-domain FCCO weights, the per-row saturation indicator
and the surrogate.  Its backward is the closed form (Appendix A): K2
(``gcl_pair_grads``) or ``_dense_local_grads``.  Every backward exponent
is ``z_ij + lwt_i = z_ij - log(eps + u_i) <= log(B / gamma)``, so the
gradients of the unclamped objective are exact in f32.

With ``axes`` (the paper's communication-efficient reduction) each rank
holds its local rows; the forward all-gathers the normalised features
over the axes (``gather_axes``, forward only) and the O(K|B|) scalars
the backward needs (s_ii, the log-domain weights, the taus); K1 and K2
run in their rectangular form, local rows against the gathered columns
with ``row_offset = global_rank * b``; the backward emits the local
feature gradients in closed form and no collective.  JAX runs this
inside ``shard_map`` with every device of the mesh in one process; here
each rank is a process and the collectives are ``torch.distributed``'s
over the mesh's subgroups (``launch.mesh``).

The baselines differentiate through the gather instead
(``_GatherAxes``: its backward reduce-scatters the (B, d) feature
gradients), the OpenCLIP/DDP pattern the paper improves on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import losses as LS
from repro_torch.core import shard_state as SS
from repro_torch.core.shard_state import gather_axes
from repro_torch.kernels.gcl_loss import gcl_pair_grads, gcl_pair_stats
from repro_torch.launch.mesh import Mesh, current_mesh


def _global_index(axes, mesh: Optional[Mesh] = None) -> int:
    """Flattened index of this rank over possibly several mesh axes."""
    mesh = mesh or current_mesh()
    idx = 0
    for ax in axes:
        idx = idx * mesh.axis_size(ax) + mesh.axis_index(ax)
    return idx


def axis_prod(axes, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    out = 1
    for ax in axes:
        out *= mesh.axis_size(ax)
    return out



class _Psum(torch.autograd.Function):
    """All-reduce over the axes; backward: the identity.  The summed
    value is replicated, each rank differentiates its own copy, so the
    cotangent reaching a rank's summand is the loss's own (JAX's
    replicated-cotangent convention for the mean-mode loss)."""

    @staticmethod
    def forward(ctx, x, axes):
        return SS.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAxes(torch.autograd.Function):
    """``gather_axes`` with autograd: the backward reduce-scatters the
    (B, d) cotangent back to this rank's rows (summed over the ranks),
    first axis first, the transpose of the gather order."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return gather_axes(x, axes)

    @staticmethod
    def backward(ctx, g):
        for ax in ctx.axes:
            g = SS.reduce_scatter_dim(g, ax, 0)
        return g, None


def _dense_local_grads(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a,
                       t1, t2, t1a, t2a, off):
    """(de1, de2) of L = (1/B) sum_i w1_i g1_i + w2_i g2_i w.r.t. the local
    rows, from local (b,) and gathered (B,) quantities, with ``lwt* =
    log(w*) - log(tau*)``.  Includes 1/(B(B-1)); the caller scales by the
    cotangent.  Builds four dense (b, B) matrices (K2 avoids them)."""
    b = e1.shape[0]
    B = e1a.shape[0]
    dev = e1.device
    rows = off + torch.arange(b, device=dev)
    cols = torch.arange(B, device=dev)
    offdiag = (cols[None, :] != rows[:, None]).float()
    kappa = 1.0 / (B * (B - 1.0))
    s1 = e1.float() @ e2a.float().T
    s2 = e2.float() @ e1a.float().T
    gexp = LS.guarded_exp
    A1r = gexp((s1 - sd[:, None]) / t1[:, None] + lwt1[:, None]) * offdiag
    A2r = gexp((s2 - sd[:, None]) / t2[:, None] + lwt2[:, None]) * offdiag
    # local columns: M1[p, i] = A1[i, p], and e1_i.e2_p is s2[p, i]
    M1 = gexp((s2 - sda[None, :]) / t1a[None, :] + lwt1a[None, :]) * offdiag
    M2 = gexp((s1 - sda[None, :]) / t2a[None, :] + lwt2a[None, :]) * offdiag
    e1f, e2f = e1.float(), e2.float()
    e1af, e2af = e1a.float(), e2a.float()
    de1 = (A1r @ e2af - A1r.sum(dim=1, keepdim=True) * e2f
           + M2 @ e2af - A2r.sum(dim=1, keepdim=True) * e2f)
    de2 = (A2r @ e1af - A2r.sum(dim=1, keepdim=True) * e1f
           + M1 @ e1af - A1r.sum(dim=1, keepdim=True) * e1f)
    return kappa * de1, kappa * de2


class _FCCOLoss(torch.autograd.Function):
    """forward(e1, e2, lu1r, lu2r, t1v, t2v, gamma, eps, scale_by_tau,
    loss_impl, axes) -> (local, lu1n, lu2n, g1, g2, dg1, dg2, m1, m2,
    sat), where ``local`` is this rank's unreduced sum; only e1/e2 get
    gradients."""

    @staticmethod
    def forward(ctx, e1, e2, lu1r, lu2r, t1v, t2v, gamma, eps, scale_by_tau,
                loss_impl, axes):
        b = e1.shape[0]
        if axes:
            off = _global_index(axes) * b
            e1a = gather_axes(e1, axes)        # feature gather (fwd only)
            e2a = gather_axes(e2, axes)
        else:
            off, e1a, e2a = 0, e1, e2
        if loss_impl == "fused":
            stats = LS.RowStats(*gcl_pair_stats(
                e1, e2, t1v, t2v, e1_all=e1a if axes else None,
                e2_all=e2a if axes else None, row_offset=off))
        else:
            stats = LS.row_stats(e1, e2, e1a, e2a, t1v, t2v, row_offset=off)
        lg1, lg2 = LS.log_g(stats)
        lu1n = LS.update_log_u(lu1r, lg1, gamma)
        lu2n = LS.update_log_u(lu2r, lg2, gamma)
        lw1, lw2 = LS.fcco_log_weights(lu1n, lu2n, t1v, t2v, eps,
                                       scale_by_tau=scale_by_tau)
        sat = LS.saturation_rate(stats, lw1, lw2, t1v, t2v)
        local = LS.surrogate_loss(stats, lw1, lw2, 1.0)
        sd = torch.sum(e1.float() * e2.float(), dim=-1)
        lwt1 = lw1 - torch.log(t1v)
        lwt2 = lw2 - torch.log(t2v)
        if axes:
            # the O(K|B|) scalar gather for the backward (paper section 4)
            sda, lwt1a, lwt2a, t1a, t2a = (gather_axes(v, axes) for v in (
                sd, lwt1, lwt2, t1v, t2v))
            ctx.save_for_backward(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2,
                                  lwt1a, lwt2a, t1v, t2v, t1a, t2a)
        else:
            ctx.save_for_backward(e1, e2, sd, lwt1, lwt2, t1v, t2v)
        ctx.loss_impl, ctx.axes, ctx.off = loss_impl, axes, off
        outs = (lu1n, lu2n, *stats, sat)
        ctx.mark_non_differentiable(*outs)
        return (local, *outs)

    @staticmethod
    def backward(ctx, ct, *_):
        if ctx.axes:
            (e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1v, t2v,
             t1a, t2a) = ctx.saved_tensors
        else:
            e1, e2, sd, lwt1, lwt2, t1v, t2v = ctx.saved_tensors
            e1a, e2a, sda, lwt1a, lwt2a, t1a, t2a = (e1, e2, sd, lwt1, lwt2,
                                                     t1v, t2v)
        B = e1a.shape[0]
        if ctx.loss_impl == "fused":
            kw = {}
            if ctx.axes:
                kw = dict(e1_all=e1a, e2_all=e2a, sd_all=sda,
                          lwt1_all=lwt1a, lwt2_all=lwt2a, tau1_all=t1a,
                          tau2_all=t2a, row_offset=ctx.off)
            de1, de2 = gcl_pair_grads(e1, e2, lwt1, lwt2, t1v, t2v, **kw)
        else:
            de1, de2 = _dense_local_grads(e1, e2, e1a, e2a, sd, sda, lwt1,
                                          lwt2, lwt1a, lwt2a, t1v, t2v, t1a,
                                          t2a, ctx.off)
        # de* are grads of the global mean loss; the op returns local / B,
        # whose cotangent carries the 1/B
        scale = ct * B
        return ((scale * de1).to(e1.dtype), (scale * de2).to(e2.dtype),
                None, None, None, None, None, None, None, None, None)


def make_fcco_loss_op(axes, eps, scale_by_tau=True, *, loss_impl="dense",
                      reduce="mean"):
    """Returns op(e1n, e2n, lu1_rows, lu2_rows, t1, t2, gamma) ->
    (loss, (lu1_new_rows, lu2_new_rows, RowStats(g1, g2, dg1, dg2, m1,
    m2), sat)), the whole FCCO step of one batch.  ``lu*_rows`` are
    log(u) (init -inf); t1/t2 scalars or (b,) per-row taus; the stats
    are shift-decomposed; ``sat`` is the per-row guard indicator.
    ``loss_impl``: "dense" (torch pair matrices) or "fused" (K1/K2).

    ``axes=None``: one device.  With ``axes`` (mesh axis names of the
    current mesh) the inputs are this rank's rows; ``reduce="mean"``
    returns the global mean loss (all-reduced, outside the differentiated
    op); ``reduce="local"`` returns this rank's ``local / B`` with no
    collective in the differentiated region, and the caller reduces it
    for the metric (the sharded train step)."""
    axes = tuple(axes) if axes else ()
    if loss_impl not in ("dense", "fused"):
        raise ValueError(f"loss_impl must be 'dense' or 'fused', "
                         f"got {loss_impl!r}")
    if reduce not in ("mean", "local"):
        raise ValueError(f"reduce must be 'mean' or 'local', got {reduce!r}")

    def op(e1, e2, lu1r, lu2r, t1, t2, gamma):
        b = e1.shape[0]
        dev = e1.device
        t1v = torch.as_tensor(t1, dtype=torch.float32,
                              device=dev).detach().broadcast_to((b,))
        t2v = torch.as_tensor(t2, dtype=torch.float32,
                              device=dev).detach().broadcast_to((b,))
        gammav = torch.as_tensor(gamma, dtype=torch.float32,
                                 device=dev).detach()
        local, lu1n, lu2n, *rest = _FCCOLoss.apply(
            e1, e2, lu1r.detach(), lu2r.detach(), t1v.contiguous(),
            t2v.contiguous(), gammav, eps, scale_by_tau, loss_impl, axes)
        *stats, sat = rest
        B = b * (axis_prod(axes) if axes else 1)
        aux = (lu1n, lu2n, LS.RowStats(*stats), sat)
        if reduce == "local" or not axes:
            return local / B, aux
        return _Psum.apply(local, axes) / B, aux

    return op


# ---------------------------------------------------------------------------
# OpenCLIP-style baselines: autograd through the feature gather
# ---------------------------------------------------------------------------

def make_allgather_ad_pair_loss(axes: Sequence[str], reduce: str = "mean"):
    """f(e1, e2, lw1, lw2, t1, t2) -> (loss, stats): the same surrogate
    differentiated straight through the gather, whose backward is a
    reduce-scatter of the (B, d) feature gradients (DDP-style)."""
    axes = tuple(axes)

    def with_stats(e1, e2, lw1, lw2, t1, t2):
        b = e1.shape[0]
        B = b * axis_prod(axes)
        off = _global_index(axes) * b
        e1a = _GatherAxes.apply(e1, axes)
        e2a = _GatherAxes.apply(e2, axes)
        stats = LS.row_stats(e1, e2, e1a, e2a, t1, t2, row_offset=off)
        local = LS.surrogate_loss(stats, lw1.detach(), lw2.detach(), 1.0)
        stats = LS.RowStats(*(v.detach() for v in stats))
        if reduce == "local":
            return local / B, stats
        return _Psum.apply(local, axes) / B, stats

    return with_stats


def make_mbcl_loss(axes: Sequence[str], reduce: str = "mean"):
    """OpenCLIP objective (MBCL) over gathered features, autograd comms.
    ``reduce="local"`` returns this rank's mean contribution (no
    collective in the differentiated region; the feature gradients still
    reduce-scatter through the gather)."""
    axes = tuple(axes)

    def loss_fn(e1, e2, tau):
        b = e1.shape[0]
        off = _global_index(axes) * b
        e1a = _GatherAxes.apply(e1, axes)
        e2a = _GatherAxes.apply(e2, axes)
        B = e1a.shape[0]
        s1 = (e1.float() @ e2a.float().T) / tau     # local images vs texts
        s2 = (e2.float() @ e1a.float().T) / tau     # local texts vs images
        labels = off + torch.arange(b, device=e1.device)

        def ce(s):
            gold = s.gather(1, labels[:, None])[:, 0]
            return torch.sum(torch.logsumexp(s, dim=1) - gold)
        local = 0.5 * (ce(s1) + ce(s2))
        if reduce == "local":
            return local / B
        return _Psum.apply(local, axes) / B

    return loss_fn
