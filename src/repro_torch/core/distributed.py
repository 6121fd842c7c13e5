"""The FCCO loss engine (port of ``repro.core.distributed``, the
single-device part): ``make_fcco_loss_op`` with ``axes=None`` and the
dense closed-form backward ``_dense_local_grads``.

The op is one ``torch.autograd.Function``.  Its forward computes the row
stats exactly once (K1, ``kernels.gcl_loss.gcl_pair_stats``, with
``loss_impl="fused"``; dense torch with ``"dense"``), then the log-domain
u update, the log-domain FCCO weights, the per-row saturation indicator
and the surrogate.  Its backward is the closed form (Appendix A): K2
(``gcl_pair_grads``) or ``_dense_local_grads``.  Every backward exponent
is ``z_ij + lwt_i = z_ij - log(eps + u_i) <= log(B / gamma)``, so the
gradients of the unclamped objective are exact in f32.

The mesh form (``axes``: the feature gather, the O(K|B|) scalar gather,
and the ``reduce`` choice), ``make_allgather_ad_pair_loss`` and
``make_mbcl_loss`` come with the mesh slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.core import losses as LS
from repro_torch.kernels.gcl_loss import gcl_pair_grads, gcl_pair_stats


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
    loss_impl) -> (local, lu1n, lu2n, g1, g2, dg1, dg2, m1, m2, sat), where
    ``local`` is the unreduced sum; only e1/e2 get gradients."""

    @staticmethod
    def forward(ctx, e1, e2, lu1r, lu2r, t1v, t2v, gamma, eps, scale_by_tau,
                loss_impl):
        if loss_impl == "fused":
            stats = LS.RowStats(*gcl_pair_stats(e1, e2, t1v, t2v))
        else:
            stats = LS.row_stats(e1, e2, e1, e2, t1v, t2v)
        lg1, lg2 = LS.log_g(stats)
        lu1n = LS.update_log_u(lu1r, lg1, gamma)
        lu2n = LS.update_log_u(lu2r, lg2, gamma)
        lw1, lw2 = LS.fcco_log_weights(lu1n, lu2n, t1v, t2v, eps,
                                       scale_by_tau=scale_by_tau)
        sat = LS.saturation_rate(stats, lw1, lw2, t1v, t2v)
        local = LS.surrogate_loss(stats, lw1, lw2, 1.0)
        sd = torch.sum(e1.float() * e2.float(), dim=-1)
        ctx.save_for_backward(e1, e2, sd, lw1 - torch.log(t1v),
                              lw2 - torch.log(t2v), t1v, t2v)
        ctx.loss_impl = loss_impl
        outs = (lu1n, lu2n, *stats, sat)
        ctx.mark_non_differentiable(*outs)
        return (local, *outs)

    @staticmethod
    def backward(ctx, ct, *_):
        e1, e2, sd, lwt1, lwt2, t1v, t2v = ctx.saved_tensors
        B = e1.shape[0]
        if ctx.loss_impl == "fused":
            de1, de2 = gcl_pair_grads(e1, e2, lwt1, lwt2, t1v, t2v)
        else:
            de1, de2 = _dense_local_grads(e1, e2, e1, e2, sd, sd, lwt1, lwt2,
                                          lwt1, lwt2, t1v, t2v, t1v, t2v, 0)
        # de* are grads of the mean loss; the op returns local / B, whose
        # cotangent carries the 1/B
        scale = ct * B
        return ((scale * de1).to(e1.dtype), (scale * de2).to(e2.dtype),
                None, None, None, None, None, None, None, None)


def make_fcco_loss_op(axes, eps, scale_by_tau=True, *, loss_impl="dense"):
    """Returns op(e1n, e2n, lu1_rows, lu2_rows, t1, t2, gamma) ->
    (loss, (lu1_new_rows, lu2_new_rows, RowStats(g1, g2, dg1, dg2, m1,
    m2), sat)), the whole FCCO step of one batch.  ``lu*_rows`` are
    log(u) (init -inf); t1/t2 scalars or (b,) per-row taus; the stats
    are shift-decomposed; ``sat`` is the per-row guard indicator.
    ``loss_impl``: "dense" (torch pair matrices) or "fused" (K1/K2).
    Single device only (``axes=None``)."""
    if axes:
        raise NotImplementedError(
            "the sharded loss op (axes) is not ported yet; it comes with "
            "the mesh slice")
    if loss_impl not in ("dense", "fused"):
        raise ValueError(f"loss_impl must be 'dense' or 'fused', "
                         f"got {loss_impl!r}")

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
            t2v.contiguous(), gammav, eps, scale_by_tau, loss_impl)
        *stats, sat = rest
        # one device: the local sum is the global one
        return local / b, (lu1n, lu2n, LS.RowStats(*stats), sat)

    return op
