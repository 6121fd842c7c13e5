"""``fused_gcl_loss``: the loss kernels as one differentiable scalar loss
(port of ``repro.kernels.ops``), square single-device case with fixed
log-domain weights.  The forward launches K1 (``gcl_pair_stats``), the
backward K2 (``gcl_pair_grads``); on CPU tensors both take their plain
versions.  The production path is ``repro_torch.core.distributed.
make_fcco_loss_op``, which drives the same kernels with the FCCO updates
inside the op."""
from __future__ import annotations

import torch

from repro_torch.core import losses as LS
from repro_torch.kernels.gcl_loss import gcl_pair_grads, gcl_pair_stats


class _FusedGCLLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e1n, e2n, lw1, lw2, tau1, tau2):
        stats = LS.RowStats(*gcl_pair_stats(e1n, e2n, tau1, tau2))
        loss = LS.surrogate_loss(stats, lw1, lw2, e1n.shape[0])
        ctx.save_for_backward(e1n, e2n, lw1, lw2, tau1, tau2)
        ctx.mark_non_differentiable(*stats)
        return (loss, *stats)

    @staticmethod
    def backward(ctx, ct, *_):
        e1n, e2n, lw1, lw2, tau1, tau2 = ctx.saved_tensors
        de1, de2 = gcl_pair_grads(e1n, e2n, lw1 - torch.log(tau1),
                                  lw2 - torch.log(tau2), tau1, tau2)
        return ((ct * de1).to(e1n.dtype), (ct * de2).to(e2n.dtype),
                None, None, None, None)


def fused_gcl_loss(e1n, e2n, lw1, lw2, tau1, tau2):
    """L = (1/B) sum_i w1_i g1_i + w2_i g2_i with lw = log(w); e1n/e2n
    normalised (B, d), lw/tau (B,).  Returns (loss, (g1, g2, dg1, dg2,
    m1, m2)), the shift-decomposed stats (true g = exp(m) * g).  Only
    e1n/e2n get gradients."""
    loss, *stats = _FusedGCLLoss.apply(e1n, e2n, lw1.detach(), lw2.detach(),
                                       tau1.detach(), tau2.detach())
    return loss, tuple(stats)
