"""Contrastive losses (port of ``repro.core.losses``): MBCL (OpenCLIP
baseline), GCL / RGCL / RGCL-g with their FCCO estimators.

For normalised embeddings e1 (images) and e2 (texts), s[i, j] = e1_i.e2_j,
h1[i, j] = exp((s[i, j] - s[i, i]) / tau1_i), h2[i, j] = exp((s[j, i] -
s[i, i]) / tau2_i), g = mean over j != i.  The FCCO state u tracks g
across steps (eq. 1); the model gradient is that of the surrogate
(1/B) sum_i sg(w1_i) g1_i + sg(w2_i) g2_i with w_i = tau_i / (eps + u_i)
(1 / (eps + u_i) for v0).

Numerics (the log-sum-exp shift), as in the JAX package: row stats are
shift-decomposed (a stop-grad row max ``m`` and shifted sums, true
estimator ``exp(m) * g``), u is stored as log(u) with an exact log-domain
EMA, and the weights are log-domain, so nothing overflows f32 down to
tau_min = 0.01.  ``EXP_CLAMP`` is only the last-resort guard of
``guarded_exp``; ``saturation_rate`` counts where it would fire.
``.detach()`` stands exactly where the JAX package stops the gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Last-resort exponent guard (never fires on a healthy state).
EXP_CLAMP = 60.0

# Mask fill for row maxes (finite so that NEG - NEG == 0, not nan).
MASK_NEG = -1e30


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def guarded_exp(z: torch.Tensor) -> torch.Tensor:
    """exp with the exponent clamped at EXP_CLAMP."""
    return torch.exp(torch.clamp_max(z, EXP_CLAMP))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8
                 ) -> torch.Tensor:
    """f32 L2 normalisation, the norm clamped at ``eps``."""
    x = x.float()
    n = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp_min(n, eps)


def masked_shift(z, mask):
    """(m, h): ``m = max_j z[mask]`` (detached) and ``h = exp(z - m) *
    mask`` (<= 1, differentiable through the unmasked entries).  Fully
    masked rows give (MASK_NEG, 0)."""
    zm = torch.where(mask, z, MASK_NEG)
    m = zm.amax(dim=-1).detach()
    h = torch.where(mask, torch.exp(zm - m[..., None]), 0.0)
    return m, h


def lse_shift(z, mask):
    """(m, G) with ``G = sum_j exp(z - m)[mask]``: logsumexp = m + log G."""
    m, h = masked_shift(z, mask)
    return m, h.sum(dim=-1)


class RowStats(NamedTuple):
    """Shift-decomposed row statistics (true g = exp(m) * g).  g1/g2 are
    differentiable w.r.t. the embeddings; dg*/m* are detached."""
    g1: torch.Tensor
    g2: torch.Tensor
    dg1_dtau: torch.Tensor
    dg2_dtau: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor


def log_g(stats: RowStats):
    """(log g1^true, log g2^true)."""
    return (stats.m1 + torch.log(stats.g1), stats.m2 + torch.log(stats.g2))


def row_stats(e1_rows, e2_rows, e1_all, e2_all, tau1_rows, tau2_rows,
              row_offset=0, denom=None) -> RowStats:
    """Shift-decomposed batch estimators for a block of anchor rows
    against the (B, d) columns; ``row_offset`` is the global index of
    local row 0.  bf16 inputs are accumulated in f32."""
    b, B = e1_rows.shape[0], e2_all.shape[0]
    dev = e1_rows.device
    denom = float(denom if denom is not None else max(B - 1, 1))
    cols = torch.arange(B, device=dev)
    rows = row_offset + torch.arange(b, device=dev)
    offdiag = cols[None, :] != rows[:, None]
    t1 = _f32(tau1_rows, dev).broadcast_to((b,))
    t2 = _f32(tau2_rows, dev).broadcast_to((b,))
    sd = torch.sum(e1_rows.float() * e2_rows.float(), dim=-1)
    s1 = e1_rows.float() @ e2_all.float().T
    s2 = e2_rows.float() @ e1_all.float().T
    m1, h1 = masked_shift((s1 - sd[:, None]) / t1[:, None], offdiag)
    m2, h2 = masked_shift((s2 - sd[:, None]) / t2[:, None], offdiag)
    g1 = h1.sum(dim=-1) / denom
    g2 = h2.sum(dim=-1) / denom
    dg1 = torch.sum(h1.detach() * -(s1 - sd[:, None]).detach(), dim=-1) / (
        denom * t1 ** 2)
    dg2 = torch.sum(h2.detach() * -(s2 - sd[:, None]).detach(), dim=-1) / (
        denom * t2 ** 2)
    return RowStats(g1, g2, dg1, dg2, m1, m2)


def update_u(u_old, g_batch, gamma):
    """Linear-domain FCCO moving average (eq. 1), reference semantics."""
    return (1.0 - gamma) * u_old + gamma * g_batch.detach()


def update_log_u(lu_old, log_g_batch, gamma):
    """Exact log-domain FCCO EMA: logaddexp(log(1-gamma) + lu_old,
    log(gamma) + log g); exact at gamma 0 and 1 and at lu_old = -inf."""
    gamma = _f32(gamma, lu_old.device)
    return torch.logaddexp(torch.log1p(-torch.clamp_max(gamma, 1.0)) + lu_old,
                           torch.log(gamma) + log_g_batch.detach())


def log_eps_u(lu, eps):
    """log(eps + u) from log-domain u."""
    return torch.logaddexp(torch.log(_f32(eps, lu.device)), lu)


def fcco_weights(u1_new, u2_new, tau1, tau2, eps, *, scale_by_tau=True):
    """Linear-domain w_i = tau_i/(eps+u_i) (1/(eps+u_i) for v0)."""
    t1 = tau1 if scale_by_tau else 1.0
    t2 = tau2 if scale_by_tau else 1.0
    return t1 / (eps + u1_new), t2 / (eps + u2_new)


def fcco_log_weights(lu1_new, lu2_new, tau1, tau2, eps, *,
                     scale_by_tau=True):
    """lw_i = log tau_i - log(eps + u_i) (``- log(eps+u_i)`` for v0)."""
    L1 = log_eps_u(lu1_new, eps)
    L2 = log_eps_u(lu2_new, eps)
    if scale_by_tau:
        dev = L1.device
        return torch.log(_f32(tau1, dev)) - L1, torch.log(_f32(tau2, dev)) - L2
    z = torch.zeros_like(L1)
    return z - L1, z - L2


def surrogate_loss(stats: RowStats, lw1, lw2, batch_denom):
    """(1/B) sum_i exp(sg(lw1_i + m1_i)) g1_i + exp(sg(lw2_i + m2_i)) g2_i."""
    c1 = guarded_exp((lw1 + stats.m1).detach())
    c2 = guarded_exp((lw2 + stats.m2).detach())
    return torch.sum(c1 * stats.g1 + c2 * stats.g2) / batch_denom


def saturation_rate(stats: RowStats, lw1, lw2, tau1, tau2):
    """Per-row (b,) indicator of the last-resort guard firing anywhere in
    the backward (exact: the row's largest backward exponent is
    m_i + lw_i - log tau_i)."""
    dev = stats.m1.device
    t1 = torch.log(_f32(tau1, dev).broadcast_to(stats.m1.shape))
    t2 = torch.log(_f32(tau2, dev).broadcast_to(stats.m2.shape))
    s1 = (stats.m1 + lw1 - t1 > EXP_CLAMP).float()
    s2 = (stats.m2 + lw2 - t2 > EXP_CLAMP).float()
    return 0.5 * (s1 + s2)


# ---------------------------------------------------------------------------
# Reported loss values (not used for gradients in the FCCO path)
# ---------------------------------------------------------------------------

def gcl_value(lu1, lu2, tau, eps):
    """(GCL) value from log-domain u (mean over rows)."""
    return tau * torch.mean(log_eps_u(lu1, eps) + log_eps_u(lu2, eps))


def rgcl_g_value(lu1, lu2, tau, eps, rho):
    """(RGCL-g) value."""
    return gcl_value(lu1, lu2, tau, eps) + 2.0 * rho * tau


def rgcl_value(lu1, lu2, tau1, tau2, eps, rho):
    """(RGCL) value (individualised temperatures)."""
    return torch.mean(tau1 * (log_eps_u(lu1, eps) + rho)
                      + tau2 * (log_eps_u(lu2, eps) + rho))


def mbcl_loss(e1, e2, tau):
    """Bidirectional InfoNCE over the batch (OpenCLIP's loss, MBCL up to
    an additive constant).  e1/e2 normalised."""
    s = (e1.float() @ e2.float().T) / tau
    logz1 = torch.logsumexp(s, dim=1)
    logz2 = torch.logsumexp(s, dim=0)
    diag = torch.diagonal(s)
    return 0.5 * (torch.mean(logz1 - diag) + torch.mean(logz2 - diag))


def fcco_reference_step(e1, e2, lu1, lu2, tau1, tau2, gamma, eps, *,
                        scale_by_tau=True):
    """Single-device reference of one FCCO loss step.  e1/e2
    unnormalised (B, d); lu* (B,) log-domain.  Returns (surrogate, aux);
    autograd of the surrogate w.r.t. e1/e2 is the FastCLIP estimator."""
    e1n = l2_normalize(e1)
    e2n = l2_normalize(e2)
    stats = row_stats(e1n, e2n, e1n, e2n, tau1, tau2)
    lg1, lg2 = log_g(stats)
    lu1n = update_log_u(lu1, lg1, gamma)
    lu2n = update_log_u(lu2, lg2, gamma)
    lw1, lw2 = fcco_log_weights(lu1n, lu2n, tau1, tau2, eps,
                                scale_by_tau=scale_by_tau)
    loss = surrogate_loss(stats, lw1, lw2, e1.shape[0])
    aux = {"lu1_new": lu1n, "lu2_new": lu2n, "g1": stats.g1.detach(),
           "g2": stats.g2.detach(), "dg1_dtau": stats.dg1_dtau,
           "dg2_dtau": stats.dg2_dtau, "m1": stats.m1, "m2": stats.m2,
           "sat": saturation_rate(stats, lw1, lw2, tau1, tau2)}
    return loss, aux
