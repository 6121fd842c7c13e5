"""Plain oracles of the kernels (port of ``repro.kernels.ref``): the
square-case torch references of K1 and K2, a numpy float64 oracle of the
whole FCCO step in the linear domain (exp(200) is representable in f64,
so it needs no shift), a copy of the JAX package's, which the tests hold
to it bitwise, and the SSD scan's oracle (the sequential recurrence)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.losses import MASK_NEG


def gcl_pair_stats_ref(e1, e2, tau1, tau2):
    """Shift-decomposed stats (g1, g2, dg1, dg2, m1, m2) over the full
    square pair matrix; e1/e2 (B, d) normalised, tau1/tau2 (B,)."""
    B = e1.shape[0]
    e1, e2 = e1.float(), e2.float()
    sd = torch.sum(e1 * e2, dim=-1)
    off = ~torch.eye(B, dtype=torch.bool, device=e1.device)
    s1 = e1 @ e2.T
    s2 = e2 @ e1.T
    z1 = torch.where(off, (s1 - sd[:, None]) / tau1[:, None], MASK_NEG)
    z2 = torch.where(off, (s2 - sd[:, None]) / tau2[:, None], MASK_NEG)
    m1 = z1.amax(dim=1)
    m2 = z2.amax(dim=1)
    h1 = torch.where(off, torch.exp(z1 - m1[:, None]), 0.0)
    h2 = torch.where(off, torch.exp(z2 - m2[:, None]), 0.0)
    denom = B - 1
    g1 = h1.sum(1) / denom
    g2 = h2.sum(1) / denom
    dg1 = (h1 * -(s1 - sd[:, None])).sum(1) / (denom * tau1 ** 2)
    dg2 = (h2 * -(s2 - sd[:, None])).sum(1) / (denom * tau2 ** 2)
    return g1, g2, dg1, dg2, m1, m2


def gcl_pair_grads_ref(e1, e2, lw1, lw2, tau1, tau2):
    """Closed-form (de1, de2) of L = (1/B) sum_i w1_i g1_i + w2_i g2_i with
    log-domain weights lw = log(w): A[i, j] = exp(z_ij + lw_i - log
    tau_i)."""
    B = e1.shape[0]
    e1, e2 = e1.float(), e2.float()
    sd = torch.sum(e1 * e2, dim=-1)
    off = ~torch.eye(B, dtype=torch.bool, device=e1.device)
    s1 = e1 @ e2.T
    s2 = e2 @ e1.T
    lwt1 = lw1 - torch.log(tau1)
    lwt2 = lw2 - torch.log(tau2)
    A1 = torch.where(off, torch.exp((s1 - sd[:, None]) / tau1[:, None]
                                    + lwt1[:, None]), 0.0)
    A2 = torch.where(off, torch.exp((s2 - sd[:, None]) / tau2[:, None]
                                    + lwt2[:, None]), 0.0)
    kappa = 1.0 / (B * (B - 1.0))
    r1 = A1.sum(1)
    r2 = A2.sum(1)
    de1 = kappa * ((A1 + A2.T) @ e2 - (r1 + r2)[:, None] * e2)
    de2 = kappa * ((A2 + A1.T) @ e1 - (r1 + r2)[:, None] * e1)
    return de1, de2


def fcco_step_f64(e1n, e2n, lu1, lu2, tau1, tau2, gamma, eps, *,
                  scale_by_tau=True):
    """One exact FCCO step in float64, linear domain: the ground truth
    for the shifted-f32 engine.  e1n/e2n: (B, d) normalised; lu1/lu2:
    (B,) log-domain u.  Returns loss, log-domain lu*_new, the closed-form
    grads de1/de2 of the surrogate and the true dg*_dtau, all f64."""
    e1 = np.asarray(e1n, np.float64)
    e2 = np.asarray(e2n, np.float64)
    B = e1.shape[0]
    t1 = np.broadcast_to(np.asarray(tau1, np.float64), (B,))
    t2 = np.broadcast_to(np.asarray(tau2, np.float64), (B,))
    u1 = np.exp(np.asarray(lu1, np.float64))
    u2 = np.exp(np.asarray(lu2, np.float64))
    sd = np.sum(e1 * e2, axis=-1)
    off = ~np.eye(B, dtype=bool)
    s1 = e1 @ e2.T
    s2 = e2 @ e1.T
    h1 = np.where(off, np.exp((s1 - sd[:, None]) / t1[:, None]), 0.0)
    h2 = np.where(off, np.exp((s2 - sd[:, None]) / t2[:, None]), 0.0)
    denom = B - 1
    g1 = h1.sum(1) / denom
    g2 = h2.sum(1) / denom
    dg1 = (h1 * -(s1 - sd[:, None])).sum(1) / (denom * t1 ** 2)
    dg2 = (h2 * -(s2 - sd[:, None])).sum(1) / (denom * t2 ** 2)
    u1n = (1.0 - gamma) * u1 + gamma * g1
    u2n = (1.0 - gamma) * u2 + gamma * g2
    w1 = (t1 if scale_by_tau else 1.0) / (eps + u1n)
    w2 = (t2 if scale_by_tau else 1.0) / (eps + u2n)
    loss = float(np.sum(w1 * g1 + w2 * g2) / B)
    # closed-form grads (Appendix A); identical to autodiff of the
    # surrogate because w is stop-grad
    A1 = (w1 / t1)[:, None] * h1
    A2 = (w2 / t2)[:, None] * h2
    kappa = 1.0 / (B * (B - 1.0))
    r1 = A1.sum(1)
    r2 = A2.sum(1)
    de1 = kappa * ((A1 + A2.T) @ e2 - (r1 + r2)[:, None] * e2)
    de2 = kappa * ((A2 + A1.T) @ e1 - (r1 + r2)[:, None] * e1)
    with np.errstate(divide="ignore"):
        lu1n = np.log(u1n)
        lu2n = np.log(u2n)
    return {"loss": loss, "lu1_new": lu1n, "lu2_new": lu2n,
            "g1": g1, "g2": g2, "dg1_dtau": dg1, "dg2_dtau": dg2,
            "de1": de1, "de2": de2, "w1": w1, "w2": w2}


def ssd_chunk_ref(x, log_a, Bm, Cm):
    """Oracle for the Mamba2 SSD kernel: defer to the sequential scan."""
    from repro_torch.models.ssm import ssd_sequential
    return ssd_sequential(x, log_a, Bm, Cm)[0]
