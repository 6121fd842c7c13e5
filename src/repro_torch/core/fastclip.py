"""The FastCLIP algorithm family (port of ``repro.core.fastclip``, paper
Table 1):

  version    loss     FCCO   gamma     temperature
  openclip   MBCL     no     n/a       global, learnable (autograd)
  sogclr     GCL      yes    constant  global, constant
  isogclr    RGCL     yes    constant  individualised, learnable (eq. 9)
  v0         GCL      yes    cosine    global, learnable (eq. 8, unscaled)
  v1         GCL      yes    cosine    global, constant
  v2         RGCL     yes    cosine    individualised, learnable (eq. 9)
  v3         RGCL-g   yes    cosine    global, learnable (eq. 10)

The FCCO state (log-domain u1, u2), the temperatures and their Adam
moments live in a dict of tensors; every function here returns new
tensors and leaves its inputs as they were (the train step's guard
selects between the old and the new state).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import losses as LS
from repro_torch.core import schedules as SCH

VERSIONS = ("openclip", "sogclr", "isogclr", "v0", "v1", "v2", "v3")


@dataclasses.dataclass(frozen=True)
class FastCLIPConfig:
    version: str = "v3"
    n_samples: int = 0                 # dataset size (u buffers)
    eps: float = 1e-14
    rho: float = 8.5
    tau_init: float = 0.07
    tau_min: float = 0.01              # tau_0 lower bound
    lr_tau: float = 1e-4
    tau_lr_decay_at: float = 0.03      # v3: lr_tau /= 3 once tau < this
    gamma: float = 0.6                 # constant-schedule value
    gamma_min: float = 0.2             # cosine-schedule floor
    gamma_decay_epochs: int = 16
    steps_per_epoch: int = 1000
    gamma_schedule: str = "auto"       # auto | constant | cosine
    tau_beta1: float = 0.9
    tau_beta2: float = 0.999
    tau_adam_eps: float = 1e-8
    # loss-layer math: "dense" (torch pair matrices) or "fused" (K1/K2)
    loss_impl: str = "dense"

    @property
    def uses_fcco(self) -> bool:
        return self.version != "openclip"

    @property
    def individual_tau(self) -> bool:
        return self.version in ("isogclr", "v2")

    @property
    def learnable_tau(self) -> bool:
        return self.version in ("openclip", "isogclr", "v0", "v2", "v3")

    @property
    def scale_by_tau(self) -> bool:
        return self.version != "v0"

    def gamma_fn(self):
        if self.version == "openclip":
            return SCH.gamma_constant(1.0)
        sched = self.gamma_schedule
        if sched == "auto":
            sched = ("constant" if self.version in ("sogclr", "isogclr")
                     else "cosine")
        if sched == "constant":
            return SCH.gamma_constant(self.gamma)
        return SCH.gamma_cosine(self.gamma_min, self.steps_per_epoch,
                                self.gamma_decay_epochs)


def init_state(fc: FastCLIPConfig, device=None):
    """FCCO + temperature state; ``u1``/``u2`` hold log(u), initialised
    to log(0) = -inf (``losses.update_log_u`` handles it exactly)."""
    n = max(fc.n_samples, 1)

    def full(shape, v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=device)

    st = {"step": full((), 0, torch.int32)}
    if fc.uses_fcco:
        st["u1"] = full((n,), -float("inf"))
        st["u2"] = full((n,), -float("inf"))
    if fc.individual_tau:
        st["tau1"] = full((n,), fc.tau_init)
        st["tau2"] = full((n,), fc.tau_init)
        st["tau_opt"] = {"m1": full((n,), 0.0), "v1": full((n,), 0.0),
                         "m2": full((n,), 0.0), "v2": full((n,), 0.0),
                         "t": full((), 0, torch.int32)}
    else:
        st["tau"] = full((), fc.tau_init)
        if fc.learnable_tau:
            st["tau_opt"] = {"m": full((), 0.0), "v": full((), 0.0),
                             "t": full((), 0, torch.int32)}
    return st


def batch_taus(fc: FastCLIPConfig, state, idx):
    """Per-row temperatures for batch indices ``idx`` (or scalars)."""
    if fc.individual_tau:
        return state["tau1"][idx], state["tau2"][idx]
    return state["tau"], state["tau"]


def objective(fc: FastCLIPConfig, e1, e2, lu1_rows, lu2_rows, tau1, tau2,
              gamma):
    """Single-device reference objective: (surrogate, aux)."""
    if fc.version == "openclip":
        e1n, e2n = LS.l2_normalize(e1), LS.l2_normalize(e2)
        return LS.mbcl_loss(e1n, e2n, tau1), {"g1": None}
    return LS.fcco_reference_step(e1, e2, lu1_rows, lu2_rows, tau1, tau2,
                                  gamma, fc.eps,
                                  scale_by_tau=fc.scale_by_tau)


def loss_value(fc: FastCLIPConfig, aux, tau1, tau2, mbcl=None):
    """The reported (batch-estimated) loss value, from log-domain u."""
    v = fc.version
    if v == "openclip":
        return mbcl
    lu1, lu2 = aux["lu1_new"], aux["lu2_new"]
    if v in ("sogclr", "v0", "v1"):
        return LS.gcl_value(lu1, lu2, torch.mean(tau1 * torch.ones_like(lu1)),
                            fc.eps)
    if v in ("isogclr", "v2"):
        return LS.rgcl_value(lu1, lu2, tau1, tau2, fc.eps, fc.rho)
    return LS.rgcl_g_value(lu1, lu2, tau1, fc.eps, fc.rho)


def tau_gradient(fc: FastCLIPConfig, aux, tau1, tau2):
    """Closed-form temperature gradients (eqs. 8-10) from the detached
    shifted stats in ``aux`` (``lu*_new``, ``m*``, ``dg*_dtau``): the true
    dg/(eps+u) is ``exp(m - log(eps+u)) * dg_shifted``.  A scalar for a
    global tau, a per-row pair for v2/isogclr, None for a constant tau."""
    eps = fc.eps
    L1 = LS.log_eps_u(aux["lu1_new"], eps)
    L2 = LS.log_eps_u(aux["lu2_new"], eps)
    q1 = LS.guarded_exp(aux["m1"] - L1) * aux["dg1_dtau"]
    q2 = LS.guarded_exp(aux["m2"] - L2) * aux["dg2_dtau"]
    v = fc.version
    if v == "v0":                                    # eq. (8)
        return torch.mean(q1 + q2)
    if v in ("isogclr", "v2"):                       # eq. (9), per row
        return L1 + fc.rho + tau1 * q1, L2 + fc.rho + tau2 * q2
    if v == "v3":                                    # eq. (10)
        return (torch.mean(L1 + L2) + 2 * fc.rho
                + tau1 * torch.mean(q1 + q2))
    return None


def _bias_correction(beta: float, t: torch.Tensor) -> torch.Tensor:
    """1 - beta**t in f32, as the JAX package computes it."""
    return 1 - torch.tensor(beta, dtype=torch.float32,
                            device=t.device) ** t.float()


def _adam_scalar(fc, g, m, v, t):
    b1, b2, ae = fc.tau_beta1, fc.tau_beta2, fc.tau_adam_eps
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mh = m / _bias_correction(b1, t)
    vh = v / _bias_correction(b2, t)
    return mh / (torch.sqrt(vh) + ae), m, v


def tau_update(fc: FastCLIPConfig, state, tau_grad, idx=None):
    """The temperature update (Adam, wd = 0).  For v2/isogclr only rows
    ``idx`` move (stochastic coordinate update).  Returns a new dict."""
    if not fc.learnable_tau or tau_grad is None:
        return state
    st = dict(state)
    opt = dict(st["tau_opt"])
    t = opt["t"] + 1
    opt["t"] = t
    if fc.individual_tau:
        g1, g2 = tau_grad
        for side, g in (("1", g1), ("2", g2)):
            m = opt[f"m{side}"].clone()
            v = opt[f"v{side}"].clone()
            m[idx] = fc.tau_beta1 * m[idx] + (1 - fc.tau_beta1) * g
            v[idx] = fc.tau_beta2 * v[idx] + (1 - fc.tau_beta2) * torch.square(g)
            mh = m[idx] / _bias_correction(fc.tau_beta1, t)
            vh = v[idx] / _bias_correction(fc.tau_beta2, t)
            step = mh / (torch.sqrt(vh) + fc.tau_adam_eps)
            tau = st[f"tau{side}"].clone()
            tau[idx] = torch.clamp_min(tau[idx] - fc.lr_tau * step,
                                       fc.tau_min)
            st[f"tau{side}"] = tau
            opt[f"m{side}"] = m
            opt[f"v{side}"] = v
    else:
        step, m, v = _adam_scalar(fc, tau_grad, opt["m"], opt["v"], t)
        lr = torch.tensor(fc.lr_tau, dtype=torch.float32,
                          device=step.device)
        if fc.version == "v3":
            lr = torch.where(state["tau"] < fc.tau_lr_decay_at, lr / 3.0, lr)
        st["tau"] = torch.clamp_min(state["tau"] - lr * step, fc.tau_min)
        opt["m"], opt["v"] = m, v
    st["tau_opt"] = opt
    return st


def scatter_u(state, idx, u1_new_rows, u2_new_rows):
    st = dict(state)
    st["u1"] = state["u1"].index_copy(0, idx, u1_new_rows)
    st["u2"] = state["u2"].index_copy(0, idx, u2_new_rows)
    return st
