"""Train-step assembly (port of ``repro.core.train_step``, the
single-device step): CLIP towers + FastCLIP objective + optimizer.

The train state is a dict: ``params`` (the ``CLIP`` module), ``opt``
(f32 moments keyed by parameter name, and the step count ``t``), ``fc``
(``core.fastclip.init_state``: log-domain u, taus, tau moments, a step
counter) and ``step`` (int32).  ``make_train_step(tc)`` returns
``train_step(state, batch, idx) -> (state, metrics)``:

  towers (``impl``: the flash kernel by default) -> L2-normalise ->
  the FCCO loss op (K1 forward and K2 backward with ``loss_impl="fused"``)
  or OpenCLIP's MBCL -> autograd -> the optimizer -> the closed-form
  temperature update (openclip differentiates tau with autograd) -> the
  log-u scatter.

Gradient clipping (the JAX config's ``grad_clip``, set by no launcher)
is not ported.  The model's parameters are updated in place (under
``torch.no_grad()``); every other leaf of the returned state is a new
tensor.  With
``guard=True`` a non-finite loss or gradient norm makes the step a
bitwise no-op: the new values are chosen with ``torch.where`` against the
old ones on the device, without a host sync.  The mesh settings
(``mesh_axes``, ``fsdp``, ``microbatch > 1``) come with the mesh slice
of the port and are refused here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch import device as D
from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed as DI
from repro_torch.core import fastclip as FC
from repro_torch.core import losses as LS
from repro_torch.models import backbones as BB
from repro_torch.models import precision as PR
from repro_torch.optim import Optimizer, global_norm
from repro_torch.resilience import guard as RG


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    arch: ArchConfig
    fc: FC.FastCLIPConfig
    optimizer: Optimizer
    lr_fn: Callable
    wd: float = 0.1
    mesh_axes: Optional[Sequence[str]] = None
    # attention core of the towers: "flash" (the kernel on the card),
    # "chunked" or "naive" (the plain references)
    impl: str = "flash"
    # loss-layer math: "dense" or "fused" (K1/K2); None defers to
    # fc.loss_impl
    loss_impl: Optional[str] = None
    # tower precision policy ("f32" | "bf16"); None defers to arch.precision
    precision: Optional[str] = None
    fsdp: bool = False
    microbatch: int = 1
    # non-finite step guard: a bad step becomes a bitwise no-op and the
    # metrics gain ``skipped`` / ``nonfinite_rate``
    guard: bool = False

    @property
    def resolved_precision(self) -> PR.Precision:
        return PR.get_precision(self.precision or self.arch.precision)


def _check_single_device(tc: TrainStepConfig) -> None:
    if tc.fsdp or tc.mesh_axes is not None:
        raise NotImplementedError(
            "mesh_axes / fsdp (the (data, fsdp) mesh step) are not ported "
            "yet; they come with the mesh slice")
    if tc.microbatch != 1:
        raise NotImplementedError(
            f"microbatch={tc.microbatch}: microbatch pipelining belongs to "
            "the fsdp step, which is not ported yet")


def init_train_state(gen: torch.Generator, tc: TrainStepConfig,
                     device=None):
    """Random params from ``gen`` (a CPU generator), optimizer and FCCO
    state, on ``device`` (default: the card; raises without one)."""
    _check_single_device(tc)
    device = D.resolve(device)
    model = BB.init_params(tc.arch, gen, device)
    params = dict(model.named_parameters())
    return {"params": model,
            "opt": tc.optimizer.init({k: p.detach()
                                      for k, p in params.items()}),
            "fc": FC.init_state(tc.fc, device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_loss_core(fc: FC.FastCLIPConfig, loss_impl: str = "dense"):
    """loss_core(e1n, e2n, lu1, lu2, tau1, tau2, idx, gamma) -> (loss, aux)
    on the global batch of one device; aux has the full new log-u arrays
    ``u1_new``/``u2_new``, the batch rows ``u1_rows``/``u2_rows``, the
    detached ``stats`` and ``sat``."""
    op = DI.make_fcco_loss_op(None, fc.eps, fc.scale_by_tau,
                              loss_impl=loss_impl)

    def loss_core(e1n, e2n, lu1, lu2, tau1, tau2, idx, gamma):
        t1 = tau1[idx] if tau1.ndim else tau1
        t2 = tau2[idx] if tau2.ndim else tau2
        loss, (lu1_rows, lu2_rows, stats, sat) = op(
            e1n, e2n, lu1[idx], lu2[idx], t1, t2, gamma)
        aux = {"u1_new": lu1.index_copy(0, idx, lu1_rows),
               "u2_new": lu2.index_copy(0, idx, lu2_rows),
               "u1_rows": lu1_rows, "u2_rows": lu2_rows, "stats": stats,
               "sat": sat}
        return loss, aux

    return loss_core


def step_grads(tc: TrainStepConfig, loss_core, state, batch, idx, gamma):
    """The step's forward and backward: (loss, aux, grads, gtau), with
    ``grads`` keyed by parameter name and ``gtau`` the autograd tau
    gradient (openclip) or None."""
    fc = tc.fc
    fcs = state["fc"]
    model = state["params"]
    names, params = zip(*model.named_parameters())
    tau_diff = None
    if fc.version == "openclip":
        tau_diff = fcs["tau"].detach().clone().requires_grad_(True)
    with torch.enable_grad():
        e1, e2 = BB.encode_pair(model, tc.arch, batch, impl=tc.impl,
                                precision=tc.resolved_precision)
        e1n = LS.l2_normalize(e1)
        e2n = LS.l2_normalize(e2)
        if fc.version == "openclip":
            loss = LS.mbcl_loss(e1n, e2n, tau_diff)
            aux = {}
            wrt = (*params, tau_diff)
        else:
            t1 = fcs["tau1"] if fc.individual_tau else fcs["tau"]
            t2 = fcs["tau2"] if fc.individual_tau else fcs["tau"]
            loss, aux = loss_core(e1n, e2n, fcs["u1"], fcs["u2"], t1, t2,
                                  idx, gamma)
            wrt = params
        gs = torch.autograd.grad(loss, wrt)
    grads = dict(zip(names, gs[:len(names)]))
    gtau = gs[-1] if tau_diff is not None else None
    return loss.detach(), aux, grads, gtau


def make_train_step(tc: TrainStepConfig, device=None):
    """The step on ``device`` (default: the card; raises without one):
    the batch and ``idx`` are moved there (a no-op for tensors already
    on it); the state lives there (``init_train_state``)."""
    _check_single_device(tc)
    device = D.resolve(device)
    fc = tc.fc
    gamma_fn = fc.gamma_fn()
    loss_core = (None if fc.version == "openclip"
                 else make_loss_core(fc, tc.loss_impl or fc.loss_impl))

    def train_step(state, batch, idx):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        idx = torch.as_tensor(idx, device=device)
        fcs = state["fc"]
        step = state["step"]
        gamma = gamma_fn(step)
        lr = tc.lr_fn(step)
        tau1, tau2 = ((fcs["tau1"], fcs["tau2"]) if fc.individual_tau
                      else (fcs["tau"], fcs["tau"]))
        loss, aux, grads, gtau = step_grads(tc, loss_core, state, batch,
                                            idx, gamma)
        if tc.guard:
            gnorm = global_norm(grads)   # the guard's all-finite probe
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)

        model = state["params"]
        params = {k: p.detach() for k, p in model.named_parameters()}
        new_params, opt = tc.optimizer.update(params, grads, state["opt"],
                                              lr=lr, wd=tc.wd)
        new_fc = dict(fcs)
        metrics = {"loss": loss, "lr": lr, "gamma": gamma,
                   "grad_norm": gnorm}
        if fc.version == "openclip":
            if fc.learnable_tau:
                new_fc = FC.tau_update(fc, new_fc, gtau)
            metrics["tau"] = new_fc.get("tau", tau1)
        else:
            new_fc["u1"] = aux["u1_new"]
            new_fc["u2"] = aux["u2_new"]
            stats = aux["stats"]
            stats_aux = {"lu1_new": aux["u1_rows"],
                         "lu2_new": aux["u2_rows"], "m1": stats.m1,
                         "m2": stats.m2, "dg1_dtau": stats.dg1_dtau,
                         "dg2_dtau": stats.dg2_dtau}
            t1r = tau1[idx] if fc.individual_tau else tau1
            t2r = tau2[idx] if fc.individual_tau else tau2
            tg = FC.tau_gradient(fc, stats_aux, t1r, t2r)
            if fc.individual_tau:
                new_fc = FC.tau_update(fc, new_fc, tg, idx=idx)
                metrics["tau"] = torch.mean(new_fc["tau1"])
            elif tg is not None:
                new_fc = FC.tau_update(fc, new_fc, tg)
                metrics["tau"] = new_fc["tau"]
            else:
                metrics["tau"] = tau1
            # u is log-domain; report a display-clamped linear mean
            metrics["u_mean"] = torch.mean(
                torch.exp(torch.clamp_max(aux["u1_rows"], 80.0)))
            metrics["sat_rate"] = torch.mean(aux["sat"])
            metrics["loss_value"] = FC.loss_value(
                fc, {"lu1_new": aux["u1_rows"], "lu2_new": aux["u2_rows"]},
                t1r, t2r)
        new_fc["step"] = fcs["step"] + 1
        new_rest = {"opt": opt, "fc": new_fc, "step": step + 1}
        if tc.guard:
            ok = RG.step_ok(loss, gnorm)
            old_rest = {"opt": state["opt"], "fc": fcs, "step": step}
            new_rest = RG.select_state(ok, old_rest, new_rest)
            new_params = RG.select_state(ok, params, new_params)
            metrics["skipped"] = 1.0 - ok.float()
            metrics["nonfinite_rate"] = RG.grad_nonfinite_rate(grads)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(new_params[k])
        return {"params": model, **new_rest}, metrics

    return train_step


# ---------------------------------------------------------------------------
# Post-step dtype invariants
# ---------------------------------------------------------------------------

def check_state_dtypes(state) -> None:
    """Raise unless every floating leaf of params / optimizer moments /
    FCCO state is f32, under any tower precision policy (integer
    counters are exempt)."""
    bad = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif node.is_floating_point() and node.dtype != torch.float32:
            bad.append(f"{prefix}: {node.dtype}")

    if "params" in state:
        walk("params", dict(state["params"].named_parameters()))
    for name in ("opt", "fc"):
        if name in state:
            walk(name, state[name])
    if bad:
        raise AssertionError(
            "master state must stay f32 under any precision policy; "
            "offenders: " + ", ".join(bad))


# ---------------------------------------------------------------------------
# Retrieval evaluation (synthetic-data metric)
# ---------------------------------------------------------------------------

def retrieval_accuracy(params, cfg: ArchConfig, batch, impl="chunked",
                       classes=None):
    """Top-1 retrieval over the batch; with ``classes`` a retrieval is
    correct when it lands on any same-class item.  ``impl`` defaults to
    the plain chunked attention, as the JAX package's metric does."""
    with torch.inference_mode():
        e1, e2 = BB.encode_pair(params, cfg, batch, impl=impl)
        s = LS.l2_normalize(e1) @ LS.l2_normalize(e2).T
        a1 = s.argmax(dim=1)
        a2 = s.argmax(dim=0)
        if classes is None:
            ar = torch.arange(s.shape[0], device=s.device)
            i2t = (a1 == ar).float().mean()
            t2i = (a2 == ar).float().mean()
        else:
            classes = torch.as_tensor(classes, device=s.device)
            i2t = (classes[a1] == classes).float().mean()
            t2i = (classes[a2] == classes).float().mean()
        return 0.5 * (i2t + t2i)
