"""Train-step assembly (port of ``repro.core.train_step``): the towers
of ``backbones.encode_pair`` (CLIP's two, or an LM backbone against its
paired embeddings) + FastCLIP objective + optimizer, on one device or
on the (data, fsdp) mesh.

The single-device train state is a dict: ``params`` (the ``CLIP``,
``HybridLM`` or ``DenseLM`` module), ``opt`` (f32 moments keyed by
parameter name, and the step count ``t``), ``fc``
(``core.fastclip.init_state``: log-domain u, taus, tau moments, a step
counter) and ``step`` (int32).
``make_train_step(tc)`` returns ``train_step(state, batch, idx) ->
(state, metrics)``:

  towers (``impl``: the flash kernel by default) -> L2-normalise ->
  the FCCO loss op (K1 forward and K2 backward with ``loss_impl="fused"``)
  or OpenCLIP's MBCL -> autograd -> the optimizer -> the closed-form
  temperature update (openclip differentiates tau with autograd) -> the
  log-u scatter.

``fsdp=True`` (or ``mesh_axes``) gives ``make_fsdp_train_step``, the
(data, fsdp) mesh step of ``core.shard_state``: each rank holds its
shards, gathers the weights at use (``shard_state.gather_params``, into
the module through ``torch.func.functional_call``), runs the loss op on
its rows against the gathered columns, reduces the gradients by
reduce-scatter over ``fsdp`` and all-reduce over ``data``, and updates
its own shards.  ``microbatch`` N splits a rank's rows into N
micro-steps, each with its own weight gather; the loss and the log-u
update still run once per global step.  An LM backbone's recompute
(``backbones.forward_hidden``) runs with the gathered weights it held at
the call, so each gather's backward runs once per micro-step, whatever
the recompute; a gathered leaf the towers do not reach (``lm_head``)
gets a zero gradient.

Gradient clipping (the JAX config's ``grad_clip``, set by no launcher)
is not ported.  On one device the model's parameters are updated in
place (under ``torch.no_grad()``); every other leaf of the returned state
is a new tensor.  With ``guard=True`` a non-finite loss or gradient norm
makes the step a bitwise no-op: the new values are chosen with
``torch.where`` against the old ones on the device, without a host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch import device as D
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed as DI
from repro_torch.core import fastclip as FC
from repro_torch.core import losses as LS
from repro_torch.core import shard_state as SS
from repro_torch.launch import mesh as MS
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
    # "fastclip" (the closed-form backward, no feature-gradient
    # collective) or "allgather_ad" (autograd through the feature gather:
    # the DDP-style baseline); only the mesh step tells them apart
    reduction: str = "fastclip"
    # attention core of the towers: "flash" (the kernel on the card),
    # "chunked" or "naive" (the plain references)
    impl: str = "flash"
    # loss-layer math: "dense" or "fused" (K1/K2); None defers to
    # fc.loss_impl
    loss_impl: Optional[str] = None
    # tower precision policy ("f32" | "bf16"); None defers to arch.precision
    precision: Optional[str] = None
    # the (data, fsdp) mesh step (``make_fsdp_train_step``)
    fsdp: bool = False
    # mesh step only: micro-steps per rank, each with its own weight
    # gather and tower slice; the loss and log-u update run once
    microbatch: int = 1
    # non-finite step guard: a bad step becomes a bitwise no-op and the
    # metrics gain ``skipped`` / ``nonfinite_rate``
    guard: bool = False

    @property
    def resolved_precision(self) -> PR.Precision:
        return PR.get_precision(self.precision or self.arch.precision)


def init_train_state(gen: torch.Generator, tc: TrainStepConfig,
                     device=None):
    """Random params from ``gen`` (a CPU generator), optimizer and FCCO
    state, on ``device`` (default: the card; raises without one).  The
    mesh step starts from the same full state
    (``shard_state.shard_train_state`` of its ``bridge.state_to_tree``)."""
    device = D.resolve(device)
    model = BB.init_params(tc.arch, gen, device)
    params = dict(model.named_parameters())
    return {"params": model,
            "opt": tc.optimizer.init({k: p.detach()
                                      for k, p in params.items()}),
            "fc": FC.init_state(tc.fc, device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_loss_core(fc: FC.FastCLIPConfig, loss_impl: str = "dense",
                   mesh_axes: Optional[Sequence[str]] = None,
                   reduction: str = "fastclip"):
    """loss_core(e1n, e2n, lu1, lu2, tau1, tau2, idx, gamma) -> (loss, aux)
    with aux = the full new log-u arrays ``u1_new``/``u2_new``, the batch
    rows ``u1_rows``/``u2_rows``, the detached ``stats`` and ``sat``.

    ``mesh_axes=None``: the global batch on one device.  With
    ``mesh_axes`` every argument is this rank's: its rows of the batch,
    its u (and v2 tau) shards and its global indices ``idx``; the loss
    is the global mean (all-reduced) and the u arrays are the new
    shards.  (JAX runs this form as a shard_map island inside a GSPMD
    step.)"""
    if mesh_axes is None:
        op = DI.make_fcco_loss_op(None, fc.eps, fc.scale_by_tau,
                                  loss_impl=loss_impl)

        def loss_core(e1n, e2n, lu1, lu2, tau1, tau2, idx, gamma):
            t1 = tau1[idx] if tau1.ndim else tau1
            t2 = tau2[idx] if tau2.ndim else tau2
            loss, (lu1_rows, lu2_rows, stats, sat) = op(
                e1n, e2n, lu1[idx], lu2[idx], t1, t2, gamma)
            aux = {"u1_new": lu1.index_copy(0, idx, lu1_rows),
                   "u2_new": lu2.index_copy(0, idx, lu2_rows),
                   "u1_rows": lu1_rows, "u2_rows": lu2_rows,
                   "stats": stats, "sat": sat}
            return loss, aux

        return loss_core

    axes = tuple(mesh_axes)
    shard_loss = make_shard_loss(fc, axes, reduction, loss_impl)

    def dist_core(e1n, e2n, lu1, lu2, tau1, tau2, idx, gamma):
        loss, u1n, u2n, lu1r, lu2r, stats, sat = _shard_fcco_inner(
            shard_loss, axes, tau1.ndim > 0, e1n, e2n, lu1, lu2, idx, tau1,
            tau2, gamma)
        return loss, {"u1_new": u1n, "u2_new": u2n, "u1_rows": lu1r,
                      "u2_rows": lu2r, "stats": LS.RowStats(*stats),
                      "sat": sat}

    return dist_core


def make_shard_loss(fc: FC.FastCLIPConfig, axes, reduction: str,
                    loss_impl: str, reduce: str = "mean"):
    """The per-rank loss shared by ``make_loss_core`` and the mesh step:
    shard_loss(e1l, e2l, lu1rows, lu2rows, t1, t2, gamma) -> (loss, lu1r,
    lu2r, stats, sat) on this rank's (b,) rows.  ``reduce="local"``
    returns the unreduced local mean contribution (see
    ``distributed.make_fcco_loss_op``)."""
    if reduction == "fastclip":
        op = DI.make_fcco_loss_op(axes, fc.eps, fc.scale_by_tau,
                                  loss_impl=loss_impl, reduce=reduce)

        def shard_loss(e1l, e2l, lu1rows, lu2rows, t1, t2, gamma):
            loss, (lu1r, lu2r, stats, sat) = op(e1l, e2l, lu1rows, lu2rows,
                                                t1, t2, gamma)
            return loss, lu1r, lu2r, tuple(stats), sat
    elif reduction == "allgather_ad":
        pair = DI.make_allgather_ad_pair_loss(axes, reduce=reduce)

        def shard_loss(e1l, e2l, lu1rows, lu2rows, t1, t2, gamma):
            # stats pre-pass on detached features (its gathers are extra:
            # this is the baseline)
            off = DI._global_index(axes) * e1l.shape[0]
            e1d, e2d = e1l.detach(), e2l.detach()
            e1a, e2a = DI.gather_axes(e1d, axes), DI.gather_axes(e2d, axes)
            st0 = LS.row_stats(e1d, e2d, e1a, e2a, t1, t2, row_offset=off)
            lg1, lg2 = LS.log_g(st0)
            lu1r = LS.update_log_u(lu1rows, lg1, gamma)
            lu2r = LS.update_log_u(lu2rows, lg2, gamma)
            lw1, lw2 = LS.fcco_log_weights(lu1r, lu2r, t1, t2, fc.eps,
                                           scale_by_tau=fc.scale_by_tau)
            sat = LS.saturation_rate(st0, lw1, lw2, t1, t2)
            ones = torch.ones_like(lw1)
            loss, stats = pair(e1l, e2l, lw1, lw2, t1 * ones, t2 * ones)
            return loss, lu1r, lu2r, tuple(stats), sat
    else:
        raise ValueError(f"reduction must be 'fastclip' or 'allgather_ad', "
                         f"got {reduction!r}")
    return shard_loss


def _shard_fcco_inner(shard_loss, axes, tau_is_arr, e1l, e2l, u1s, u2s,
                      idxs, t1in, t2in, gamma):
    """One rank's FCCO step on its sample shard: relative-index the local
    u/tau shards, run the loss, scatter the new log-u rows back.
    Returns (loss, u1s_new, u2s_new, lu1r, lu2r, stats, sat)."""
    shard = u1s.shape[0]
    rel = idxs - DI._global_index(axes) * shard
    t1 = t1in[rel] if tau_is_arr else t1in
    t2 = t2in[rel] if tau_is_arr else t2in
    loss, lu1r, lu2r, stats, sat = shard_loss(
        e1l, e2l, u1s[rel], u2s[rel], t1, t2, gamma)
    return (loss, u1s.index_copy(0, rel, lu1r), u2s.index_copy(0, rel, lu2r),
            lu1r, lu2r, stats, sat)


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
        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = _or_zeros(names, params, gs)
    gtau = gs[-1] if tau_diff is not None else None
    return loss.detach(), aux, grads, gtau


def _or_zeros(names, params, gs):
    """{name: gradient}, zeros for a parameter the loss does not reach (an
    LM backbone's ``lm_head`` under the contrastive loss), as under
    ``jax.grad``."""
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, gs)}


def param_grads(loss, model):
    """{parameter name: d loss / d parameter} of ``model``'s parameters,
    zeros where the loss does not reach."""
    names, params = zip(*model.named_parameters())
    return _or_zeros(names, params,
                     torch.autograd.grad(loss, params, allow_unused=True))


def make_train_step(tc: TrainStepConfig, device=None):
    """The step on ``device`` (default: the card; raises without one):
    the batch and ``idx`` are moved there (a no-op for tensors already
    on it); the state lives there (``init_train_state``).  ``fsdp=True``
    or ``mesh_axes`` returns the mesh step (``make_fsdp_train_step``, on
    the current mesh's device; JAX runs the ``mesh_axes``-only form under
    GSPMD, with the same arithmetic)."""
    if tc.microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {tc.microbatch}")
    if tc.fsdp or tc.mesh_axes is not None:
        return make_fsdp_train_step(tc)
    if tc.microbatch > 1:
        raise ValueError(
            "microbatch pipelining splits each rank's rows into micro-steps "
            "with their own weight gathers; it requires the mesh step "
            "(fsdp=True / --mesh data:N,fsdp:M)")
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
# The (data, fsdp) mesh step
# ---------------------------------------------------------------------------

class _Towers(torch.nn.Module):
    """``encode_pair`` as a module call, so that
    ``torch.func.functional_call`` can run it with given weights."""

    def __init__(self, model, cfg, impl, precision):
        super().__init__()
        self.model = model
        self.cfg, self.impl, self.precision = cfg, impl, precision

    def forward(self, batch):
        return BB.encode_pair(self.model, self.cfg, batch, impl=self.impl,
                              precision=self.precision)


def make_fsdp_train_step(tc: TrainStepConfig, param_dims=None):
    """The train step of one rank of the (data, fsdp) mesh
    (``launch.mesh.make_train_mesh`` or ``set_mesh`` first).  The state is this rank's
    shards (``shard_state.shard_train_state``): params and moments
    ZeRO-sharded over ``fsdp`` as flat dicts keyed by the JAX paths, the
    FCCO u/tau buffers by sample ownership; ``batch`` and ``idx`` are
    this rank's rows of the global batch (the loader's owned shard), on
    the mesh's device.

      * each sharded weight is all-gathered over ``fsdp`` at use and
        enters the module through ``torch.func.functional_call``; the
        gather's backward reduce-scatters its gradient onto the shard,
        and ``shard_state.reduce_grads`` finishes with a shard-sized
        all-reduce over ``data``;
      * the FCCO loss op keeps its own contract (feature gather and the
        O(K|B|) scalar gather over both axes, ``reduce="local"``: no
        collective in the differentiated region); openclip runs
        ``distributed.make_mbcl_loss``;
      * the optimizer updates only the local shard (it must be
        shard-safe: LAMB's whole-leaf trust ratio is refused at fsdp >
        1); v2's per-row taus stay shard-local; scalar tau gradients are
        the staged mean of the ranks' means;
      * ``tc.microbatch`` N: N (gather, tower slice) micro-steps, each
        gather with its own reduce-scatter in the backward; the loss and
        the log-u update run once over the concatenated embeddings
        (``microbatch=1`` is exactly the unpipelined step).

    ``param_dims`` overrides the layout ({JAX path: dim or None}; all None
    = replicated params on the same mesh, the parity oracle: both layouts
    reduce fsdp first, then data, so at axis size 2 they agree bit for
    bit)."""
    fc = tc.fc
    prec = tc.resolved_precision
    gamma_fn = fc.gamma_fn()
    axes = tuple(tc.mesh_axes) if tc.mesh_axes else MS.TRAIN_AXES
    if axes != MS.TRAIN_AXES:
        raise ValueError(f"the mesh step runs on mesh axes {MS.TRAIN_AXES}, "
                         f"got mesh_axes={axes}")
    mesh = MS.current_mesh()
    fsdp = mesh.fsdp
    if fsdp > 1 and not tc.optimizer.shard_safe:
        raise ValueError(
            f"optimizer {tc.optimizer.name!r} is not shard-safe (its update "
            "needs whole leaves); use adamw/sgdm/lion with fsdp>1")
    meta = BB.meta_model(tc.arch)
    towers = _Towers(meta, tc.arch, tc.impl, prec)
    p_dims = (SS.param_fsdp_dims(bridge.model_to_tree(meta), fsdp)
              if param_dims is None else dict(param_dims))
    loss_impl = tc.loss_impl or fc.loss_impl
    if fc.version == "openclip":
        mbcl = DI.make_mbcl_loss(axes, reduce="local")
    else:
        shard_loss = make_shard_loss(fc, axes, tc.reduction, loss_impl,
                                     reduce="local")
    world = mesh.world_size

    def pmean(x):
        # the staged sum (fsdp, then data) over equal-size shards
        return SS.staged_psum(x) / world

    def encode(p_shards, batch):
        params = SS.gather_params(p_shards, p_dims)
        named = {f"model.{k}": v
                 for k, v in bridge.tree_to_named(meta, params).items()}
        return torch.func.functional_call(towers, named, (batch,))

    def encode_towers(p_shards, batch):
        if tc.microbatch == 1:
            return encode(p_shards, batch)
        b = next(iter(batch.values())).shape[0]
        if b % tc.microbatch:
            raise ValueError(
                f"microbatch={tc.microbatch} does not divide the per-rank "
                f"batch of {b} rows (global batch / data*fsdp); pick a "
                "divisor")
        mb = b // tc.microbatch
        outs = [encode(p_shards, {k: v[j * mb:(j + 1) * mb]
                                  for k, v in batch.items()})
                for j in range(tc.microbatch)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def step_grads(state, batch, idx, gamma):
        """(global loss, aux, reduced shard grads keyed by JAX path, the
        autograd tau gradient or None) of one step."""
        fcs = state["fc"]
        tau1, tau2 = ((fcs["tau1"], fcs["tau2"]) if fc.individual_tau
                      else (fcs["tau"], fcs["tau"]))
        names = list(state["params"])
        shards = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        tau_diff = None
        with torch.enable_grad():
            e1, e2 = encode_towers(shards, batch)
            e1n = LS.l2_normalize(e1)
            e2n = LS.l2_normalize(e2)
            if fc.version == "openclip":
                tau_diff = fcs["tau"].detach().clone().requires_grad_(True)
                local = mbcl(e1n, e2n, tau_diff)
                aux = {}
                wrt = [shards[k] for k in names] + [tau_diff]
            else:
                t1in = fcs["tau1"] if fc.individual_tau else tau1.detach()
                t2in = fcs["tau2"] if fc.individual_tau else tau2.detach()
                local, u1n, u2n, lu1r, lu2r, stats, sat = _shard_fcco_inner(
                    shard_loss, axes, fc.individual_tau, e1n, e2n,
                    fcs["u1"], fcs["u2"], idx, t1in, t2in, gamma)
                aux = {"u1_new": u1n, "u2_new": u2n, "u1_rows": lu1r,
                       "u2_rows": lu2r, "stats": LS.RowStats(*stats),
                       "sat": sat}
                wrt = [shards[k] for k in names]
            gs = torch.autograd.grad(local, wrt, allow_unused=True)
        loss = SS.staged_psum(local.detach())    # local is the /B share
        # a shard the towers do not reach (an LM backbone's lm_head) gets
        # zeros, so that every rank reduces the same leaves in order
        grads = SS.reduce_grads(
            _or_zeros(names, [shards[k] for k in names], gs), p_dims)
        gtau = gs[-1] if tau_diff is not None else None
        return loss, aux, grads, gtau

    def train_step(state, batch, idx):
        dev = mesh.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        idx = torch.as_tensor(idx, device=dev)
        fcs = state["fc"]
        step = state["step"]
        gamma = gamma_fn(step)
        lr = tc.lr_fn(step)
        tau1, tau2 = ((fcs["tau1"], fcs["tau2"]) if fc.individual_tau
                      else (fcs["tau"], fcs["tau"]))
        rel = (idx - DI._global_index(axes) * fcs["u1"].shape[0]
               if fc.uses_fcco else None)
        loss, aux, grads, gtau = step_grads(state, batch, idx, gamma)
        if tc.guard:
            # every rank evaluates the same global norm
            gnorm = global_norm(grads, axes=("fsdp",), sharded_dims=p_dims)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=dev)

        params = {k: v.detach() for k, v in state["params"].items()}
        new_params, opt = tc.optimizer.update(params, grads, state["opt"],
                                              lr=lr, wd=tc.wd)
        new_fc = dict(fcs)
        metrics = {"loss": loss, "lr": lr, "gamma": gamma,
                   "grad_norm": gnorm}
        if fc.version == "openclip":
            if fc.learnable_tau:
                new_fc = FC.tau_update(fc, new_fc, SS.staged_psum(gtau))
            metrics["tau"] = new_fc.get("tau", tau1)
        else:
            new_fc["u1"] = aux["u1_new"]
            new_fc["u2"] = aux["u2_new"]
            stats = aux["stats"]
            stats_aux = {"lu1_new": aux["u1_rows"],
                         "lu2_new": aux["u2_rows"], "m1": stats.m1,
                         "m2": stats.m2, "dg1_dtau": stats.dg1_dtau,
                         "dg2_dtau": stats.dg2_dtau}
            t1r = tau1[rel] if fc.individual_tau else tau1
            t2r = tau2[rel] if fc.individual_tau else tau2
            tg = FC.tau_gradient(fc, stats_aux, t1r, t2r)
            if fc.individual_tau:
                # per-row gradients stay shard-local (stochastic
                # coordinate update on the owned rows)
                new_fc = FC.tau_update(fc, new_fc, tg, idx=rel)
                metrics["tau"] = pmean(torch.mean(new_fc["tau1"]))
            elif tg is not None:
                new_fc = FC.tau_update(fc, new_fc, pmean(tg))
                metrics["tau"] = new_fc["tau"]
            else:
                metrics["tau"] = tau1
            metrics["u_mean"] = pmean(torch.mean(
                torch.exp(torch.clamp_max(aux["u1_rows"], 80.0))))
            metrics["sat_rate"] = pmean(torch.mean(aux["sat"]))
            metrics["loss_value"] = pmean(FC.loss_value(
                fc, {"lu1_new": aux["u1_rows"], "lu2_new": aux["u2_rows"]},
                t1r, t2r))
        new_fc["step"] = fcs["step"] + 1
        new_state = {"params": new_params, "opt": opt, "fc": new_fc,
                     "step": step + 1}
        if tc.guard:
            # loss and gnorm are global, so ok is the same on every rank
            ok = RG.step_ok(loss, gnorm)
            new_state = RG.select_state(
                ok, {**state, "params": params}, new_state)
            metrics["skipped"] = 1.0 - ok.float()
            metrics["nonfinite_rate"] = pmean(RG.grad_nonfinite_rate(grads))
        return new_state, metrics

    train_step.param_dims = p_dims
    train_step.step_grads = step_grads
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
        params = state["params"]
        walk("params", params if isinstance(params, dict)
             else dict(params.named_parameters()))
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
