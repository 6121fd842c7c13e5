"""Mixture-of-Experts layer: top-k routing with per-row capacity dispatch
(port of ``repro.models.moe``'s ``moe_capacity``, ``init_moe`` and
``apply_moe``).

Capacity per (row, expert) is ``S * top_k / E * capacity_factor``, at
least ``top_k`` and at most ``S``; tokens over it are dropped (Switch
style) and pass on the residual stream only.  ``route`` makes every
routing decision: the router's top-k per token, then the top-``C``
tokens per (row, expert) by selection weight.  Both top-k follow
``jax.lax.top_k``'s rule, highest value first and the lower index first
among equal values (a stable descending sort), on the CPU and on the
card: with ``top_k = 1`` every selection weight is exactly 1.0, so which
tokens an expert keeps is that tie rule alone (``torch.topk`` orders
ties otherwise).

Dispatch is a gather of the picked tokens, the experts are three
batched products over the expert axis (``torch.bmm``; the JAX package
runs them as einsums outside any kernel), and the combine gathers each
token's outputs of the experts it was routed to and kept by, and sums
them in ascending expert order: the order in which JAX's scatter-add
applies them, with no atomics, so that a call is a function of its
inputs bit for bit.  In decode (S = 1) the capacity is 1: every expert
computes the one token, with weight 0 unless it was routed there, as in
JAX.

Under autograd the gradients are JAX's: they flow through both top-k's
values (the sort's), the selection weights, the combine's weights and
the aux losses; ``frac_tokens`` carries none.  The dispatch's backward
(``_Dispatch``) sums each token row's gradients over the experts that
picked it in ascending expert order, one expert at a time, without
atomics (the gather's own backward accumulates them with atomics on the
card, in no fixed order; a token is picked by its kept experts and by
every expert that fills its capacity with it).  The combine's gathers
read each (expert, row, slot) for at most one token, so their backward
adds nothing but zeros where indices collide, in whatever order.

``apply_moe_a2a_local`` (JAX's expert-parallel all-to-all body over a
``model`` mesh axis) is not ported: the port carries no ``model`` axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def moe_capacity(S: int, E: int, top_k: int, factor: float) -> int:
    # capped at S (top_k over the token axis requires C <= S); decode
    # (S = 1) degenerates to every expert computing the one token
    return min(S, max(top_k, int(np.ceil(S * top_k / E * factor))))


class MoE(nn.Module):
    """``norm``, ``router`` (d, E), the expert stacks ``w_gate`` /
    ``w_up`` (E, d, d_ff) and ``w_down`` (E, d_ff, d), and, with
    ``shared_expert``, an always-on ``shared`` SwiGLU.  JAX's init
    recipe: the router ``dense_init(scale=0.02)``, each expert stack
    N(0, 1) / sqrt(its input dim)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d, m = cfg.d_model, cfg.moe
        E, dff = m.n_experts, m.d_ff
        self.norm = L.RMSNorm(d)
        self.router = L.param(d, E)
        self.w_gate = L.param(E, d, dff)
        self.w_up = L.param(E, d, dff)
        self.w_down = L.param(E, dff, d)
        if m.shared_expert:
            self.shared = L.SwiGLU(d, dff)

    def reset_parameters(self, gen):
        L.dense_init_(self.router, gen, 0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            L.normal_init_(w, gen, 1.0 / math.sqrt(w.shape[1]))


class Route(NamedTuple):
    """One MoE call's routing: ``gates`` (B, S, k) the renormalised gate
    values of each token's ``experts`` (B, S, k), highest first; for
    each (row, expert) the ``picks`` (B, E, C), token ids, and their
    selection weights ``pick_w`` (B, E, C), 0 for a pick that fills the
    capacity with a token not routed there."""
    gates: torch.Tensor
    experts: torch.Tensor
    pick_w: torch.Tensor
    picks: torch.Tensor


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, highest first, the lower index first among equal
    values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, k: int, C: int) -> Route:
    """probs: (B, S, E) f32 router probabilities -> the ``Route``: each
    token's top-k experts, gates renormalised to sum to 1, then per
    (row, expert) the top-C tokens by selection weight (the gate of a
    token routed there, else 0)."""
    gates, experts = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    sel = torch.zeros_like(probs).scatter_(-1, experts, gates)
    pick_w, picks = top_k(sel.transpose(1, 2), C)
    return Route(gates, experts, pick_w, picks)


def _combine(eo, r: Route, B: int, S: int, E: int, C: int):
    """eo: (E * B * C, d) expert outputs in (expert, row, pick) order ->
    (B, S, d): each token's weighted outputs of the experts that kept
    it, summed in ascending expert order."""
    dev = eo.device
    k = r.experts.shape[-1]
    slot = torch.full((B, E, S), -1, dtype=torch.long, device=dev)
    slot.scatter_(2, r.picks, torch.arange(C, device=dev).expand(B, E, C))
    experts, _ = torch.sort(r.experts, dim=-1)       # distinct ids
    b = torch.arange(B, device=dev)[:, None, None]
    c = slot[b, experts, torch.arange(S, device=dev)[None, :, None]]
    kept = c >= 0                                    # (B, S, k)
    src = (experts * B + b) * C + c.clamp(min=0)
    w = r.pick_w.transpose(0, 1).reshape(-1)[src].to(eo.dtype)
    out = None
    for j in range(k):
        part = torch.where(kept[..., j, None], eo[src[..., j]]
                           * w[..., j, None], 0.0)
        out = part if out is None else out + part
    return out


def dispatch_backward(g: torch.Tensor, idx: torch.Tensor,
                      rows: int) -> torch.Tensor:
    """The gradient of ``h2[idx]`` with respect to ``h2`` (``rows``
    rows): g (E, n, d), idx (E, n) with distinct rows per expert ->
    (rows, d), each row's gradients summed from 0 in ascending expert
    order, an expert's rows at a time (no row twice in one copy)."""
    out = g.new_zeros((rows, g.shape[-1]))
    for e in range(idx.shape[0]):
        out.index_copy_(0, idx[e], out.index_select(0, idx[e]) + g[e])
    return out


class _Dispatch(torch.autograd.Function):
    """``h2[idx]``: h2 (T, d) token rows, idx (E, n) each expert's picked
    rows -> (E, n, d); the backward is ``dispatch_backward``."""

    @staticmethod
    def forward(ctx, h2, idx):
        ctx.save_for_backward(idx)
        ctx.rows = h2.shape[0]
        return h2[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return dispatch_backward(g, idx, ctx.rows), None


def apply_moe(moe: MoE, cfg: ArchConfig, x: torch.Tensor):
    """x: (B, S, d) -> (x + MoE(rmsnorm(x)) (B, S, d), aux losses
    {"moe_lb": Switch load balance, "moe_z": router z-loss}, each times
    its coefficient)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    C = moe_capacity(S, E, k, m.capacity_factor)

    h = moe.norm(x)
    logits = (h @ moe.router.to(h.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # (B, S, E)
    r = route(probs, k, C)

    # dispatch: the picked tokens of each expert, (E, B * C, d)
    rows = r.picks + S * torch.arange(B, device=x.device)[:, None, None]
    disp = _Dispatch.apply(h.reshape(B * S, d),
                           rows.transpose(0, 1).reshape(E, B * C))
    dt = h.dtype
    g = torch.bmm(disp, moe.w_gate.to(dt))
    u = torch.bmm(disp, moe.w_up.to(dt))
    eo = torch.bmm(F.silu(g) * u, moe.w_down.to(dt))
    out = _combine(eo.reshape(E * B * C, d), r, B, S, E, C)
    if hasattr(moe, "shared"):
        out = out + moe.shared(h)

    counts = torch.zeros_like(probs).scatter_(-1, r.experts, 1.0)
    frac_tokens = counts.mean(dim=(0, 1))                      # (E,)
    frac_probs = probs.mean(dim=(0, 1))
    lb = E * torch.sum(frac_tokens * frac_probs) / max(k, 1)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"moe_lb": m.aux_coef * lb, "moe_z": m.router_z_coef * z}
    return x + out.to(x.dtype), aux
