"""Shared building blocks (port of ``repro.models.layers``).

Weights keep the JAX package's layout, ``(in, out)`` for a dense layer
used as ``x @ w``, so the params bridge copies arrays without
transposes.  Modules allocate with ``torch.empty`` (so they can be built
on the ``meta`` device for shapes) and fill in ``reset_parameters``
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dense_init_(w: torch.Tensor, gen: torch.Generator, scale=None):
    """N(0, 1) * scale, scale defaulting to 1/sqrt(fan_in); w is (in, out)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    normal_init_(w, gen, scale)


def normal_init_(w: torch.Tensor, gen: torch.Generator, std: float):
    """N(0, std) from ``gen``'s draws, made on its device: into ``w``
    itself where it lies there in the default dtype (no buffer of its
    size, which a host init of a few billion params pays for in seconds),
    else into one buffer copied over.  The same draws, the same bits."""
    with torch.no_grad():
        if (w.device == gen.device and w.dtype == torch.get_default_dtype()
                and w.is_contiguous()):
            w.normal_(generator=gen).mul_(std)
        else:
            w.copy_(torch.randn(w.shape, generator=gen,
                                device=gen.device).mul_(std))


def param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class BlockList(nn.ModuleList):
    """Blocks that the JAX params tree keeps as a Python list, each under
    its index (``vision/stage0/1/c1``), such as a ResNet stage whose
    blocks differ in shape.  An ``nn.ModuleList`` is a layer stack, one
    leaf per parameter with a leading layer axis (``checkpoint.bridge``);
    a ``BlockList`` is not."""


# ---------------------------------------------------------------------------
# Norms (f32 inside, output in the input dtype)
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps=1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale).to(dt)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps=1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = param(dim)

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x):
        return rmsnorm(self.scale, x)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = param(dim)
        self.bias = param(dim)

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class GeluMLP(nn.Module):
    """``gelu(x @ w_in + b_in) @ w_out + b_out`` with the tanh
    approximation of gelu, which is ``jax.nn.gelu``'s default (torch's
    default is the exact erf form)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_in = param(d_model, d_ff)
        self.b_in = param(d_ff)
        self.w_out = param(d_ff, d_model)
        self.b_out = param(d_model)

    def reset_parameters(self, gen):
        dense_init_(self.w_in, gen)
        dense_init_(self.w_out, gen)
        with torch.no_grad():
            self.b_in.zero_()
            self.b_out.zero_()

    def forward(self, x):
        dt = x.dtype
        h = x @ self.w_in.to(dt)
        h = F.gelu(h + self.b_in.to(dt), approximate="tanh")
        return h @ self.w_out.to(dt) + self.b_out.to(dt)


class SwiGLU(nn.Module):
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``, weights (in, out)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = param(d_model, d_ff)
        self.w_up = param(d_model, d_ff)
        self.w_down = param(d_ff, d_model)

    def reset_parameters(self, gen):
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, gen)

    def forward(self, x):
        dt = x.dtype
        h = F.silu(x @ self.w_gate.to(dt)) * (x @ self.w_up.to(dt))
        return h @ self.w_down.to(dt)


# ---------------------------------------------------------------------------
# RoPE (halves concatenated, not interleaved; f32 inside)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(
        rope_frequencies(hd, theta).astype(np.float32)).to(x.device)
    angles = positions[..., None].float() * freqs   # (..., S, hd//2)
    cos = torch.cos(angles)[..., None, :]            # (..., S, 1, hd//2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """Token lookup; ``dtype`` is the activation dtype of the result (the
    table stays in its f32 storage dtype)."""
    x = F.embedding(tokens.long(), table)
    return x if dtype is None else x.to(dtype)


def unembed(table_or_w: torch.Tensor, x: torch.Tensor,
            transpose=False) -> torch.Tensor:
    """Logits.  ``transpose=True``: the argument is the (V, d) embedding
    table (tied embeddings); else a (d, V) head."""
    w = table_or_w.to(x.dtype)
    return x @ (w.T if transpose else w)


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_valid=None) -> torch.Tensor:
    """Mean CE in f32.  ``vocab_valid``: mask out padded vocab entries."""
    logits = logits.float()
    if vocab_valid is not None and vocab_valid < logits.shape[-1]:
        v = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(v < vocab_valid, logits, -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def vocab_parallel_ce(x: torch.Tensor, table: torch.Tensor,
                      labels: torch.Tensor, *, tied: bool,
                      vocab_valid) -> torch.Tensor:
    """Mean CE the Megatron way, as the JAX package computes it: the
    logits in the activation dtype, the padded vocab masked to -1e9,
    ``lse = m + log sum exp(logits - m)`` in f32 with the row max ``m``,
    and the gold logit recomputed in f32 as ``x . table[label]``.

    x: (B, S, d) final hidden; table: (V, d) if tied else (d, V);
    labels: (B, S).  The gold rows are an embedding lookup on the (V, d)
    view, whose backward on the card is deterministic (an indexed gather
    would accumulate its gradient with atomics)."""
    logits = unembed(table, x, transpose=tied)            # (B, S, V)
    V = logits.shape[-1]
    if vocab_valid is not None and vocab_valid < V:
        v = torch.arange(V, device=logits.device)
        logits = torch.where(v < vocab_valid, logits, -1e9)
    m = logits.amax(dim=-1).float()
    lse = m + torch.log(torch.sum(
        torch.exp(logits.float() - m[..., None]), dim=-1))
    rows = F.embedding(labels.long(), table if tied else table.T)
    gold = torch.sum(x.float() * rows.float(), dim=-1)
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# Stacked layers under recompute (JAX's ``scan_layers_grouped``)
# ---------------------------------------------------------------------------

def default_remat_group(n_layers: int) -> int:
    """JAX's sqrt-ish grouping: the largest of 8, 6, 5, 4, 3, 2 that
    divides ``n_layers`` (1 below 8 layers or when none divides)."""
    if n_layers < 8:
        return 1
    for g in (8, 6, 5, 4, 3, 2):
        if n_layers % g == 0:
            return g
    return 1


def run_layers_grouped(remat, layers, f, x, *, group):
    """``x = f(layer, x)`` for each of ``layers`` in order, recomputed in
    the backward as JAX's ``scan_layers_grouped`` recomputes its scan.
    The carry ``x`` is a tensor or a tuple (the MoE stack's ``(h, lb,
    z)``: the aux sums added in layer order, as JAX's carry adds them).
    ``remat(fn, modules, h)`` runs ``fn(h)`` and recomputes it in the
    backward with the weights that ``modules`` hold at the call.

    When ``group <= 1``, ``len(layers) % group`` or ``len(layers) <=
    group``, each layer is recomputed on its own (JAX's fall-back);
    otherwise each run of ``group`` layers is recomputed as one, so that
    the backward keeps one carry per group.  JAX also nests a recompute
    of each layer inside its group's (``inner_remat``); on the H100 that
    form was the slower at the same peak (PERF.md), so the port runs the
    one-level form only."""
    n = len(layers)
    if group <= 1 or n % group or n <= group:
        for lyr in layers:
            x = remat(lambda h, lyr=lyr: f(lyr, h), (lyr,), x)
        return x

    def body(grp):
        def run(h):
            for lyr in grp:
                h = f(lyr, h)
            return h
        return run
    for i in range(0, n, group):
        grp = layers[i:i + group]
        x = remat(body(grp), tuple(grp), x)
    return x
