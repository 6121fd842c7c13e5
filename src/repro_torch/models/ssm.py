"""Mamba2 (chunkwise SSD) blocks (port of ``repro.models.ssm``).

The SSD recurrence per head (state S: (N, P)):

    S_t = a_t * S_{t-1} + B_t (x) x_t        a_t in (0, 1]
    y_t = C_t . S_t  (+ D * x_t skip)

Prefill uses the chunkwise algorithm (``ssd_chunked``, or the hand-written
kernel K4 ``kernels.ssd_chunk.ssd_chunk`` on the card); decode is the
plain one-step recurrence; ``ssd_sequential`` is the oracle of the tests.

Routing, the one place where the port differs from the JAX package: the
JAX ``apply_mamba2`` always runs the jnp ``ssd_chunked`` and leaves its
Pallas kernel unused; here ``impl="flash"`` (the default of the port's
entry points) runs the kernel wrapper, ``"chunked"``/``"naive"`` the
plain ``ssd_chunked``, and ``chunked=False`` keeps ``ssd_sequential``.
The function computed is the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_scan_plain
from repro_torch.models import layers as L

IMPLS = ("flash", "chunked", "naive")

# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_sequential(x, log_a, Bm, Cm, S0=None):
    """Oracle.  x: (B,T,H,P); log_a: (B,T,H); Bm/Cm: (B,T,N).
    Returns y (B,T,H,P), S_final (B,H,N,P)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    S = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if S0 is None else S0)
    x, log_a, Bm, Cm = x.float(), log_a.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(T):
        S, y = ssd_decode_step(S, x[:, t], log_a[:, t], Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), S


def ssd_chunked(x, log_a, Bm, Cm, S0=None, chunk=256):
    """Chunkwise SSD in plain torch.  Same signature and semantics as
    ``ssd_sequential``."""
    return ssd_scan_plain(x, log_a, Bm, Cm, S0=S0, chunk=chunk)


def ssd_decode_step(S, x_t, log_a_t, B_t, C_t):
    """One-token decode.  S: (B,H,N,P); x_t: (B,H,P); log_a_t: (B,H);
    B_t/C_t: (B,N)."""
    a = torch.exp(log_a_t.float())[:, :, None, None]
    S = a * S + torch.einsum("bn,bhp->bhnp", B_t.float(), x_t.float())
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), S)
    return S, y


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def _dims(cfg: ArchConfig):
    d = cfg.d_model
    d_inner = cfg.ssm.expand * d
    P = cfg.ssm.head_dim
    H = d_inner // P
    N = cfg.ssm.state_size
    return d, d_inner, P, H, N


class Mamba2(nn.Module):
    """Parameters named as the JAX ``init_mamba2``: ``norm``, ``w_in``
    (d -> [z, x, B, C, dt]), ``conv_w`` (w, channels), ``conv_b``,
    ``A_log``, ``dt_bias``, ``D``, ``gnorm``, ``w_out``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d, d_inner, P, H, N = _dims(cfg)
        w = cfg.ssm.conv_width
        conv_ch = d_inner + 2 * N
        self.norm = L.RMSNorm(d)
        self.w_in = L.param(d, 2 * d_inner + 2 * N + H)
        self.conv_w = L.param(w, conv_ch)
        self.conv_b = L.param(conv_ch)
        self.A_log = L.param(H)
        self.dt_bias = L.param(H)
        self.D = L.param(H)
        self.gnorm = L.RMSNorm(d_inner)
        self.w_out = L.param(d_inner, d)

    def reset_parameters(self, gen):
        L.dense_init_(self.w_in, gen)
        L.normal_init_(self.conv_w, gen, 1.0 / math.sqrt(self.conv_w.shape[0]))
        L.dense_init_(self.w_out, gen)
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.zero_()             # A = -exp(A_log) = -1
            self.dt_bias.fill_(-2.0)       # softplus(-2) ~ 0.13
            self.D.fill_(1.0)


def _split_proj(cfg, proj):
    d, d_inner, P, H, N = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, state=None):
    """Depthwise causal conv.  xbc: (B,T,C); conv_w: (w,C).
    state: (B,w-1,C) previous inputs for decode; returns (out, new_state)."""
    w = conv_w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], w - 1, xbc.shape[-1]),
                            dtype=xbc.dtype, device=xbc.device)
    xfull = torch.cat([state, xbc], dim=1)
    T = xbc.shape[1]
    out = sum(xfull[:, i:i + T] * conv_w[i].to(xbc.dtype) for i in range(w))
    out = F.silu(out + conv_b.to(xbc.dtype))
    return out, xfull[:, -(w - 1):]


def _ssm_inputs(cfg, m: Mamba2, xbc_conv, dt_raw):
    """(x_heads f32, log_a f32 <= 0, Bm, Cm in the activation dtype)."""
    d, d_inner, P, H, N = _dims(cfg)
    xs, Bm, Cm = torch.split(xbc_conv, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + m.dt_bias)             # (..., H)
    A = -torch.exp(m.A_log)                                 # (H,)
    log_a = dt * A
    x_heads = xs.reshape(*xs.shape[:-1], H, P).float() * dt[..., None]
    return x_heads, log_a, Bm, Cm


def _gate_out(m: Mamba2, x, y, z, xh, d_inner):
    y = y + m.D[None, None, :, None] * xh
    y = y.reshape(x.shape[0], x.shape[1], d_inner).to(x.dtype)
    y = m.gnorm(y * F.silu(z))
    return x + y @ m.w_out.to(x.dtype)


def apply_mamba2(m: Mamba2, cfg: ArchConfig, x, *, impl="flash",
                 chunked=True):
    """Prefill.  x: (B,T,d)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
    d, d_inner, P, H, N = _dims(cfg)
    h = m.norm(x)
    z, xbc, dt_raw = _split_proj(cfg, h @ m.w_in.to(h.dtype))
    xbc, _ = _causal_conv(xbc, m.conv_w, m.conv_b)
    xh, log_a, Bm, Cm = _ssm_inputs(cfg, m, xbc, dt_raw)
    if not chunked:
        y, _ = ssd_sequential(xh, log_a, Bm, Cm)
    elif impl == "flash":
        y = ssd_chunk(xh, log_a, Bm, Cm, chunk=cfg.ssm.chunk)
    else:
        y, _ = ssd_chunked(xh, log_a, Bm, Cm, chunk=cfg.ssm.chunk)
    return _gate_out(m, x, y, z, xh, d_inner)


def init_mamba2_cache(cfg: ArchConfig, batch, lead=(), device=None):
    """Zero decode cache (``conv``: the last w-1 conv inputs, ``S``: the
    SSD state), f32, with optional leading (layer) axes ``lead``."""
    d, d_inner, P, H, N = _dims(cfg)
    w = cfg.ssm.conv_width
    return {"conv": torch.zeros((*lead, batch, w - 1, d_inner + 2 * N),
                                dtype=torch.float32, device=device),
            "S": torch.zeros((*lead, batch, H, N, P), dtype=torch.float32,
                             device=device)}


def decode_mamba2(m: Mamba2, cfg: ArchConfig, cache, x):
    """One-token decode.  x: (B,1,d).  Writes the new conv state and SSD
    state into ``cache`` in place (JAX returns a new cache) and returns
    ``(out, cache)``."""
    d, d_inner, P, H, N = _dims(cfg)
    h = m.norm(x)
    z, xbc, dt_raw = _split_proj(cfg, h @ m.w_in.to(h.dtype))
    xbc, conv_state = _causal_conv(xbc, m.conv_w, m.conv_b,
                                   state=cache["conv"].to(xbc.dtype))
    xh, log_a, Bm, Cm = _ssm_inputs(cfg, m, xbc, dt_raw)
    S, y = ssd_decode_step(cache["S"], xh[:, 0], log_a[:, 0], Bm[:, 0],
                           Cm[:, 0])
    cache["conv"].copy_(conv_state)
    cache["S"].copy_(S)
    return _gate_out(m, x, y[:, None], z, xh, d_inner), cache
