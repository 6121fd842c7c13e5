"""Self- and cross-attention with GQA, RoPE, optional RMS qk-norm and QKV
bias (port of ``repro.models.attention``).

Shapes: x (B, S, d); q (B, S, H, hd); k/v (B, S, Hkv, hd).  ``impl``
selects the attention core: "flash", the default (the hand-written kernel
for CUDA tensors, its plain version for CPU tensors), or one of the plain
PyTorch references the tests hold it to: "chunked" (online softmax over q
and kv blocks, the JAX package's default) and "naive" (the
O(S^2)-memory oracle).  ``Attention.decode`` is the one-token KV-cache
path (plain PyTorch, as in the JAX package, which runs it in jnp with no
kernel).

Cross-attention (``forward(x, kv_x=...)``) takes K/V from another
sequence (the vlm's projected image, the audio encoder's output), with
no RoPE on q or k and neither a causal mask nor a window, whatever the
spec says; its K/V projections take ``kv_dim`` inputs.  Decode
projects the cross K/V once (``init_cross_cache``) and attends over
them unmasked (``decode_cross``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.models import layers as L

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False       # RMSNorm over the head dim of q and k
    qkv_bias: bool = False
    rope_theta: float = 1e6
    causal: bool = True
    sliding_window: int = 0     # 0 = full
    q_chunk: Optional[int] = None   # chunked impl block sizes (512 / 1024)
    kv_chunk: Optional[int] = None


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, Hk, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, Hk, n_rep, hd).reshape(
        B, S, Hk * n_rep, hd)


def _block_mask(q_pos, k_pos, causal, window):
    """(qc, kc) boolean mask of allowed positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def chunked_attention(q, k, v, *, causal=True, window=0, q_chunk=512,
                      kv_chunk=1024):
    """Online-softmax attention over (q_chunk, kv_chunk) blocks.
    q: (B, Sq, H, hd), k/v: (B, Sk, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for q0 in range(0, Sq, qc):
        qblk = q[:, q0:q0 + qc] * scale
        n = qblk.shape[1]
        q_pos = q0 + torch.arange(n, device=dev)
        acc = torch.zeros((B, n, H, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, H, n), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, kc):
            kblk, vblk = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            k_pos = k0 + torch.arange(kblk.shape[1], device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk.float(), kblk.float())
            mask = _block_mask(q_pos, k_pos, causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # mask again: a fully masked block keeps m_new at NEG_INF and
            # exp(s - m_new) would be 1, not 0
            p = torch.exp(s - m_new[..., None]) * mask
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vblk.dtype).float(),
                              vblk.float())
            acc = acc * alpha.transpose(1, 2)[..., None] + pv
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append(acc / l.transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def naive_attention(q, k, v, *, causal=True, window=0):
    """Reference O(S^2)-memory attention (oracle for tests)."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    s = torch.where(_block_mask(q_pos, k_pos, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


class Attention(nn.Module):
    """Projections ``wq``/``wk``/``wv`` of shape (d, heads*hd) and ``wo``
    of (H*hd, d), in the JAX package's (in, out) layout; with
    ``qkv_bias`` the biases ``bq``/``bk``/``bv`` (zeros at init), with
    ``qk_norm`` the per-head RMSNorms ``q_norm``/``k_norm`` (scale ones
    at init), as ``init_attention``; ``kv_dim`` (default d) is the input
    width of ``wk``/``wv`` (cross-attention)."""

    def __init__(self, spec: AttnSpec, kv_dim: Optional[int] = None):
        super().__init__()
        self.spec = spec
        H, Hk, hd, d = (spec.n_heads, spec.n_kv_heads, spec.head_dim,
                        spec.d_model)
        kv_dim = kv_dim or d
        self.wq = L.param(d, H * hd)
        self.wk = L.param(kv_dim, Hk * hd)
        self.wv = L.param(kv_dim, Hk * hd)
        self.wo = L.param(H * hd, d)
        if spec.qkv_bias:
            self.bq = L.param(H * hd)
            self.bk = L.param(Hk * hd)
            self.bv = L.param(Hk * hd)
        if spec.qk_norm:
            self.q_norm = L.RMSNorm(hd)
            self.k_norm = L.RMSNorm(hd)

    def reset_parameters(self, gen):
        for w in (self.wq, self.wk, self.wv):
            L.dense_init_(w, gen)
        L.dense_init_(self.wo, gen, scale=1.0 / math.sqrt(self.wo.shape[0]))
        if self.spec.qkv_bias:
            with torch.no_grad():
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()

    def _q(self, x):
        """JAX's ``_project_q``: projection, bias, per-head reshape,
        qk-norm; (B, S, H, hd), no RoPE."""
        spec = self.spec
        B, S, _ = x.shape
        q = x @ self.wq.to(x.dtype)
        if spec.qkv_bias:
            q = q + self.bq.to(x.dtype)
        q = q.reshape(B, S, spec.n_heads, spec.head_dim)
        return self.q_norm(q) if spec.qk_norm else q

    def _kv(self, x):
        """JAX's ``_project_kv``: k/v (B, S, Hkv, hd), no RoPE."""
        spec = self.spec
        B, S, _ = x.shape
        dt = x.dtype
        k, v = x @ self.wk.to(dt), x @ self.wv.to(dt)
        if spec.qkv_bias:
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        k = k.reshape(B, S, spec.n_kv_heads, spec.head_dim)
        v = v.reshape(B, S, spec.n_kv_heads, spec.head_dim)
        return (self.k_norm(k) if spec.qk_norm else k), v

    def _qkv(self, x, positions):
        """JAX's order: projection, bias, per-head reshape, qk-norm, then
        RoPE at ``positions`` (broadcastable to (B, S)): q (B, S, H, hd),
        k/v (B, S, Hkv, hd)."""
        spec = self.spec
        q = L.apply_rope(self._q(x), positions, spec.rope_theta)
        k, v = self._kv(x)
        return q, L.apply_rope(k, positions, spec.rope_theta), v

    def forward(self, x, *, kv_x=None, impl="flash"):
        """Self-attention, or cross-attention over ``kv_x`` (B, Skv,
        kv_dim): no RoPE, no causal mask, no window."""
        spec = self.spec
        B, S, _ = x.shape
        if kv_x is None:
            q, k, v = self._qkv(
                x, torch.arange(S, device=x.device).expand(B, S))
            causal, window = spec.causal, spec.sliding_window
        else:
            q, (k, v) = self._q(x), self._kv(kv_x)
            causal, window = False, 0
        n_rep = spec.n_heads // spec.n_kv_heads
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if impl == "chunked":
            out = chunked_attention(q, k, v, causal=causal, window=window,
                                    q_chunk=spec.q_chunk or 512,
                                    kv_chunk=spec.kv_chunk or 1024)
        elif impl == "flash":
            out = flash_mha(q, k, v, causal=causal, window=window)
        elif impl == "naive":
            out = naive_attention(q, k, v, causal=causal, window=window)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
        out = out.reshape(B, S, spec.n_heads * spec.head_dim)
        return out @ self.wo.to(x.dtype)

    def decode(self, cache, x, pos: int, window=None):
        """One-token decode.  x: (B, 1, d); ``pos`` the absolute position.
        The cache (``init_kv_cache``) is a ring buffer of W slots holding
        k/v with RoPE applied at write time and ``slot_pos``, the absolute
        position in each slot (-1 = empty).  Writes the new k/v into
        ``cache`` in place (JAX returns a new cache) and returns
        ``(out (B, 1, d), cache)``.  ``window`` overrides the spec's
        sliding window."""
        spec = self.spec
        B = x.shape[0]
        posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        q, k_new, v_new = self._qkv(x, posb)
        W = cache["k"].shape[1]
        slot = pos % W
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][slot] = pos
        slot_pos = cache["slot_pos"]
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        window = spec.sliding_window if window is None else window
        if window:
            valid &= slot_pos > pos - window
        n_rep = spec.n_heads // spec.n_kv_heads
        kr = _repeat_kv(cache["k"], n_rep)
        vr = _repeat_kv(cache["v"], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) / \
            math.sqrt(spec.head_dim)
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype), vr)
        out = out.reshape(B, 1, spec.n_heads * spec.head_dim).to(x.dtype)
        return out @ self.wo.to(x.dtype), cache

    def init_cross_cache(self, kv_x):
        """Cross K/V projected once from ``kv_x`` (B, Skv, kv_dim): {"k",
        "v"} of (B, Skv, Hkv, hd), before the GQA repeat."""
        k, v = self._kv(kv_x)
        return {"k": k, "v": v}

    def decode_cross(self, cross_cache, x):
        """One-token cross-attention over a filled cross cache (cast to
        x's dtype), unmasked.  x: (B, 1, d) -> (B, 1, d)."""
        spec = self.spec
        B = x.shape[0]
        q = self._q(x)
        n_rep = spec.n_heads // spec.n_kv_heads
        k = _repeat_kv(cross_cache["k"].to(x.dtype), n_rep)
        v = _repeat_kv(cross_cache["v"].to(x.dtype), n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / \
            math.sqrt(spec.head_dim)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
        out = out.reshape(B, 1, spec.n_heads * spec.head_dim).to(x.dtype)
        return out @ self.wo.to(x.dtype)


def init_kv_cache(spec: AttnSpec, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None, lead=()):
    """Zero KV cache of ``min(window or max_len, max_len)`` slots, with
    optional leading (layer) axes ``lead``."""
    W = min(spec.sliding_window or max_len, max_len)
    shape = (*lead, batch, W, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((*lead, W), -1, dtype=torch.int32,
                                   device=device)}
