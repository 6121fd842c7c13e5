"""Pre-norm transformer blocks and stacks (port of
``repro.models.transformer``: the CLIP text tower's gelu block and the
swiglu block of the hybrid and the dense LMs, with its one-token
decode).

A block is ``x += attn(rmsnorm(x)); x += mlp(rmsnorm(x))``.  The
JAX package scans a stacked layer axis; here a stack is an
``nn.ModuleList`` walked in a Python loop, and the params bridge adds or
removes the leading layer axis.
"""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import precision as PR


def attn_spec(cfg: ArchConfig, *, window_override=None) -> A.AttnSpec:
    """Causal self-attention with the config's qk-norm, QKV bias and RoPE
    theta; ``window_override`` replaces the config's sliding window."""
    return A.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.resolved_head_dim,
                      qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                      rope_theta=cfg.rope_theta, causal=True,
                      sliding_window=(cfg.sliding_window
                                      if window_override is None
                                      else window_override))


_MLPS = {"gelu": L.GeluMLP, "swiglu": L.SwiGLU}


class Block(nn.Module):
    """Pre-norm block with rmsnorm and an MLP: ``mlp="gelu"`` (the CLIP
    text tower), ``"swiglu"`` (the JAX ``init_block`` default: the
    hybrid LM's shared block, the dense LMs' layers) or ``"none"`` (the
    MoE LMs' attention block, whose MLP is the MoE layer after it: it
    keeps ``n2`` unused, as JAX's ``init_block`` does)."""

    def __init__(self, cfg: ArchConfig, spec: A.AttnSpec, mlp="gelu"):
        super().__init__()
        self.n1 = L.RMSNorm(cfg.d_model)
        self.attn = A.Attention(spec)
        self.n2 = L.RMSNorm(cfg.d_model)
        if mlp != "none":
            self.mlp = _MLPS[mlp](cfg.d_model, cfg.d_ff)

    def _mlp(self, x):
        if not hasattr(self, "mlp"):
            return x
        return x + self.mlp(self.n2(x))

    def forward(self, x, *, impl="flash"):
        x = x + self.attn(self.n1(x), impl=impl)
        return self._mlp(x)

    def decode(self, cache, x, pos: int, window=None):
        """One-token decode (``decode_block``); ``cache`` is the block's
        KV cache, updated in place.  Returns ``(x, cache)``."""
        h, cache = self.attn.decode(cache, self.n1(x), pos, window)
        return self._mlp(x + h), cache


def make_stack(cfg: ArchConfig, n_layers: int, mlp="gelu") -> nn.ModuleList:
    spec = attn_spec(cfg)
    return nn.ModuleList(Block(cfg, spec, mlp) for _ in range(n_layers))


def apply_stack(blocks: nn.ModuleList, x, *, impl="flash",
                precision=PR.F32):
    """The input is cast to the policy's compute dtype once here and
    every block follows (params are cast at their use sites)."""
    x = PR.cast_compute(precision, x)
    for blk in blocks:
        x = blk(x, impl=impl)
    return x
