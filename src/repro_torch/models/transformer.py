"""Pre-norm transformer blocks and stacks (port of
``repro.models.transformer``: the CLIP text tower's gelu block and the
swiglu block of the LMs, with its one-token decode, and the cross block
of the vlm and the audio decoder).

A block is ``x += attn(rmsnorm(x)); x += mlp(rmsnorm(x))``; a cross
block runs ``x += cross(rmsnorm(x), kv_x)`` between the two.  The
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


def attn_spec(cfg: ArchConfig, *, causal=True,
              window_override=None) -> A.AttnSpec:
    """Attention with the config's qk-norm, QKV bias and RoPE theta
    (causal unless ``causal=False``: the cross spec);
    ``window_override`` replaces the config's sliding window."""
    return A.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.resolved_head_dim,
                      qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                      rope_theta=cfg.rope_theta, causal=causal,
                      sliding_window=(cfg.sliding_window
                                      if window_override is None
                                      else window_override))


_MLPS = {"gelu": L.GeluMLP, "swiglu": L.SwiGLU}


class Block(nn.Module):
    """Pre-norm block with rmsnorm and an MLP: ``mlp="gelu"`` (the CLIP
    text tower), ``"swiglu"`` (the JAX ``init_block`` default: the
    hybrid LM's shared block, the dense LMs' layers) or ``"none"`` (the
    MoE LMs' attention block, whose MLP is the MoE layer after it: it
    keeps ``n2`` unused, as JAX's ``init_block`` does).  ``cross=True``
    adds ``n_cross`` and ``cross``, a cross-attention over d_model-wide
    K/V inputs under the non-causal spec, run after the self-attention
    when the call gives ``kv_x`` (the vlm's cross block, the audio
    decoder's blocks)."""

    def __init__(self, cfg: ArchConfig, spec: A.AttnSpec, mlp="gelu",
                 cross=False):
        super().__init__()
        self.n1 = L.RMSNorm(cfg.d_model)
        self.attn = A.Attention(spec)
        self.n2 = L.RMSNorm(cfg.d_model)
        if mlp != "none":
            self.mlp = _MLPS[mlp](cfg.d_model, cfg.d_ff)
        if cross:
            self.n_cross = L.RMSNorm(cfg.d_model)
            self.cross = A.Attention(attn_spec(cfg, causal=False),
                                     kv_dim=cfg.d_model)

    def _mlp(self, x):
        if not hasattr(self, "mlp"):
            return x
        return x + self.mlp(self.n2(x))

    def forward(self, x, *, kv_x=None, impl="flash"):
        x = x + self.attn(self.n1(x), impl=impl)
        if hasattr(self, "cross") and kv_x is not None:
            x = x + self.cross(self.n_cross(x), kv_x=kv_x, impl=impl)
        return self._mlp(x)

    def decode(self, cache, x, pos: int, window=None, cross_cache=None):
        """One-token decode (``decode_block``); ``cache`` is the block's
        KV cache, updated in place; a cross block with ``cross_cache``
        (``Attention.init_cross_cache``) attends over it too.  Returns
        ``(x, cache)``."""
        h, cache = self.attn.decode(cache, self.n1(x), pos, window)
        x = x + h
        if hasattr(self, "cross") and cross_cache is not None:
            x = x + self.cross.decode_cross(cross_cache, self.n_cross(x))
        return self._mlp(x), cache


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
