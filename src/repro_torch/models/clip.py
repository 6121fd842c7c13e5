"""Two-tower CLIP model (port of ``repro.models.clip``).

Text tower: pre-norm causal transformer (rmsnorm, gelu MLP, RoPE), pooled
at the last token.  Vision tower: the ViT or the ResNet-50, per
``cfg.clip.vision_arch``.  Both take ``impl`` (the attention core; the
ResNet has none, so it does not reach it) and ``precision`` (the
activation policy) and return unnormalised f32 embeddings.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import precision as PR
from repro_torch.models import resnet as R
from repro_torch.models import transformer as T
from repro_torch.models import vit as V


class CLIP(nn.Module):
    """Parameter names follow the JAX params tree: ``vision``,
    ``tok_embed``, ``pos_embed``, ``text_blocks``, ``text_norm``,
    ``text_proj``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        c = cfg.clip
        if c.vision_arch == "vit":
            vision = V.ViT(c)
        elif c.vision_arch == "resnet":
            vision = R.ResNet(c)
        else:
            raise ValueError(c.vision_arch)
        self.cfg = cfg
        self.vision = vision
        self.tok_embed = L.param(cfg.vocab_size, cfg.d_model)
        self.pos_embed = L.param(1, c.context_length, cfg.d_model)
        self.text_blocks = T.make_stack(cfg, cfg.n_layers)
        self.text_norm = L.RMSNorm(cfg.d_model)
        self.text_proj = L.param(cfg.d_model, c.embed_dim)

    def reset_parameters(self, gen):
        L.normal_init_(self.tok_embed, gen, 0.02)
        L.normal_init_(self.pos_embed, gen, 0.01)
        L.dense_init_(self.text_proj, gen)


def init_clip(cfg: ArchConfig, gen: torch.Generator) -> CLIP:
    """Random params from ``gen`` (on the CPU): normal(0, 1/sqrt(fan_in))
    dense and conv weights (fan_in kh*kw*cin for HWIO), N(0, 0.02)
    embeddings/CLS/positions (0.01 for the text positions), unit norms,
    zero biases: the JAX package's recipe, but not its random numbers."""
    model = CLIP(cfg)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def encode_image(model: CLIP, images, *, impl="flash", precision=PR.F32):
    if model.cfg.clip.vision_arch == "resnet":
        # no attention in the ResNet: impl is a no-op for it, as in JAX
        return R.apply_resnet(model.vision, images, precision=precision)
    return V.apply_vit(model.vision, images, impl=impl, precision=precision)


def encode_text(model: CLIP, tokens, *, impl="flash", precision=PR.F32):
    """tokens: (B, S) int with S <= context_length (a shorter input uses
    the positional-embedding prefix)."""
    x = L.embed_tokens(model.tok_embed, tokens,
                       dtype=precision.compute_dtype)
    x = x + model.pos_embed[:, :x.shape[1]].to(x.dtype)
    x = T.apply_stack(model.text_blocks, x, impl=impl, precision=precision)
    x = model.text_norm(x)
    out = x[:, -1] @ model.text_proj.to(x.dtype)   # last token
    return PR.cast_output(precision, out)


def encode_pair(model: CLIP, batch, *, impl="flash", precision=PR.F32):
    """batch: {"images": (B,H,W,3), "texts": (B,ctx)} -> (e1, e2)
    unnormalised image/text embeddings in f32."""
    e1 = encode_image(model, batch["images"], impl=impl,
                      precision=precision)
    e2 = encode_text(model, batch["texts"], impl=impl, precision=precision)
    return e1, e2
