"""ViT vision tower for CLIP (port of ``repro.models.vit``): patch embed
-> pre-norm blocks (layernorm, non-causal attention with RoPE theta 1e4,
gelu MLP) -> final layernorm -> CLS pooling -> projection.

Images stay NHWC ``(B, H, W, 3)`` and a patch flattens in (patch_row,
patch_col, channel) order, as in the JAX package: the patch embedding is
a matmul on those vectors, not an NCHW convolution.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import CLIPConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import precision as PR


def vit_spec(c: CLIPConfig) -> A.AttnSpec:
    return A.AttnSpec(d_model=c.vision_width, n_heads=c.vision_heads,
                      n_kv_heads=c.vision_heads,
                      head_dim=c.vision_width // c.vision_heads,
                      causal=False, rope_theta=10_000.0)


class ViTBlock(nn.Module):
    def __init__(self, c: CLIPConfig, spec: A.AttnSpec):
        super().__init__()
        self.n1 = L.LayerNorm(c.vision_width)
        self.attn = A.Attention(spec)
        self.n2 = L.LayerNorm(c.vision_width)
        self.mlp = L.GeluMLP(c.vision_width, 4 * c.vision_width)

    def forward(self, x, *, impl="flash"):
        x = x + self.attn(self.n1(x), impl=impl)
        return x + self.mlp(self.n2(x))


class ViT(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        self.c = c
        n_patches = (c.image_size // c.patch_size) ** 2
        spec = vit_spec(c)
        self.patch = L.param(3 * c.patch_size ** 2, c.vision_width)
        self.cls = L.param(1, 1, c.vision_width)
        self.pos = L.param(1, n_patches + 1, c.vision_width)
        self.blocks = nn.ModuleList(ViTBlock(c, spec)
                                    for _ in range(c.vision_layers))
        self.final_norm = L.LayerNorm(c.vision_width)
        self.proj = L.param(c.vision_width, c.embed_dim)

    def reset_parameters(self, gen):
        L.dense_init_(self.patch, gen)
        L.normal_init_(self.cls, gen, 0.02)
        L.normal_init_(self.pos, gen, 0.02)
        L.dense_init_(self.proj, gen)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """images: (B, H, W, 3) -> (B, n_patches, patch*patch*3)."""
    B, H, W, _ = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, 3)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * 3)


def pos_embed_for_grid(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Adapt the (1, G*G+1, W) positional table to a (gh, gw) patch grid:
    the CLS slot passes through and the grid part is block-mean pooled.
    The native grid returns ``pos`` unchanged."""
    n = pos.shape[1] - 1
    G = int(round(float(n) ** 0.5))
    if (gh, gw) == (G, G):
        return pos
    if G % gh or G % gw:
        raise ValueError(
            f"patch grid ({gh}, {gw}) must divide the positional grid "
            f"({G}, {G})")
    grid = pos[:, 1:].reshape(1, gh, G // gh, gw, G // gw, pos.shape[-1])
    grid = grid.mean(dim=(2, 4)).reshape(1, gh * gw, pos.shape[-1])
    return torch.cat([pos[:, :1], grid], dim=1)


def apply_vit(model: ViT, images: torch.Tensor, *, impl="flash",
              precision=PR.F32) -> torch.Tensor:
    """images: (B, H, W, 3) -> embeddings (B, embed_dim), not normalised."""
    c = model.c
    gh, gw = images.shape[1] // c.patch_size, images.shape[2] // c.patch_size
    x = PR.cast_compute(precision, patchify(images, c.patch_size))
    x = x @ model.patch.to(x.dtype)
    cls = model.cls.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    pos = pos_embed_for_grid(model.pos, gh, gw)
    x = torch.cat([cls, x], dim=1) + pos.to(x.dtype)
    for blk in model.blocks:
        x = blk(x, impl=impl)
    x = model.final_norm(x)
    out = x[:, 0] @ model.proj.to(x.dtype)     # CLS token
    return PR.cast_output(precision, out)
