"""ResNet-50 vision tower (port of ``repro.models.resnet``, the paper's
medium-scale setting).  As in the JAX package: GroupNorm(32) in place of
BatchNorm and global average pooling + a linear projection in place of
CLIP's attention pooling.

Layouts.  Images arrive NHWC ``(B, H, W, 3)``, as everywhere in the port.
Conv weights keep the JAX package's HWIO layout ``(kh, kw, cin, cout)``,
so the params bridge copies them as they are; each use passes the OIHW
view ``w.permute(3, 2, 0, 1)``, cast to the activation dtype.  The
activations are contiguous NCHW from the stem (one transpose of the
images) to the pooling, which averages H and W.

Padding.  XLA's ``"SAME"`` pads ``max((ceil(n/s) - 1)*s + k - n, 0)`` in
all, the smaller half first: under stride 2 it is asymmetric (the stem's
7x7/2 at 224 pads (2, 3), a 3x3/2 on an even size (0, 1)), which
``padding=k//2`` is not.  ``same_pads`` computes the pads per call from
the input size, and the max-pool pads with ``-inf``.

The JAX package computes the convolutions with
``lax.conv_general_dilated`` and GroupNorm in plain ``jnp``, outside any
Pallas kernel, so their counterparts here are ``F.conv2d`` (cuDNN on the
card, TF32 off and deterministic under the port's device policy,
``repro_torch.device``) and ``F.group_norm``.  The tower has no
attention: ``impl`` does not reach it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import CLIPConfig
from repro_torch.models import layers as L
from repro_torch.models import precision as PR

BOTTLENECK_COUNTS = {50: (3, 4, 6, 3)}


def same_pads(n: int, k: int, s: int):
    """(before, after) padding of XLA's ``"SAME"`` on a size-``n`` dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, C, H, W); w: HWIO.  XLA's ``"SAME"`` padding."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], w.shape[0], stride),
                                    same_pads(x.shape[3], w.shape[1], stride))
    w = w.to(x.dtype).permute(3, 2, 0, 1)
    if (top, left) == (bottom, right):
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def max_pool(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """k x k max-pool at stride s with XLA's ``"SAME"`` (``-inf``)
    padding; x: (B, C, H, W)."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, s),
                                    same_pads(x.shape[3], k, s))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def groupnorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x: (B, C, H, W), ``min(groups, C)`` groups of contiguous channels;
    statistics (the biased variance) and the affine in f32, the result in
    x's dtype."""
    g = min(groups, x.shape[1])
    return F.group_norm(x.float(), g, scale, bias, eps).to(x.dtype)


class GroupNorm(L.LayerNorm):
    """LayerNorm's ``scale`` and ``bias`` (unit, zero), GroupNorm's
    statistics over (B, C, H, W)."""

    def forward(self, x):
        return groupnorm(self.scale, self.bias, x)


def conv_init_(w: torch.Tensor, gen: torch.Generator):
    """N(0, 1) / sqrt(kh * kw * cin) for an HWIO weight."""
    kh, kw, cin, _ = w.shape
    L.normal_init_(w, gen, 1.0 / math.sqrt(kh * kw * cin))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 x4, each conv followed by GroupNorm;
    ``down``/``down_n`` project the shortcut when the stride or the width
    changes."""

    def __init__(self, cin: int, cmid: int, stride: int):
        super().__init__()
        cout = cmid * 4
        self.stride = stride
        self.c1, self.n1 = L.param(1, 1, cin, cmid), GroupNorm(cmid)
        self.c2, self.n2 = L.param(3, 3, cmid, cmid), GroupNorm(cmid)
        self.c3, self.n3 = L.param(1, 1, cmid, cout), GroupNorm(cout)
        self.project = stride != 1 or cin != cout
        if self.project:
            self.down, self.down_n = L.param(1, 1, cin, cout), GroupNorm(cout)

    def reset_parameters(self, gen):
        for w in (self.c1, self.c2, self.c3) + (
                (self.down,) if self.project else ()):
            conv_init_(w, gen)

    def forward(self, x):
        h = F.relu(self.n1(conv(x, self.c1)))
        h = F.relu(self.n2(conv(h, self.c2, self.stride)))
        h = self.n3(conv(h, self.c3))
        if self.project:
            x = self.down_n(conv(x, self.down, self.stride))
        return F.relu(x + h)


class ResNet(nn.Module):
    """Parameter names follow the JAX params tree: ``stem``,
    ``stem_n/{scale,bias}``, ``stage{0..3}/{i}/{c1,n1,c2,n2,c3,n3,down,
    down_n}`` (a stage is a ``layers.BlockList``), ``proj``."""

    def __init__(self, c: CLIPConfig):
        super().__init__()
        width = c.vision_width           # stem width, 64 for RN50
        self.stem = L.param(7, 7, 3, width)
        self.stem_n = GroupNorm(width)
        cin = width
        for si, n in enumerate(BOTTLENECK_COUNTS[50]):
            cmid = width * 2 ** si
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(cin, cmid,
                                         2 if (bi == 0 and si > 0) else 1))
                cin = cmid * 4
            setattr(self, f"stage{si}", L.BlockList(blocks))
        self.proj = L.param(cin, c.embed_dim)

    def reset_parameters(self, gen):
        conv_init_(self.stem, gen)
        L.dense_init_(self.proj, gen)


def apply_resnet(model: ResNet, images: torch.Tensor, *,
                 precision=PR.F32) -> torch.Tensor:
    """images: (B, H, W, 3) -> embeddings (B, embed_dim), not normalised.
    Convs and the projection run in the policy's compute dtype (GroupNorm
    in f32 inside); the output is cast to f32."""
    x = PR.cast_compute(precision, images).permute(0, 3, 1, 2).contiguous()
    x = F.relu(model.stem_n(conv(x, model.stem, stride=2)))
    x = max_pool(x)
    for si in range(len(BOTTLENECK_COUNTS[50])):
        for blk in getattr(model, f"stage{si}"):
            x = blk(x)
    out = x.mean(dim=(2, 3)) @ model.proj.to(x.dtype)
    return PR.cast_output(precision, out)
