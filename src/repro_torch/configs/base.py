"""Architecture configuration for the PyTorch port.

An own copy of ``ArchConfig``/``CLIPConfig``/``SSMConfig``/``MoEConfig``,
the input shapes and the registry: the port imports nothing of the JAX
package.  The paper's three CLIP settings (ResNet-50 on CC3M, ViT-B/32 on
CC12M, ViT-B/16 on LAION), the hybrid ``zamba2-1.2b``, the dense LMs
(``qwen3-1.7b``, ``yi-6b``, ``granite-3-8b``, ``qwen1.5-32b``) and the
MoE LMs (``qwen3-moe-30b-a3b``, ``llama4-scout-17b-a16e``) are
registered here, and so are the vlm ``llama-3.2-vision-11b``, the
audio encoder-decoder ``seamless-m4t-large-v2`` and the xLSTM
``xlstm-125m`` (family ``ssm``); ``reduced()`` gives the
same small shapes as the JAX package's ``reduced()``, which is what lets
the tests load one set of params into both packages.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                  # per-expert hidden size
    every: int = 1                 # MoE layer every `every` layers
    shared_expert: bool = False    # additional always-on expert
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3    # router z-loss (load-balance aux built in)
    aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 0            # N (per-channel state)
    head_dim: int = 64             # P
    expand: int = 2                # d_inner = expand * d_model
    chunk: int = 256               # chunkwise SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Two-tower CLIP settings (paper Table 2)."""
    vision_arch: str = "vit"       # "vit" | "resnet"
    image_size: int = 224
    patch_size: int = 32           # vit only
    vision_layers: int = 12
    vision_width: int = 768
    vision_heads: int = 12
    embed_dim: int = 512           # joint embedding dim
    context_length: int = 77       # text tower context


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # clip, hybrid, dense, moe, vlm, audio, ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 0        # 0 = full attention
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # ssm (xLSTM): block kinds cycled over the layers ("m" mLSTM, "s" sLSTM)
    xlstm_pattern: str = ""
    # hybrid: one shared attention block applied every this many layers
    hybrid_attn_every: int = 0
    # vlm: a cross-attention block every this many layers, over the stub
    # image embeds (B, n_image_tokens, vision_dim) projected to d_model
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    vision_dim: int = 0
    # audio (encoder-decoder): encoder layers over stub frames (B,
    # seq_len // audio_subsample, d_model)
    enc_layers: int = 0            # > 0: an encoder-decoder model
    audio_subsample: int = 4
    clip: Optional[CLIPConfig] = None
    # activation policy of the towers ("f32" | "bf16", models.precision)
    precision: str = "f32"
    source: str = ""
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: the JAX package's ``reduced()``."""
        kw = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
        )
        if self.moe.n_experts:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff=min(self.moe.d_ff, 128))
        if self.ssm.state_size:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_size=min(self.ssm.state_size, 16),
                head_dim=32, chunk=16)
        if self.enc_layers:
            kw["enc_layers"] = 1
            kw["n_layers"] = 2  # 1 enc + 1 dec
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
            kw["n_image_tokens"] = 16
            kw["vision_dim"] = min(self.vision_dim, 64)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
            kw["n_layers"] = 2
        if self.xlstm_pattern:
            kw["n_layers"] = 2
        if self.clip is not None:
            kw["clip"] = dataclasses.replace(
                self.clip, image_size=32, patch_size=8, vision_layers=2,
                vision_width=128, vision_heads=4, embed_dim=64,
                context_length=16)
        return self.replace(**kw)


_REGISTRY: dict[str, ArchConfig] = {}

_ARCH_MODULES = ["clip_rn50_cc3m", "clip_vitb32_cc12m", "clip_vitb16_laion",
                 "zamba2_1p2b", "qwen3_1p7b", "yi_6b", "granite_3_8b",
                 "qwen1p5_32b", "qwen3_moe_30b_a3b",
                 "llama4_scout_17b_a16e", "llama_3_2_vision_11b",
                 "seamless_m4t_large_v2", "xlstm_125m"]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)
