"""llama-3.2-vision-11b [vlm] — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

Backbone carve-out: the language decoder only.  The ViT vision encoder
is a stub: the batch carries precomputed patch embeddings (batch,
n_image_tokens, vision_dim); a learned linear projector to d_model is
part of the backbone.  Cross-attention layers every 5th layer (8 of 40,
per the model card).
"""
from repro_torch.configs.base import ArchConfig, register

LLAMA_3_2_VISION_11B = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_image_tokens=1024,         # stub patch tokens (model card: 1601/tile)
    vision_dim=1280,             # ViT-H width, projected to d_model
    source="[hf:meta-llama/Llama-3.2-11B-Vision]",
))
