"""Paper xlarge-scale setting: ViT-B/16 vision tower, LAION315M,
global batch 5120, 8 H100.  (FastCLIP Table 2, row 3.)"""
from repro_torch.configs.base import ArchConfig, CLIPConfig, register

CLIP_VITB16_LAION = register(ArchConfig(
    name="clip-vitb16-laion",
    family="clip",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=49_408,
    clip=CLIPConfig(vision_arch="vit", image_size=224, patch_size=16,
                    vision_layers=12, vision_width=768, vision_heads=12,
                    embed_dim=512),
    source="[FastCLIP Table 2 / Radford et al. 2021 ViT-B/16]",
))
