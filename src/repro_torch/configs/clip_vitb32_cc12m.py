"""Paper large-scale setting: ViT-B/32 vision tower, CC12M (9.1M pairs),
global batch 2048, 8 Tesla T4.  (FastCLIP Table 2, row 2.)"""
from repro_torch.configs.base import ArchConfig, CLIPConfig, register

CLIP_VITB32_CC12M = register(ArchConfig(
    name="clip-vitb32-cc12m",
    family="clip",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=49_408,
    clip=CLIPConfig(vision_arch="vit", image_size=224, patch_size=32,
                    vision_layers=12, vision_width=768, vision_heads=12,
                    embed_dim=512),
    source="[FastCLIP Table 2 / Radford et al. 2021 ViT-B/32]",
))
