"""Paper medium-scale setting: ResNet50 vision tower, CC3M (2.7M pairs),
global batch 1024, 8 Tesla T4.  (FastCLIP Table 2, row 1.)"""
from repro_torch.configs.base import ArchConfig, CLIPConfig, register

CLIP_RN50_CC3M = register(ArchConfig(
    name="clip-rn50-cc3m",
    family="clip",
    n_layers=12,                  # text tower: 12-layer transformer
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=49_408,            # CLIP BPE vocab
    clip=CLIPConfig(vision_arch="resnet", image_size=224,
                    vision_layers=50, vision_width=64, embed_dim=1024),
    source="[FastCLIP Table 2 / Radford et al. 2021 RN50]",
))
