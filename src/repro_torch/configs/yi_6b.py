"""yi-6b [dense] — llama-arch GQA.  [arXiv:2403.04652]"""
from repro_torch.configs.base import ArchConfig, register

YI_6B = register(ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    source="[arXiv:2403.04652]",
    notes="Yi-6B: llama architecture with GQA kv=4, SwiGLU, RMSNorm.",
))
