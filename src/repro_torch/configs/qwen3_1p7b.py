"""qwen3-1.7b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_1P7B = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,           # qwen3 fixes head_dim=128 independent of d_model
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B]",
    notes="Qwen3 dense: GQA kv=8, RMS qk-norm per head, SwiGLU MLP.",
))
