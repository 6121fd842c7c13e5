"""qwen1.5-32b [dense] — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ArchConfig, register

QWEN1P5_32B = register(ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen1.5-0.5B]",
    notes="Qwen1.5: MHA (kv=40) with QKV bias, SwiGLU d_ff=27392.",
))
