"""zamba2-1.2b [hybrid]: Mamba2 layers plus one shared attention block.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

ZAMBA2_1P2B = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    hybrid_attn_every=6,          # one *shared* attention+MLP block, applied
                                  # every 6 mamba layers (weights shared)
    ssm=SSMConfig(state_size=64, head_dim=64, expand=2, chunk=256),
    source="[arXiv:2411.15242]",
    notes="38 Mamba2 layers; a single shared transformer block (MHA kv=32 + "
          "MLP d_ff=8192) is invoked every 6 layers with tied weights, per "
          "the Zamba2 design.",
))
