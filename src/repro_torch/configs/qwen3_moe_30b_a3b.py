"""qwen3-moe-30b-a3b [moe] — 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

QWEN3_MOE_30B_A3B = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,                 # per model card (not d_model/n_heads)
    d_ff=768,                     # moe expert hidden size (a3b active)
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, every=1),
    source="[hf:Qwen/Qwen3-30B-A3B]",
    notes="All layers MoE: 128 experts, top-8, per-expert d_ff=768, no "
          "shared expert; qk-norm GQA kv=4.",
))
