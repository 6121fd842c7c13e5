"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Text backbone only (the early-fusion vision frontend is not part of the
model here).  Per the model card: 16 routed experts, top-1 routing, plus
a shared expert; MoE every other layer (interleave=2), dense layers use
d_ff=8192 too.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

LLAMA4_SCOUT = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, every=2,
                  shared_expert=True),
    source="[hf:meta-llama/Llama-4-Scout-17B-16E]",
    notes="MoE 16e top-1 + shared expert, interleaved every other layer.",
))
