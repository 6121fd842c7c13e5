"""granite-3-8b [dense] — GQA.  [hf:ibm-granite/granite-3.0-2b-base family]"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_3_8B = register(ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,            # padded to 49408 for model-axis sharding
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-2b-base]",
    notes="Granite-3 dense: GQA kv=8, SwiGLU; vocab 49155 is not divisible "
          "by the model axis -> padded_vocab=49408 (Megatron-style).",
))
