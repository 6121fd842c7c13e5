"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal.  [arXiv:2308.11596]

Backbone carve-out: the transformer only.  The conformer speech frontend
(mel-spectrogram and conv subsampling) is a stub: the batch carries
precomputed frame embeddings of shape (batch, seq // subsample,
d_model).  The assigned 24 layers are split 12 encoder + 12 decoder.
"""
from repro_torch.configs.base import ArchConfig, register

SEAMLESS_M4T_LARGE_V2 = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=12,                 # decoder layers
    enc_layers=12,               # encoder layers (24 in all)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    audio_subsample=4,
    source="[arXiv:2308.11596]",
    notes="Encoder consumes stub frame embeddings; decoder is a standard "
          "transformer decoder with cross-attention to encoder output.",
))
