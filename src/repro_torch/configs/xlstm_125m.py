"""xlstm-125m [ssm]: mLSTM and sLSTM blocks.  [arXiv:2405.04517]

The mLSTM's head width is ``expand * d_model // n_heads`` (384) and the
sLSTM's ``d_model // n_heads`` (192); ``ssm.head_dim`` is read by
neither (``models.xlstm``), as in the JAX package."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

XLSTM_125M = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                       # the blocks carry their own projections
    vocab_size=50_304,
    # xLSTM[7:1]-style pattern cycled over the 12 layers: mostly mLSTM with
    # interspersed sLSTM blocks (arXiv:2405.04517 Table 9)
    xlstm_pattern="mmmsmmmsmmms",
    ssm=SSMConfig(state_size=0, head_dim=192, expand=2, chunk=64),
    source="[arXiv:2405.04517]",
    notes="mLSTM = matrix-memory linear attention (chunkwise); sLSTM = "
          "sequential scalar-memory recurrence with exponential gating.",
))
