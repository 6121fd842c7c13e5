from repro_torch.optim.base import (  # noqa: F401
    Optimizer, clip_by_global_norm, global_norm, tree_zeros_like,
)
from repro_torch.optim.optimizers import (  # noqa: F401
    OPTIMIZERS, adamw, get_optimizer, lamb, lion, sgdm,
)
