from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    available_steps, flatten, latest_step, restore, restore_subtree, save,
    unflatten, verify_step,
)
