from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    available_steps, flatten, latest_step, read_metadata, restore,
    restore_subtree, save, save_sharded, unflatten, verify_step,
)
