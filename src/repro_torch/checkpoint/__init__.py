from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer, available_steps, flatten, latest_step,
    prune_checkpoints, read_metadata, restore, restore_subtree, save,
    save_sharded, set_fault_hook, unflatten, verify_step,
)
