from repro_torch.checkpoint.checkpointer import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    snapshot_state,
)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "snapshot_state",
           "CheckpointManager"]
