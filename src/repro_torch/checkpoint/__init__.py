from .ckpt import (CheckpointManager, all_steps, latest_step,
                   restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "all_steps"]
