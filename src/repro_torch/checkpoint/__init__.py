"""Checkpoints of the port, in the reference's on-disk format."""
from .manager import (CheckpointManager, latest_step, restore_checkpoint,
                      save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]
