"""Checkpoints of the port: the JAX package's step-atomic store and its
manager, over trees of tensors."""

from .manager import CheckpointManager
from .store import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]
