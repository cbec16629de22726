"""Crash-consistent checkpoints (counterpart of ``repro.checkpoint``)."""

from .ckpt import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "CheckpointManager",
]
