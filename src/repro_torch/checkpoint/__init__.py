"""Crash-atomic, corruption-tolerant checkpoints of tensor trees (the
port's counterpart of ``repro/checkpoint``; same on-disk format)."""
from .checkpoint import (CheckpointCorruptError, CheckpointManager,
                         latest_step, load_leaves, restore_pytree,
                         save_pytree)

__all__ = ["save_pytree", "restore_pytree", "CheckpointManager",
           "latest_step", "load_leaves", "CheckpointCorruptError"]
