"""Checkpoint substrate: atomic manifests and async save."""
from repro_torch.checkpoint.manager import (AsyncCheckpointer,
                                            CheckpointManager, step_dir)

__all__ = ["AsyncCheckpointer", "CheckpointManager", "step_dir"]
