"""Checkpoints: atomic, checksummed, restorable on another world size."""
from repro_torch.checkpoint.manager import (CheckpointCorruption,
                                            CheckpointManager,
                                            restore_resharded)

__all__ = ["CheckpointManager", "CheckpointCorruption", "restore_resharded"]
