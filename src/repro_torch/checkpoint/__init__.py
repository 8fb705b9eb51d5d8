from repro_torch.checkpoint.manager import (CheckpointConfig,
                                            CheckpointManager,
                                            default_lossy_policy)
from repro_torch.checkpoint import serialization
from repro_torch.checkpoint.serialization import CheckpointCorruptError

__all__ = ["CheckpointConfig", "CheckpointCorruptError", "CheckpointManager",
           "default_lossy_policy", "serialization"]
