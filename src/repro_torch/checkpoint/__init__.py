"""Log-structured incremental checkpointing with MDC space reclamation: the
store (the serving engine's session snapshots and the trainer's
checkpoints) and the trainer's checkpoint manager."""

from .logstore import BFloat16Bits, ChunkVersion, LogStructuredCheckpointStore
from .manager import CheckpointManager, flatten_tree, unflatten_like

__all__ = ["LogStructuredCheckpointStore", "ChunkVersion", "BFloat16Bits",
           "CheckpointManager", "flatten_tree", "unflatten_like"]
