"""Log-structured snapshot store with MDC space reclamation (the serving
engine's session snapshots)."""

from .logstore import ChunkVersion, LogStructuredCheckpointStore

__all__ = ["LogStructuredCheckpointStore", "ChunkVersion"]
