from .manager import AsyncCheckpointer, CheckpointManager

__all__ = ["AsyncCheckpointer", "CheckpointManager"]
