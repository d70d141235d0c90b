"""Fault-tolerant checkpoint manager (counterpart of ``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
