"""Versioned, atomic, async checkpointing (counterpart of
repro/checkpoint)."""
from repro_torch.checkpoint.store import CheckpointManager

__all__ = ["CheckpointManager"]
