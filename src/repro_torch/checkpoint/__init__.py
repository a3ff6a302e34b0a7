"""Atomic, resumable checkpoints. Counterpart of ``repro.checkpoint``."""
from __future__ import annotations

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
