"""Atomic, restartable snapshots of the multi-task manager (a port of
``repro.checkpoint``, same on-disk format)."""
from .store import latest_checkpoint, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]
