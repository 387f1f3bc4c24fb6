"""Atomic, hashed, layout-free checkpoints (+ async saver), in the
reference's on-disk format."""
from .checkpoint import save, restore, latest_step, AsyncCheckpointer
__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]
