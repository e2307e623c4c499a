"""Utilities: checkpointing and monitoring (``profiling`` is imported on
its own)."""

from . import checkpoint, monitor  # noqa: F401
