"""Utilities: checkpointing."""
