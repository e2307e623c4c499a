"""Batched inference."""
