"""Sparse variational GP layers and their initialization."""
