"""Variational distributions."""
