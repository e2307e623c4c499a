"""Bijectors for constrained parameters (counterpart of
``dgp_tpu/ops/transforms.py``): positive parameters are stored unconstrained
and mapped through a stable softplus; triangular factors are stored dense and
masked with ``torch.tril`` where they are used."""

from __future__ import annotations

import torch


def softplus(x):
    """log(1 + exp(x)), stable for large |x| (the JAX package's
    ``logaddexp(x, 0)``; ``torch.nn.functional.softplus`` switches to the
    identity above its threshold, which differs in the last bits)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    """Inverse of softplus: log(exp(y) - 1), stable for large y."""
    return y + torch.log(-torch.expm1(-y))


def positive(raw):
    """Unconstrained -> positive."""
    return softplus(raw)


def positive_inverse(value):
    """Positive -> unconstrained (for initialization)."""
    return inv_softplus(value)


def tril(mat):
    """Lower-triangular mask, applied wherever a q_sqrt-like factor is used."""
    return torch.tril(mat)
