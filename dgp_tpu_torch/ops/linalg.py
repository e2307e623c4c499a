"""Dense linear-algebra helpers for the GP core (counterpart of
``dgp_tpu/ops/linalg.py``; ``log_det_from_chol`` comes with the exact GPs)."""

from __future__ import annotations

import torch


def eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def tri_solve(L, B, lower=True):
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def cho_solve(L, B):
    """Solve (L L^T) x = B given the lower Cholesky factor L."""
    return torch.cholesky_solve(B, L, upper=False)
