"""Dense linear-algebra helpers for the GP core (counterpart of
``dgp_tpu/ops/linalg.py``). The Cholesky factors themselves come from
``ops/cholesky.py``."""

from __future__ import annotations

import torch

from ..config import default_jitter
from .cholesky import cholesky


def eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def add_jitter(K, jitter=None):
    """K + jitter I (``config.default_jitter`` of K's dtype by default)."""
    jitter = default_jitter(K.dtype) if jitter is None else jitter
    return K + jitter * eye_like(K)


def safe_cholesky(K, jitter=None):
    """Cholesky of K + jitter I, batched over leading dims: kernel #7 where
    its gate holds (``ops/cholesky.cholesky``). A matrix that is not
    positive definite gives NaN, never an exception."""
    return cholesky(add_jitter(K, jitter))


def tri_solve(L, B, lower=True):
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def cho_solve(L, B):
    """Solve (L L^T) x = B given the lower Cholesky factor L."""
    return torch.cholesky_solve(B, L, upper=False)


def log_det_from_chol(L):
    """log det(A) where A = L L^T."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
