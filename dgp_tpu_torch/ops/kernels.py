"""Stationary / linear / noise kernels and kernel algebra (counterpart of
``dgp_tpu/ops/kernels.py``).

Kernels are ``nn.Module``s holding the same raw (softplus-unconstrained)
hyperparameters as the JAX pytrees (``variance_raw``, ``lengthscales_raw``);
``active_dims`` is a plain attribute. ``Sum``/``Product`` compose through
``+``/``*``. Pairwise distances are written product-first, as in the JAX
package: ``||x||^2 + ||z||^2 - 2 x.z``.

The stationary kernels (and sums and products of them) also take a stack of
hyperparameters: a variance of shape [B] (and lengthscales [B, d] or [B])
gives K [B, n, m] and K_diag [B, n], one matrix per entry of the stack, as
``jax.vmap`` over a stacked pytree gives them (the exact multi-fidelity
models' multi-start training). X may carry leading batch dimensions too.
With unstacked hyperparameters and 2-D inputs every value is the one the
2-D formulas give, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import default_float
from .transforms import positive, positive_inverse


def _as_param(value, dtype=None, device=None):
    dtype = dtype or default_float()
    return nn.Parameter(positive_inverse(
        torch.as_tensor(value, dtype=dtype, device=device)))


def _dims(active_dims):
    return tuple(active_dims) if active_dims is not None else None


class Kernel(nn.Module):
    """Base: active-dims slicing, algebra operators, public K / K_diag."""

    active_dims: Optional[tuple] = None

    def _slice(self, X):
        if self.active_dims is None:
            return X
        return X[..., list(self.active_dims)]

    def K(self, X, X2=None):
        """Covariance matrix [n, m] (X2=None means X2=X, including noise terms)."""
        raise NotImplementedError

    def K_diag(self, X):
        """Diagonal of K(X, X), shape [n]."""
        raise NotImplementedError

    def __add__(self, other):
        return Sum((self, other))

    def __mul__(self, other):
        return Product((self, other))


class _Stationary(Kernel):
    """Shared machinery for kernels of the scaled Euclidean distance."""

    def __init__(self, variance_raw, lengthscales_raw, active_dims=None):
        super().__init__()
        self.variance_raw = variance_raw
        self.lengthscales_raw = lengthscales_raw
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, active_dims=None,
               dtype=None, device=None):
        return cls(_as_param(variance, dtype, device),
                   _as_param(lengthscales, dtype, device), active_dims)

    @property
    def variance(self):
        return positive(self.variance_raw)

    @property
    def lengthscales(self):
        return positive(self.lengthscales_raw)

    def _matrix_variance(self):
        """The variance broadcast against [..., n, m] matrices."""
        return self.variance[..., None, None]

    def _scaled(self, X):
        # the variance's shape is the stack's: lengthscales with one more
        # dimension are ARD ([..., d]), else one per kernel ([...])
        ls = self.lengthscales
        ls = (ls[..., None, :] if ls.dim() > self.variance_raw.dim()
              else ls[..., None, None])
        return self._slice(X) / ls

    def _sqdist(self, X, X2):
        Xs = self._scaled(X)
        X2s = Xs if X2 is None else self._scaled(X2)
        xx = torch.sum(Xs * Xs, dim=-1)[..., :, None]
        zz = torch.sum(X2s * X2s, dim=-1)[..., None, :]
        return torch.clamp_min(xx + zz - 2.0 * (Xs @ X2s.mT), 0.0)

    def K_diag(self, X):
        variance = self.variance
        # numpy's rule: torch.broadcast_shapes imports sympy on first use
        shape = np.broadcast_shapes(variance.shape, X.shape[:-2])
        return variance[..., None].expand(*shape, X.shape[-2]).to(X.dtype)


class RBF(_Stationary):
    """Squared-exponential (gpflow ``SquaredExponential``/``RBF``)."""

    def K(self, X, X2=None):
        return self._matrix_variance() * torch.exp(-0.5 * self._sqdist(X, X2))


def _safe_dist(sqdist):
    # sqrt with a finite gradient at 0, as dgp_tpu/ops/kernels.py:112-116
    return torch.sqrt(sqdist + 1e-36)


class Matern32(_Stationary):
    def K(self, X, X2=None):
        r = _safe_dist(self._sqdist(X, X2))
        sqrt3 = math.sqrt(3.0)
        return (self._matrix_variance() * (1.0 + sqrt3 * r)
                * torch.exp(-sqrt3 * r))


class Matern52(_Stationary):
    def K(self, X, X2=None):
        r2 = self._sqdist(X, X2)
        r = _safe_dist(r2)
        sqrt5 = math.sqrt(5.0)
        return (self._matrix_variance() * (1.0 + sqrt5 * r + (5.0 / 3.0) * r2)
                * torch.exp(-sqrt5 * r))


class _VarianceOnly(Kernel):
    def __init__(self, variance_raw, active_dims=None):
        super().__init__()
        self.variance_raw = variance_raw
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, variance=1.0, active_dims=None, dtype=None, device=None):
        return cls(_as_param(variance, dtype, device), active_dims)

    @property
    def variance(self):
        return positive(self.variance_raw)


class Linear(_VarianceOnly):
    """Dot-product kernel: K = variance * X X2^T (gpflow ``Linear``)."""

    def K(self, X, X2=None):
        Xs = self._slice(X)
        X2s = Xs if X2 is None else self._slice(X2)
        return (Xs * self.variance) @ X2s.T

    def K_diag(self, X):
        Xs = self._slice(X)
        return torch.sum(Xs * self.variance * Xs, dim=-1)


class White(_VarianceOnly):
    """IID-noise kernel: variance on the diagonal of K(X, X), zero cross-cov."""

    def K(self, X, X2=None):
        n = X.shape[0]
        if X2 is None:
            return self.variance * torch.eye(n, dtype=X.dtype, device=X.device)
        return torch.zeros((n, X2.shape[0]), dtype=X.dtype, device=X.device)

    def K_diag(self, X):
        return self.variance.expand(X.shape[0]).to(X.dtype)


class _Combination(Kernel):
    def __init__(self, kernels: Sequence[Kernel]):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)


class Sum(_Combination):
    def K(self, X, X2=None):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out + k.K(X, X2)
        return out

    def K_diag(self, X):
        out = self.kernels[0].K_diag(X)
        for k in self.kernels[1:]:
            out = out + k.K_diag(X)
        return out


class Product(_Combination):
    def K(self, X, X2=None):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out * k.K(X, X2)
        return out

    def K_diag(self, X):
        out = self.kernels[0].K_diag(X)
        for k in self.kernels[1:]:
            out = out * k.K_diag(X)
        return out


_BY_NAME = {"rbf": RBF, "matern32": Matern32, "matern52": Matern52}


def by_name(name: str, num_dims: int, dtype=None, device=None) -> Kernel:
    """Spec-dict kernel factory (the SO_BO kernel strings)."""
    try:
        cls = _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"Unknown kernel {name!r}: expected one of {sorted(_BY_NAME)}"
        ) from None
    return cls.create(variance=1.0, lengthscales=[1.0] * num_dims,
                      dtype=dtype, device=device)
