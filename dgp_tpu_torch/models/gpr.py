"""Exact GP regression (counterpart of ``dgp_tpu/models/gpr.py``): the
``num_layers=0`` surrogate of the BO drivers.

The parameters are an ``nn.Module`` (``GPRParams``: the kernel and the
Gaussian likelihood under the JAX pytree's names); the math lives in plain
functions; ``GPR`` is the stateful wrapper the BO drivers use. The Gram
matrix's Cholesky factor comes from kernel #7 (``ops/cholesky.py``) for
float32 tensors on the card; a Gram that is not positive definite gives NaN,
never an exception. Products run as IEEE fp32 (``config.ieee_fp32``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import default_float, default_jitter, ieee_fp32, resolve_device
from ..ops.cholesky import cholesky
from ..ops.likelihoods import Gaussian
from ..ops.linalg import eye_like, log_det_from_chol, tri_solve
from . import training

_HALF_LOG_2PI = 0.9189385332046727


class GPRParams(nn.Module):
    def __init__(self, kernel, likelihood: Gaussian):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood


def _masked_gram(params: GPRParams, X, row_weights):
    """Noise-augmented Gram matrix; with 0/1 ``row_weights`` the weight-0
    (padding) rows are exactly decoupled: their cross-covariances are zeroed
    and their diagonal set to 1, so K is block-diagonal and the padded block
    adds only a parameter-independent constant to the log marginal
    likelihood and nothing to the posterior. Parameters stacked over a
    leading axis (``training.multistart_adam``) give a [B, n, n] stack."""
    K = params.kernel.K(X)
    noise = torch.as_tensor(params.likelihood.variance + default_jitter(X.dtype),
                            dtype=K.dtype, device=K.device)
    if row_weights is None:
        return K + noise[..., None, None] * eye_like(K)
    w = row_weights
    return (w[:, None] * w[None, :] * K
            + torch.diag_embed(w * noise[..., None] + (1.0 - w)))


@ieee_fp32()
def neg_log_marginal_likelihood(params: GPRParams, X, Y, row_weights=None):
    """The negative log marginal likelihood; [B] for parameters stacked
    over a leading axis (their Grams factored in one call of #7)."""
    n, d = X.shape[0], Y.shape[1]
    L = cholesky(_masked_gram(params, X, row_weights))
    alpha = tri_solve(L, Y, lower=True)
    return (0.5 * torch.sum(alpha ** 2, dim=(-2, -1))
            + 0.5 * d * log_det_from_chol(L) + _HALF_LOG_2PI * n * d)


@ieee_fp32()
def predict_f(params: GPRParams, data, Xnew):
    """Exact GP posterior at Xnew: mean [m, D], var [m, D] (pure).

    ``data`` is (X, Y) or the padded (X, Y, row_weights) triple."""
    X, Y = data[0], data[1]
    w = data[2] if len(data) > 2 else None
    L = cholesky(_masked_gram(params, X, w))
    Ks = params.kernel.K(X, Xnew)
    if w is not None:
        Ks = w[:, None] * Ks
    A = tri_solve(L, Ks, lower=True)
    beta = tri_solve(L, Y, lower=True)
    mean = A.T @ beta
    var = params.kernel.K_diag(Xnew) - torch.sum(A ** 2, dim=0)
    return mean, var[:, None].expand(-1, Y.shape[1])


def predict_y(params: GPRParams, data, Xnew):
    mean, var = predict_f(params, data, Xnew)
    return params.likelihood.predict_mean_and_var(mean, var)


def nmll_loss(params, generator, batch):
    """The training loops' loss form (``generator`` is unused: the
    marginal likelihood draws nothing)."""
    return neg_log_marginal_likelihood(params, *batch)


class GPR:
    """Stateful wrapper with the surface the BO drivers use: ``name``,
    ``data``, ``predict_y``, ``predict_f``, Adam training.

    :param n_bucket: pad the training rows to multiples of this (exactly
        decoupled padding, ``_masked_gram``), so a growing BO archive keeps
        its sizes stable.
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``)."""

    name = "gpr"

    def __init__(self, data, kernel, noise_variance=1e-5, n_bucket=None,
                 device=None, dtype=None):
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        X, Y = data
        self.n_bucket = n_bucket
        self.data = tuple(torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                          device=self.device) for a in (X, Y))
        self.params = GPRParams(
            kernel, Gaussian.create(noise_variance, dtype=self.dtype)
        ).to(device=self.device, dtype=self.dtype)

    @property
    def train_data(self):
        """(X, Y, row_weights) with rows padded to the bucket (w None when
        unbucketed). Predictions through this triple equal predictions
        through ``data`` exactly."""
        X, Y = self.data
        if self.n_bucket:
            return training.pad_to_bucket(X, Y, self.n_bucket)
        return (X, Y, None)

    def training_loss(self):
        return neg_log_marginal_likelihood(self.params, *self.train_data)

    def optimize_adam(self, iterations=3000, lr=0.001, beta_1=0.9,
                      beta_2=0.999, epsilon=1e-7):
        """Adam (eps 1e-7, as the JAX package's optax run) on every
        parameter; returns the losses [iterations], with a RuntimeWarning
        after the phase if any is not finite."""
        _, losses = training.adam_run(
            nmll_loss, self.params, training.make_mask(self.params), None,
            steps=iterations, lr=lr, b1=beta_1, b2=beta_2, eps=epsilon,
            label="nmll", data=self.train_data)
        return losses

    def _as_input(self, X):
        return torch.as_tensor(X, dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def predict_f(self, Xnew):
        return predict_f(self.params, self.train_data, self._as_input(Xnew))

    @torch.no_grad()
    def predict_y(self, Xnew):
        return predict_y(self.params, self.train_data, self._as_input(Xnew))

    def predict_y_sharded(self, Xnew, mesh, chunk_size=None):
        """Data-parallel batch inference: every rank passes the same
        ``Xnew``; the rows split over the mesh's data axis, each rank
        factors the replicated Gram (#7) and solves for its own rows, and
        every rank returns the full ``(mean, var)`` [m, D]
        (``parallel.serving.sharded_gpr_predict_y``). Exact: the result is
        ``predict_y``'s but for reduction-order rounding."""
        from ..parallel import serving

        if mesh is None:
            raise ValueError("predict_y_sharded needs a mesh")
        return serving.run_sharded(
            serving.sharded_gpr_predict_y(mesh),
            (self.params, self.train_data), self._as_input(Xnew), None, mesh,
            chunk_size, row_axis=0)
