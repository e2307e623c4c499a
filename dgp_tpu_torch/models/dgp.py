"""Doubly-stochastic Deep GP (Salimbeni & Deisenroth 2017), counterpart of
``dgp_tpu/models/dgp.py``.

The model is an ``nn.Module`` (``DGPParams``) plus plain functions
(``propagate``/``elbo``/``predict_*``); the ``DGP`` class is a thin stateful
wrapper with the reference's API. Their products run as IEEE fp32
(``config.ieee_fp32``), whatever TF32 setting the process has. This slice
serves: the ELBO is forward only, and training (``optimize_*``) comes with
the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import default_float, ieee_fp32, resolve_device
from ..layers.initializations import init_layers_linear
from ..layers.svgp import layer_kl, sample_from_conditional, stack_projections
from ..ops.likelihoods import Gaussian


class DGPParams(nn.Module):
    def __init__(self, layers, likelihood: Gaussian):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.likelihood = likelihood


def _like(params: DGPParams, X):
    """X as a tensor on the model's device, in the model's dtype."""
    ref = params.layers[0].z
    return torch.as_tensor(X, dtype=ref.dtype, device=ref.device)


# -- plain functions ------------------------------------------------------------


@ieee_fp32()
def propagate(params: DGPParams, X, S: int, generator=None, full_cov=False,
              zs=None):
    """Chain layer-wise reparameterized samples.

    :param generator: ``torch.Generator`` on the model's device, used where
        ``zs`` gives no fixed unit normals for a layer.
    :return: (Fs, Fmeans, Fvars) tuples of per-layer [S, N, D] tensors.
    """
    X = _like(params, X)
    F = X[None].expand(S, *X.shape)
    Fs, Fmeans, Fvars = [], [], []
    zs = zs if zs is not None else [None] * len(params.layers)
    projs = stack_projections(params.layers, [l.z for l in params.layers])
    for layer, z, proj in zip(params.layers, zs, projs):
        F, Fmean, Fvar = sample_from_conditional(
            layer, layer.z, F, generator, full_cov=full_cov, z=z, proj=proj)
        Fs.append(F)
        Fmeans.append(Fmean)
        Fvars.append(Fvar)
    return tuple(Fs), tuple(Fmeans), tuple(Fvars)


def predict_f(params: DGPParams, X, S: int, generator=None, full_cov=False,
              zs=None):
    _, Fmeans, Fvars = propagate(params, X, S, generator, full_cov=full_cov,
                                 zs=zs)
    return Fmeans[-1], Fvars[-1]


@ieee_fp32()
def elbo(params: DGPParams, X, Y, num_samples: int, generator=None, zs=None):
    """Monte-Carlo ELBO over the full data: sum_n E_q[log p(y|f)] - sum KL
    (forward only; the minibatch scaling comes with training)."""
    Y = _like(params, Y)
    Fmean, Fvar = predict_f(params, X, num_samples, generator, zs=zs)
    var_exp = params.likelihood.variational_expectations(Fmean, Fvar, Y)
    L = torch.sum(torch.mean(var_exp, dim=0))
    kl = sum(layer_kl(layer, layer.z) for layer in params.layers)
    return L - kl


def predict_y(params: DGPParams, X, S: int, generator=None, zs=None):
    Fmean, Fvar = predict_f(params, X, S, generator, zs=zs)
    return params.likelihood.predict_mean_and_var(Fmean, Fvar)


def predict_density(params: DGPParams, X, Y, S: int, generator=None, zs=None):
    Y = _like(params, Y)
    Fmean, Fvar = predict_f(params, X, S, generator, zs=zs)
    log_p = params.likelihood.predict_density(Fmean, Fvar, Y)  # [S, N, D]
    return torch.logsumexp(log_p - math.log(S), dim=0)


def moment_matched(y_means, y_vars):
    """Collapse the S-sample mixture to a single Gaussian per point:
    mean = E[m], var = E[v + m^2] - E[m]^2."""
    mean = torch.mean(y_means, dim=0)
    var = torch.mean(y_vars + y_means**2, dim=0) - mean**2
    return mean, var


# -- stateful wrapper -------------------------------------------------------------


class DGP:
    """Reference-parity wrapper.

    :param kernels: list of kernel modules (len(num_units)+1).
    :param num_units: hidden widths, e.g. [1, 1] for the notebook's [1,1,1] arch.
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).
    """

    name = "dgp"

    def __init__(self, X, Y, Z, kernels, num_units,
                 likelihood: Optional[Gaussian] = None, num_outputs=None,
                 mean_function=None, white=False, num_samples=1, seed=0,
                 device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or default_float()
        with ieee_fp32():
            layers = init_layers_linear(
                X, Y, Z, kernels, num_units, num_outputs=num_outputs,
                mean_function=mean_function, white=white, dtype=dtype,
                device=device)
        self._setup(X, Y, layers, likelihood, num_samples, seed, device, dtype)

    @classmethod
    def from_layers(cls, X, Y, layers, likelihood=None, num_samples=1, seed=0,
                    device=None, dtype=None):
        """Build a DGP from a custom layer stack."""
        self = cls.__new__(cls)
        self._setup(X, Y, layers, likelihood, num_samples, seed,
                    resolve_device(device), dtype or default_float())
        return self

    def _setup(self, X, Y, layers, likelihood, num_samples, seed, device,
               dtype):
        likelihood = likelihood or Gaussian.create(1.0, dtype=dtype)
        self.params = DGPParams(layers, likelihood).to(device=device,
                                                       dtype=dtype)
        self.num_samples = num_samples
        self.device, self.dtype = device, dtype
        self.data = (
            torch.as_tensor(np.asarray(X), dtype=dtype, device=device),
            torch.as_tensor(np.asarray(Y), dtype=dtype, device=device),
        )
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def _as_input(self, X):
        return torch.as_tensor(X, dtype=self.dtype, device=self.device)

    # -- reference API ------------------------------------------------------------
    @torch.no_grad()
    def ELBO(self):
        X, Y = self.data
        return elbo(self.params, X, Y, self.num_samples, self.generator)

    @torch.no_grad()
    def propagate(self, X, full_cov=False, S=1, zs=None):
        return propagate(self.params, self._as_input(X), S, self.generator,
                         full_cov, zs)

    @torch.no_grad()
    def predict_f(self, X, full_cov=False, S=1):
        return predict_f(self.params, self._as_input(X), S, self.generator,
                         full_cov)

    @torch.no_grad()
    def predict_y(self, Xnew, num_samples):
        return predict_y(self.params, self._as_input(Xnew), num_samples,
                         self.generator)

    @torch.no_grad()
    def predict_density(self, Xnew, Ynew, num_samples):
        return predict_density(self.params, self._as_input(Xnew),
                               self._as_input(Ynew), num_samples,
                               self.generator)

    def predict(self, Xnew, num_samples):
        y_m, y_v = self.predict_y(Xnew, num_samples)
        mean, var = moment_matched(y_m, y_v)
        return mean.cpu().numpy(), var.cpu().numpy()
