"""Likelihoods (counterpart of ``dgp_tpu/ops/likelihoods.py``): the
Gaussian likelihood, whose closed forms broadcast over the sample axis; the
non-conjugate heads (probit ``Bernoulli`` for classification, ``StudentT``
for heavy-tailed regression), whose expectations run by Gauss-Hermite
quadrature over any leading sample axes; and the Gaussian densities with an
explicit variance that the multi-fidelity models' inner fidelities use."""

from __future__ import annotations

import functools
import math
from typing import Union

import numpy as np
import torch
from torch import nn

from ..config import default_float
from .transforms import positive, positive_inverse

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2 pi)


class Gaussian(nn.Module):
    """Gaussian likelihood y = f + eps, eps ~ N(0, variance)."""

    def __init__(self, variance_raw):
        super().__init__()
        self.variance_raw = variance_raw

    @classmethod
    def create(cls, variance=1.0, dtype=None, device=None):
        dtype = dtype or default_float()
        return cls(nn.Parameter(positive_inverse(
            torch.as_tensor(variance, dtype=dtype, device=device))))

    @property
    def variance(self):
        return positive(self.variance_raw)

    def variational_expectations(self, Fmu, Fvar, Y):
        """E_{q(f)=N(Fmu,Fvar)}[log N(Y | f, sigma^2)], closed form."""
        var = self.variance
        return (-_HALF_LOG_2PI - 0.5 * torch.log(var)
                - 0.5 * ((Y - Fmu) ** 2 + Fvar) / var)

    def log_prob(self, F, Y):
        var = self.variance
        return -_HALF_LOG_2PI - 0.5 * torch.log(var) - 0.5 * (Y - F) ** 2 / var

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance

    def predict_density(self, Fmu, Fvar, Y):
        tot = Fvar + self.variance
        return (-_HALF_LOG_2PI - 0.5 * torch.log(tot)
                - 0.5 * (Y - Fmu) ** 2 / tot)


class QuadratureLikelihood(nn.Module):
    """Base of the non-conjugate likelihoods: variational expectations,
    predictive densities and moments by Gauss-Hermite quadrature of
    ``num_gh`` points, over [..., N, D] moments against [N, D] data."""

    def __init__(self, num_gh: int = 20):
        super().__init__()
        self.num_gh = num_gh

    def log_prob(self, F, Y):  # pragma: no cover - abstract
        raise NotImplementedError

    def _nodes(self, Fmu, Fvar):
        """The quadrature points f [..., num_gh] of N(Fmu, Fvar) and their
        weights."""
        x, w = _gauss_hermite(self.num_gh, Fmu.dtype, Fmu.device)
        f = Fmu[..., None] + torch.sqrt(torch.clamp(Fvar, min=0.0))[..., None] * x
        return f, w

    def variational_expectations(self, Fmu, Fvar, Y):
        f, w = self._nodes(Fmu, Fvar)
        return torch.sum(self.log_prob(f, Y[..., None]) * w, dim=-1)

    def predict_density(self, Fmu, Fvar, Y):
        f, w = self._nodes(Fmu, Fvar)
        lp = self.log_prob(f, Y[..., None])
        m = torch.amax(lp, dim=-1, keepdim=True)
        return torch.log(torch.sum(torch.exp(lp - m) * w, dim=-1)) + m[..., 0]

    def predict_mean_and_var(self, Fmu, Fvar):
        f, w = self._nodes(Fmu, Fvar)
        cm = self.conditional_mean(f)
        cv = self.conditional_variance(f)
        mean = torch.sum(cm * w, dim=-1)
        e2 = torch.sum((cv + cm**2) * w, dim=-1)
        return mean, e2 - mean**2


@functools.lru_cache(maxsize=None)
def _gauss_hermite(num_gh, dtype, device):
    """Probabilists' Gauss-Hermite nodes and weights (the weights over
    sqrt(2 pi): they sum to 1), built once per size, dtype and device."""
    x, w = np.polynomial.hermite_e.hermegauss(num_gh)
    w = w / np.sqrt(2 * np.pi)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


class Bernoulli(QuadratureLikelihood):
    """Probit Bernoulli for classification heads (Y in {0, 1})."""

    def _p(self, F):
        # in float32 the upper clip 1 - 1e-9 rounds to 1.0
        return torch.clamp(torch.special.ndtr(F), 1e-9, 1 - 1e-9)

    def log_prob(self, F, Y):
        # log Phi through log_ndtr: the clipped form Y log p + (1-Y)
        # log1p(-p) gives 0 * -inf = NaN in float32 wherever Phi(F) rounds
        # to 1
        return (Y * torch.special.log_ndtr(F)
                + (1 - Y) * torch.special.log_ndtr(-F))

    def conditional_mean(self, F):
        return self._p(F)

    def conditional_variance(self, F):
        p = self._p(F)
        return p * (1 - p)


class StudentT(QuadratureLikelihood):
    """Student-t observation noise for heavy-tailed regression; ``df`` is a
    fixed number, the scale a parameter."""

    def __init__(self, scale_raw, df: float = 3.0, num_gh: int = 20):
        super().__init__(num_gh)
        self.scale_raw = scale_raw
        self.df = float(df)

    @classmethod
    def create(cls, scale=1.0, df=3.0, num_gh=20, dtype=None, device=None):
        dtype = dtype or default_float()
        return cls(nn.Parameter(positive_inverse(
            torch.as_tensor(scale, dtype=dtype, device=device))), df, num_gh)

    @property
    def scale(self):
        return positive(self.scale_raw)

    def log_prob(self, F, Y):
        nu = self.df
        s = self.scale
        z = (Y - F) / s
        return (math.lgamma((nu + 1) / 2.0) - math.lgamma(nu / 2.0)
                - 0.5 * math.log(math.pi * nu) - torch.log(s)
                - (nu + 1) / 2.0 * torch.log1p(z**2 / nu))

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        nu = self.df
        return (self.scale**2 * nu / (nu - 2.0)).expand(F.shape)


Likelihood = Union[Gaussian, QuadratureLikelihood]


def gaussian_logdensity(Y, mu, var):
    """log N(Y | mu, var) with an explicit variance (the inner-fidelity
    likelihood of the multi-fidelity models)."""
    return -_HALF_LOG_2PI - 0.5 * torch.log(var) - 0.5 * (Y - mu) ** 2 / var


def fidelity_variational_expectations(Fmu, Fvar, Y, variance):
    """E_q[log N(Y | f, variance)] with the noise variance given (an inner
    multi-fidelity layer's White-kernel variance)."""
    return (-_HALF_LOG_2PI - 0.5 * torch.log(variance)
            - 0.5 * ((Y - Fmu) ** 2 + Fvar) / variance)
