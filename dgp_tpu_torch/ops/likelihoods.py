"""Likelihoods (counterpart of ``dgp_tpu/ops/likelihoods.py``): the
Gaussian likelihood, whose closed forms broadcast over the sample axis."""

from __future__ import annotations

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
