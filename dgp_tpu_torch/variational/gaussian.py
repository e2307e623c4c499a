"""Gaussian variational distributions q(u) = N(q_mu, q_sqrt q_sqrt^T)
(counterpart of ``dgp_tpu/variational/gaussian.py``)."""

from __future__ import annotations

import torch

from ..ops.linalg import cho_solve, tri_solve


def gauss_kl(q_mu, q_sqrt, Lu=None):
    """KL[ q(u) || p(u) ] summed over the D output GPs.

    :param q_mu: [M, D]
    :param q_sqrt: [D, M, M] (tril applied internally)
    :param Lu: [M, M] lower Cholesky of the prior covariance Kuu, or None for
        a whitened N(0, I) prior.
    """
    M, D = q_mu.shape
    L = torch.tril(q_sqrt)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)  # [D, M]
    kl = -0.5 * D * M
    kl = kl - 0.5 * torch.sum(torch.log(diag**2))
    if Lu is None:  # whitened
        kl = kl + 0.5 * torch.sum(L**2)
        kl = kl + 0.5 * torch.sum(q_mu**2)
    else:
        kl = kl + D * torch.sum(torch.log(torch.diagonal(Lu)))
        # trace term: || Lu^{-1} q_sqrt ||_F^2 per output
        A = tri_solve(Lu.expand(D, M, M), L, lower=True)
        kl = kl + 0.5 * torch.sum(A**2)
        # Mahalanobis term: q_mu^T Kuu^{-1} q_mu
        kl = kl + 0.5 * torch.sum(q_mu * cho_solve(Lu, q_mu))
    return kl
