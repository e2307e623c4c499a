"""Exact AR(1) co-kriging (Kennedy & O'Hagan 2000) over L fidelities
(counterpart of ``dgp_tpu/models/cokriging.py``).

Model (recursive autoregressive):

    f_0(x) = delta_0(x)
    f_t(x) = rho_{t-1} * f_{t-1}(x) + delta_t(x),   t = 1..L-1

with independent GP priors delta_t ~ GP(0, k_t), so the joint covariance is
closed-form:

    cov(f_t(x), f_s(x')) = sum_{k<=min(t,s)} a_{t,k} a_{s,k} k_k(x, x'),
    a_{t,k} = prod_{j=k}^{t-1} rho_j   (a_{t,t} = 1).

Training maximizes the exact log marginal likelihood over one joint Gram
across all fidelity blocks by multi-start Adam (``training.multistart_adam``:
every start in one batched step, their Grams factored by one launch of
kernel #7). Per-fidelity archives are bucket-padded with the exactly
decoupled masked Gram of :mod:`models.gpr`.

The parameters are an ``nn.Module`` (``AR1Params``, the JAX pytree's leaf
names); the math lives in plain functions, which also take parameters
stacked over a leading starts axis (the Gram and NLL then carry it);
``AR1CoKriging`` is the stateful wrapper the BO drivers use. Products run
as IEEE fp32 (``config.ieee_fp32``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import default_float, default_jitter, ieee_fp32, resolve_device
from ..ops import kernels as kernels_lib
from ..ops.cholesky import cholesky
from ..ops.likelihoods import Gaussian
from ..ops.linalg import log_det_from_chol, tri_solve
from . import training

_HALF_LOG_2PI = 0.9189385332046727


class AR1Params(nn.Module):
    """kernels[t] is delta_t's kernel; rho [L-1] is unconstrained (negative
    cross-fidelity correlation is legitimate); likelihoods[t] is the
    per-level Gaussian observation noise."""

    def __init__(self, kernels, rho, likelihoods):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self.rho = rho
        self.likelihoods = nn.ModuleList(likelihoods)


def _coeffs(rho, n_fid):
    """a[t][k] = prod_{j=k}^{t-1} rho_j for k <= t (a[t][t] = 1); each of
    the stack's shape (rho [..., L-1])."""
    one = torch.ones_like(rho[..., 0])
    a = [[None] * n_fid for _ in range(n_fid)]
    for t in range(n_fid):
        a[t][t] = one
        for k in range(t - 1, -1, -1):
            a[t][k] = a[t][k + 1] * rho[..., k]
    return a


def _block(params: AR1Params, a, t, s, Xt, Xs):
    """cov(f_t(Xt), f_s(Xs)) [..., nt, ns]."""
    out = 0.0
    for k in range(min(t, s) + 1):
        c = a[t][k] * a[s][k]
        out = out + c[..., None, None] * params.kernels[k].K(Xt, Xs)
    return out


def _joint_gram(params: AR1Params, Xs, ws):
    """Noise-augmented joint Gram over all fidelity blocks with the exactly
    decoupled masked padding of ``gpr._masked_gram``: weight-0 rows get zero
    cross-covariance and a unit diagonal, so they add only a
    parameter-independent constant to the log marginal likelihood and
    nothing to the posterior."""
    n_fid = len(Xs)
    a = _coeffs(params.rho, n_fid)
    K = torch.cat([
        torch.cat([_block(params, a, t, s, Xs[t], Xs[s])
                   for s in range(n_fid)], dim=-1)
        for t in range(n_fid)], dim=-2)
    w = torch.cat(ws)
    jitter = default_jitter(Xs[0].dtype)
    noise = torch.cat([
        (params.likelihoods[t].variance + jitter)[..., None].expand(
            *params.rho.shape[:-1], Xs[t].shape[0])
        for t in range(n_fid)], dim=-1)
    return (w[:, None] * w[None, :] * K
            + torch.diag_embed(w * noise + (1.0 - w)))


@ieee_fp32()
def neg_log_marginal_likelihood(params: AR1Params, Xs, Ys, ws):
    """Joint NLL over all fidelity blocks (padded rows add a constant); [B]
    for parameters stacked over a leading axis."""
    y = torch.cat(Ys, dim=0)
    L = cholesky(_joint_gram(params, Xs, ws))
    alpha = tri_solve(L, y, lower=True)
    return (0.5 * torch.sum(alpha ** 2, dim=(-2, -1))
            + 0.5 * log_det_from_chol(L) + _HALF_LOG_2PI * y.shape[0])


@ieee_fp32()
def predict_f(params: AR1Params, data, Xnew, fidelity=-1):
    """Exact latent posterior of f_{fidelity} at Xnew: (mean [m, 1],
    var [m, 1]). ``data`` = (Xs, Ys, ws) per-fidelity tuples."""
    Xs, Ys, ws = data
    n_fid = len(Xs)
    t = fidelity % n_fid
    a = _coeffs(params.rho, n_fid)
    y = torch.cat(Ys, dim=0)
    w = torch.cat(ws)
    L = cholesky(_joint_gram(params, Xs, ws))
    Ks = torch.cat([_block(params, a, t, s, Xnew, Xs[s])
                    for s in range(n_fid)], dim=-1) * w[None, :]
    kss = 0.0
    for k in range(t + 1):
        kss = kss + a[t][k] ** 2 * params.kernels[k].K_diag(Xnew)
    A = tri_solve(L, Ks.T, lower=True)
    beta = tri_solve(L, y, lower=True)
    mean = A.T @ beta
    var = torch.clamp_min(kss - torch.sum(A ** 2, dim=0), 0.0)
    return mean, var[:, None]


def predict_y(params: AR1Params, data, Xnew, fidelity=-1):
    mean, var = predict_f(params, data, Xnew, fidelity)
    n_fid = len(data[0])
    return params.likelihoods[fidelity % n_fid].predict_mean_and_var(mean, var)


def _pad_level(X, Y, bucket):
    """(X, Y, w) padded to the bucket (training.pad_to_bucket: X by copies
    of row 0, Y by zeros); w the 0/1 row weights, all ones without a
    bucket."""
    if bucket:
        return training.pad_to_bucket(X, Y, bucket)
    return X, Y, torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)


_KERNELS = {"rbf": kernels_lib.RBF, "matern32": kernels_lib.Matern32,
            "matern52": kernels_lib.Matern52}


def _tensors(data, dtype, device):
    Xs, Ys = data
    if len(Xs) < 2 or len(Xs) != len(Ys):
        raise ValueError("need >= 2 fidelities, one Y block per X block")
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return (tuple(as_t(x) for x in Xs),
            tuple(as_t(y).reshape(-1, 1) for y in Ys))


class AR1CoKriging:
    """Stateful wrapper with the surrogate surface MF_BO and the acquisition
    engines rely on: ``name``, ``params``, ``train_data``,
    ``predict_f(Xnew, S=, fidelity=)``.

    :param data: (Xs, Ys) per-fidelity lists, low -> high.
    :param n_bucket: pad each fidelity block to row multiples of this
        (exactly decoupled padding).
    :param kernel: 'rbf' | 'matern32' | 'matern52' for every delta level.
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).

    ``predict_f`` returns exact moments with a leading singleton sample
    axis ([1, m, 1]), the MC surrogates' (S samples, moment matched)
    contract.
    """

    name = "ar1"

    def __init__(self, data, n_bucket: Optional[int] = None,
                 kernel: str = "rbf", noise_variance: float = 1e-4,
                 device=None, dtype=None):
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        self.data = _tensors(data, self.dtype, self.device)
        self.n_fid = len(self.data[0])
        self.n_bucket = n_bucket
        d = int(self.data[0][0].shape[1])
        kcls = _KERNELS[kernel]
        f = dict(dtype=self.dtype, device=self.device)
        self.params = AR1Params(
            [kcls.create(variance=1.0, lengthscales=[0.5] * d, **f)
             for _ in range(self.n_fid)],
            nn.Parameter(torch.ones((self.n_fid - 1,), **f)),
            [Gaussian.create(noise_variance, **f) for _ in range(self.n_fid)])

    @property
    def train_data(self):
        """(Xs, Ys, ws) per-fidelity tuples, rows padded to the bucket."""
        padded = [_pad_level(x, y, self.n_bucket) for x, y in zip(*self.data)]
        return tuple(tuple(p[i] for p in padded) for i in range(3))

    def training_loss(self):
        return neg_log_marginal_likelihood(self.params, *self.train_data)

    def _starts(self, n_starts, seed):
        """The starts stacked over a leading axis (training.stack_starts):
        start 0 the canonical init; later starts add 0.7 N(0, 1) to every
        unconstrained leaf and draw rho from {1, 2, 0.5, -1} + 0.3 N(0, 1)
        (the tiny-n joint NLL is multimodal, and the informative |rho|-large
        basins are the ones a single canonical start misses). The draws
        come from a generator seeded by ``seed``."""
        stacked = training.stack_starts([self.params] * n_starts)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        f = dict(dtype=self.dtype, device=self.device, generator=gen)
        rhos = torch.tensor([1.0, 2.0, 0.5, -1.0], dtype=self.dtype,
                            device=self.device)
        with torch.no_grad():
            for r in range(1, n_starts):
                for p in stacked.parameters():
                    p[r] += 0.7 * torch.randn(p.shape[1:], **f)
                pick = torch.randint(0, 4, (self.n_fid - 1,),
                                     device=self.device, generator=gen)
                stacked.rho[r] = rhos[pick] + 0.3 * torch.randn(
                    (self.n_fid - 1,), **f)
        return stacked

    def optimize(self, n_starts: int = 8, iterations: int = 1500,
                 lr: float = 0.05, seed: int = 0):
        """Multi-start Adam on the joint NLL; keeps the best finite
        candidate. Returns the winning start's loss trace [iterations]."""
        stacked = self._starts(int(n_starts), seed)
        self.params, best_nll, losses = training.multistart_adam(
            neg_log_marginal_likelihood, stacked, self.train_data,
            int(iterations), float(lr))
        self._nll = float(best_nll)
        return losses

    def _as_input(self, X):
        return torch.as_tensor(np.asarray(X), dtype=self.dtype,
                               device=self.device)

    def _fidelity(self, fidelity):
        return self.n_fid - 1 if fidelity is None else int(fidelity)

    @torch.no_grad()
    def predict_f(self, Xnew, S: int = 1, fidelity: Optional[int] = None):
        """Exact moments [1, m, 1] (see the class docstring); fidelity=None
        means the highest."""
        mean, var = predict_f(self.params, self.train_data,
                              self._as_input(Xnew), self._fidelity(fidelity))
        return mean[None], var[None]

    @torch.no_grad()
    def predict_y(self, Xnew, num_samples: int = 1,
                  fidelity: Optional[int] = None):
        mean, var = predict_y(self.params, self.train_data,
                              self._as_input(Xnew), self._fidelity(fidelity))
        return mean[None], var[None]
