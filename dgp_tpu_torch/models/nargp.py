"""Nonlinear autoregressive multi-fidelity GP (NARGP, Perdikaris et al.
2017), counterpart of ``dgp_tpu/models/nargp.py``:

    f_0(x) = g_0(x),
    f_t(x) = g_t(x, f_{t-1}(x)),   g_t ~ GP(0, k_t),    t = 1..L-1,

with the composite covariance over the augmented input (x, f):

    k_t((x, f), (x', f')) = k_rho(x, x') * k_f(f, f') + k_delta(x, x').

Level t trains on the previous levels' posterior mean at its own inputs
(the nested design), so training is L exact GPR marginal-likelihood
problems, each by multi-start Adam (``training.multistart_adam``: every
start in one batched step, one launch of kernel #7), on bucket-padded rows
(the exactly decoupled masked Gram of :mod:`models.gpr`).

Prediction propagates uncertainty by Monte Carlo: sample f_{t-1}(x*) from
the previous level's posterior, then level t's exact posterior at each
(x*, sample), giving per-sample moments [S, m, 1]. The JAX package vmaps
``gpr.predict_f`` over the S samples, factoring level t's Gram once per
sample; the Gram does not depend on the sample, so here it is factored
once and all S * m augmented points go through one batched solve (the same
posterior).

Random numbers: each function takes a ``torch.Generator`` and, in its
place, an optional ``noise``: an iterable of fixed unit normals consumed in
the order the JAX functions draw theirs (level 1's sample first, then one
for each later level below the one asked for).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import default_float, ieee_fp32, resolve_device
from ..ops import kernels as kernels_lib
from ..ops.likelihoods import Gaussian
from . import gpr as gpr_mod
from . import training
from .cokriging import _KERNELS, _tensors
from .gpr import GPRParams
from .mf_dgp import _draw, _source


def _level_params(level: int, d: int, kernel: str, noise_variance: float,
                  dtype, device) -> GPRParams:
    """Untrained params for one level: level 0 is a plain kernel on the d
    inputs; level t >= 1 is the composite k_rho(x) * k_f(f) + k_delta(x)
    over the augmented [x, f] input."""
    kcls = _KERNELS[kernel]
    f = dict(dtype=dtype, device=device)
    xdims = tuple(range(d))
    if level == 0:
        kern = kcls.create(variance=1.0, lengthscales=[0.5] * d, **f)
    else:
        k_rho = kcls.create(variance=1.0, lengthscales=[0.5] * d,
                            active_dims=xdims, **f)
        k_f = kcls.create(variance=1.0, lengthscales=[0.5],
                          active_dims=(d,), **f)
        k_delta = kcls.create(variance=0.1, lengthscales=[0.5] * d,
                              active_dims=xdims, **f)
        kern = kernels_lib.Sum(
            (kernels_lib.Product((k_rho, k_f)), k_delta))
    return GPRParams(kern, Gaussian.create(noise_variance, **f))


# -- pure prediction (the acquisition's moments) ------------------------------


def _sample(mean, var, generator, noise):
    z = _draw(noise, mean)
    if z is None:
        z = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device,
                        generator=generator)
    return mean + torch.sqrt(torch.clamp_min(var, 0.0)) * z


@ieee_fp32()
def predict_f(levels, datas, Xnew, num_samples, fidelity=-1, generator=None,
              noise=None):
    """Latent posterior of f_{fidelity} at ``Xnew`` [m, d] with MC
    propagation through the level chain: per-sample moments ([S, m, 1],
    [S, m, 1]); fidelity 0 is exact ([1, m, 1]).

    ``levels`` = per-level ``GPRParams``, ``datas`` = per-level
    (X_aug, Y, w) triples (level 0's X_aug is X)."""
    n_fid = len(levels)
    t_stop = fidelity % n_fid
    mean, var = gpr_mod.predict_f(levels[0], datas[0], Xnew)
    if t_stop == 0:
        return mean[None], var[None]
    noise = _source(noise)
    S, (m, d) = num_samples, Xnew.shape
    f = _sample(mean[None].expand(S, m, 1), var[None], generator, noise)
    Xt = Xnew[None].expand(S, m, d)
    for t in range(1, t_stop + 1):
        Xaug = torch.cat([Xt, f], dim=-1).reshape(S * m, d + 1)
        mean, var = gpr_mod.predict_f(levels[t], datas[t], Xaug)
        mean, var = mean.reshape(S, m, 1), var.reshape(S, m, 1)
        if t < t_stop:
            f = _sample(mean, var, generator, noise)
    return mean, var


def predict_y(levels, datas, Xnew, num_samples, fidelity=-1, generator=None,
              noise=None):
    """Observation posterior (latent + level noise), same contract."""
    mean, var = predict_f(levels, datas, Xnew, num_samples, fidelity,
                          generator, noise)
    return levels[fidelity % len(levels)].likelihood.predict_mean_and_var(
        mean, var)


def _mean_chain(levels, datas, Xnew, upto):
    """Deterministic mean propagation m_{upto}(Xnew) [n, 1]: what level
    ``upto + 1`` trains its augmented input column on."""
    m, _ = gpr_mod.predict_f(levels[0], datas[0], Xnew)
    for t in range(1, upto + 1):
        m, _ = gpr_mod.predict_f(levels[t], datas[t],
                                 torch.cat([Xnew, m], dim=1))
    return m


# -- the wrapper -------------------------------------------------------------------


class NARGP:
    """Stateful wrapper with the surrogate surface MF_BO and the
    acquisition engines rely on: ``name``, ``params`` (an
    ``nn.ModuleList`` of per-level ``GPRParams``), ``train_data``,
    ``predict_f(Xnew, S=, fidelity=)``.

    :param data: (Xs, Ys) per-fidelity lists, low -> high.
    :param n_bucket: pad each level's rows to multiples of this (exactly
        decoupled padding).
    :param kernel: 'rbf' | 'matern32' | 'matern52' for k_rho/k_f/k_delta.
    :param num_samples: default MC sample count of ``predict_f``.
    :param seed: the seed of the fixed prediction generator (repeated
        predictions without a generator are equal).
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).
    """

    name = "nargp"

    def __init__(self, data, n_bucket: Optional[int] = None,
                 kernel: str = "rbf", noise_variance: float = 1e-4,
                 num_samples: int = 100, seed: int = 0, device=None,
                 dtype=None):
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        self.data = _tensors(data, self.dtype, self.device)
        self.n_fid = len(self.data[0])
        self.n_bucket = n_bucket
        self.num_samples = int(num_samples)
        d = int(self.data[0][0].shape[1])
        self.params = nn.ModuleList(
            _level_params(t, d, kernel, noise_variance, self.dtype,
                          self.device)
            for t in range(self.n_fid))
        self._predict_seed = int(seed)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        # the augmented train_data is a function of params: invalidate
        self._params = value
        self._train_data = None

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        # and of the data: believer conditioning (MF_BO's batch infill)
        # appends fantasy rows and must see a recomputed mean chain
        self._data = value
        self._train_data = None

    def _padded(self, X, Y):
        if self.n_bucket:
            return training.pad_to_bucket(X, Y, self.n_bucket)
        return (X, Y, None)

    def _augmented(self, levels, datas, t):
        """Level t's padded (X_aug, Y, w): its inputs beside the mean chain
        of the levels below; padding rows repeat row 0, its augmented value
        included (weight-0 rows are exactly decoupled either way)."""
        Xs, Ys = self.data
        m = _mean_chain(levels[:t], datas, Xs[t], t - 1)
        return self._padded(torch.cat([Xs[t], m], dim=1), Ys[t])

    @property
    def train_data(self):
        """Per-level (X_aug, Y, w) triples under the current params,
        cached until ``params`` or ``data`` is assigned."""
        if self._train_data is None:
            Xs, Ys = self.data
            datas = [self._padded(Xs[0], Ys[0])]
            with torch.no_grad():
                for t in range(1, self.n_fid):
                    datas.append(self._augmented(self.params, datas, t))
            self._train_data = tuple(datas)
        return self._train_data

    def training_loss(self):
        """Sum of the per-level exact NLLs (they factorize)."""
        return sum(gpr_mod.neg_log_marginal_likelihood(p, *data)
                   for p, data in zip(self.params, self.train_data))

    def _starts(self, params: GPRParams, n_starts: int, generator):
        """One level's starts stacked over a leading axis: start 0
        canonical, later starts add 0.7 N(0, 1) to every unconstrained leaf
        (the tiny-n per-level NLL is multimodal)."""
        stacked = training.stack_starts([params] * n_starts)
        with torch.no_grad():
            for r in range(1, n_starts):
                for p in stacked.parameters():
                    p[r] += 0.7 * torch.randn(
                        p.shape[1:], dtype=p.dtype, device=p.device,
                        generator=generator)
        return stacked

    def optimize(self, n_starts: int = 8, iterations: int = 2000,
                 lr: float = 0.05, seed: int = 0):
        """Level-by-level multi-start Adam (level t's augmented inputs use
        the freshly trained levels below it). Returns the winning per-level
        loss traces."""
        Xs, Ys = self.data
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        params = list(self.params)
        datas = [self._padded(Xs[0], Ys[0])]
        traces, nlls = [], []
        for t in range(self.n_fid):
            if t > 0:
                with torch.no_grad():
                    datas.append(self._augmented(params, datas, t))
            stacked = self._starts(params[t], int(n_starts), gen)
            params[t], nll, losses = training.multistart_adam(
                gpr_mod.neg_log_marginal_likelihood, stacked, datas[t],
                int(iterations), float(lr))
            traces.append(losses)
            nlls.append(nll)
        self.params = nn.ModuleList(params)
        # the loop conditioned each level on its freshly trained lowers, so
        # these datas are the post-training train_data: seed the cache
        self._train_data = tuple(datas)
        # the joint NLL (the levels factorize), comparable with
        # AR1CoKriging._nll
        self._nll = float(sum(nlls))
        return traces

    def _as_input(self, X):
        return torch.as_tensor(np.asarray(X), dtype=self.dtype,
                               device=self.device)

    @torch.no_grad()
    def predict_f(self, Xnew, S: Optional[int] = None,
                  fidelity: Optional[int] = None, generator=None,
                  noise=None):
        """MC-propagated latent moments ([S, m, 1], [S, m, 1]); fidelity 0
        is exact ([1, m, 1]). Without ``generator`` or ``noise`` the draws
        come from a fresh generator seeded by the model's seed, so repeated
        calls are equal."""
        t = self.n_fid - 1 if fidelity is None else int(fidelity)
        S = self.num_samples if S is None else int(S)
        if generator is None and noise is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self._predict_seed)
        return predict_f(self.params, self.train_data, self._as_input(Xnew),
                         S, t, generator, noise)

    @torch.no_grad()
    def predict_y(self, Xnew, num_samples: Optional[int] = None,
                  fidelity: Optional[int] = None, generator=None,
                  noise=None):
        t = self.n_fid - 1 if fidelity is None else int(fidelity)
        mean, var = self.predict_f(Xnew, num_samples, fidelity, generator,
                                   noise)
        return self.params[t].likelihood.predict_mean_and_var(mean, var)
