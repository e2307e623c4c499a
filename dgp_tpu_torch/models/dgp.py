"""Doubly-stochastic Deep GP (Salimbeni & Deisenroth 2017), counterpart of
``dgp_tpu/models/dgp.py``.

The model is an ``nn.Module`` (``DGPParams``) plus plain functions
(``propagate``/``elbo``/``predict_*``); the ``DGP`` class is a thin stateful
wrapper with the reference's API, training included (``optimize_adam``,
``optimize_nat_adam``, on the loops of ``training.py``). Their products run
as IEEE fp32 (``config.ieee_fp32``), whatever TF32 setting the process has.
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
from ..ops.likelihoods import Gaussian, Likelihood
from . import training


class DGPParams(nn.Module):
    def __init__(self, layers, likelihood: Likelihood):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.likelihood = likelihood

    def forward(self, fn, *args):
        """``fn(self, *args)``. It lets ``torch.func.functional_call``
        evaluate a function of the model with some parameters replaced by
        other tensors (the natural-gradient step's candidate q)."""
        return fn(self, *args)


def _like(params: DGPParams, X):
    """X as a tensor on the model's device, in the model's dtype."""
    ref = params.layers[0].z
    return torch.as_tensor(X, dtype=ref.dtype, device=ref.device)


# -- plain functions ------------------------------------------------------------


@ieee_fp32()
def propagate(params: DGPParams, X, S: int, generator=None, full_cov=False,
              zs=None, projs=None):
    """Chain layer-wise reparameterized samples.

    :param generator: ``torch.Generator`` on the model's device, used where
        ``zs`` gives no fixed unit normals for a layer.
    :param projs: the layers' projections (stack_projections), where the
        caller has them already.
    :return: (Fs, Fmeans, Fvars) tuples of per-layer [S, N, D] tensors.
    """
    X = _like(params, X)
    F = X[None].expand(S, *X.shape)
    Fs, Fmeans, Fvars = [], [], []
    zs = zs if zs is not None else [None] * len(params.layers)
    if projs is None:
        projs = _projections(params)
    for layer, z, proj in zip(params.layers, zs, projs):
        F, Fmean, Fvar = sample_from_conditional(
            layer, layer.z, F, generator, full_cov=full_cov, z=z, proj=proj)
        Fs.append(F)
        Fmeans.append(Fmean)
        Fvars.append(Fvar)
    return tuple(Fs), tuple(Fmeans), tuple(Fvars)


def _projections(params: DGPParams):
    return stack_projections(params.layers, [l.z for l in params.layers])


def predict_f(params: DGPParams, X, S: int, generator=None, full_cov=False,
              zs=None, projs=None):
    _, Fmeans, Fvars = propagate(params, X, S, generator, full_cov=full_cov,
                                 zs=zs, projs=projs)
    return Fmeans[-1], Fvars[-1]


def weighted_data_term(var_exp, w):
    """(weighted row sum of E_S[var_exp], effective row count): rows of
    weight 0 are shape padding (training.pad_to_bucket). The elbos'
    default ``data_term``; on a mesh, ``parallel.data_parallel`` sums both
    over the ranks."""
    per_row = torch.mean(var_exp, dim=0)  # [N, D]
    if w is None:
        return torch.sum(per_row), per_row.shape[0]
    return torch.sum(w[:, None] * per_row), torch.sum(w)


@ieee_fp32()
def elbo(params: DGPParams, X, Y, num_samples: int, generator=None, zs=None,
         num_data: Optional[int] = None, row_weights=None, data_term=None):
    """Monte-Carlo ELBO: scale * sum_n E_q[log p(y|f)] - sum KL.

    :param num_data: full-dataset size when (X, Y) is a minibatch.
    :param row_weights: optional [N] 0/1 weights — rows with weight 0 are
        shape padding (training.pad_to_bucket) and contribute nothing to the
        data term; the effective row count is sum(row_weights).
    :param data_term: ``(var_exp, row_weights) -> (row sum, row count)``,
        :func:`weighted_data_term` by default (a sharded loss sums both over
        the ranks).
    """
    Y = _like(params, Y)
    # one factorization of each Kuu serves the conditionals and the KL
    projs = _projections(params)
    Fmean, Fvar = predict_f(params, X, num_samples, generator, zs=zs,
                            projs=projs)
    var_exp = params.likelihood.variational_expectations(Fmean, Fvar, Y)
    L, denom = (data_term or weighted_data_term)(var_exp, row_weights)
    kl = sum(layer_kl(layer, layer.z, proj.Lu)
             for layer, proj in zip(params.layers, projs))
    scale = 1.0 if num_data is None else num_data / denom
    return L * scale - kl


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


@torch.no_grad()
def shrink_inner_q_sqrt(params: DGPParams, factor=1e-3) -> DGPParams:
    """Scale inner-layer q_sqrt (in place) for optimization stability."""
    for layer in params.layers[:-1]:
        layer.q_sqrt.mul_(factor)
    return params


# -- variational-parameter plumbing for natural gradients -------------------------


def get_qs(params: DGPParams, indices):
    return [(params.layers[i].q_mu, params.layers[i].q_sqrt) for i in indices]


@torch.no_grad()
def set_qs(params: DGPParams, indices, qs) -> DGPParams:
    """Write (q_mu, q_sqrt) into the selected layers, in place."""
    for i, (q_mu, q_sqrt) in zip(indices, qs):
        params.layers[i].q_mu.copy_(q_mu)
        params.layers[i].q_sqrt.copy_(q_sqrt)
    return params


# -- loss factories ---------------------------------------------------------------


def full_batch_loss(num_samples: int):
    """-ELBO over a full (possibly row-padded) batch; batch = (X, Y, w, n)."""

    def loss(params, generator, batch):
        X, Y, w, num_data = batch
        return -elbo(params, X, Y, num_samples, generator, num_data=num_data,
                     row_weights=w)

    return loss


def minibatch_loss(num_samples: int, batch_size: int):
    """-ELBO over a uniform random minibatch drawn from the generator;
    batch = (X, Y, n_true). Padded rows (if any) sit past n_true and are
    never sampled."""

    def loss(params, generator, batch):
        X, Y, n_true = batch
        idx = torch.randint(0, n_true, (batch_size,), generator=generator,
                            device=X.device)
        return -elbo(params, X[idx], Y[idx], num_samples, generator,
                     num_data=n_true)

    return loss


# -- stateful wrapper -------------------------------------------------------------


class DGP:
    """Reference-parity wrapper.

    :param kernels: list of kernel modules (len(num_units)+1).
    :param num_units: hidden widths, e.g. [1, 1] for the notebook's [1,1,1] arch.
    :param minibatch_size: with a value below N, each training evaluation
        draws a uniform random batch and rescales the data term to the full N.
    :param n_bucket: pad (X, Y) to the next multiple of this many rows with
        zero-weight rows, so shapes stay stable while a BO loop grows N.
    :param mesh: a ``torch.distributed.device_mesh.DeviceMesh``
        (``parallel.mesh.make_mesh``): training then runs data-parallel,
        one process per rank, each holding its block of the rows; the
        parameters start as the mesh's first rank's, and each rank draws
        from its own generator (``parallel.data_parallel.rank_generator``).
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).
    """

    name = "dgp"

    def __init__(self, X, Y, Z, kernels, num_units,
                 likelihood: Optional[Likelihood] = None, num_outputs=None,
                 mean_function=None, white=False, num_samples=1,
                 minibatch_size: Optional[int] = None,
                 n_bucket: Optional[int] = None, mesh=None, seed=0,
                 device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or default_float()
        with ieee_fp32():
            layers = init_layers_linear(
                X, Y, Z, kernels, num_units, num_outputs=num_outputs,
                mean_function=mean_function, white=white, dtype=dtype,
                device=device)
        self._setup(X, Y, layers, likelihood, num_samples, minibatch_size,
                    n_bucket, mesh, seed, device, dtype)

    @classmethod
    def from_layers(cls, X, Y, layers, likelihood=None, num_samples=1,
                    minibatch_size=None, n_bucket=None, mesh=None, seed=0,
                    device=None, dtype=None):
        """Build a DGP from a custom layer stack."""
        self = cls.__new__(cls)
        self._setup(X, Y, layers, likelihood, num_samples, minibatch_size,
                    n_bucket, mesh, seed, resolve_device(device),
                    dtype or default_float())
        return self

    def _setup(self, X, Y, layers, likelihood, num_samples, minibatch_size,
               n_bucket, mesh, seed, device, dtype):
        likelihood = likelihood or Gaussian.create(1.0, dtype=dtype)
        self.params = DGPParams(layers, likelihood).to(device=device,
                                                       dtype=dtype)
        self.num_samples = num_samples
        self.minibatch_size = minibatch_size
        self.n_bucket = n_bucket
        self.device, self.dtype = device, dtype
        self.data = (
            torch.as_tensor(np.asarray(X), dtype=dtype, device=device),
            torch.as_tensor(np.asarray(Y), dtype=dtype, device=device),
        )
        self.seed = seed
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.mesh = training.on_mesh(self, mesh)

    def _as_input(self, X):
        return torch.as_tensor(X, dtype=self.dtype, device=self.device)

    def _loss_spec(self):
        """(loss_fn, batch) for the training loops.

        With ``minibatch_size`` set, each evaluation draws a uniform random
        batch and rescales the data term to the full N. With ``n_bucket``
        set, (X, Y) is padded to the next row bucket with zero-weight rows.
        With ``mesh`` set, the ELBO runs data-parallel: this rank's block of
        the rows (padded to a multiple of the row ranks with 0/1 weights)
        and one all-reduce per data term and per gradient — 1-D data
        meshes, 2-D data x sample meshes and (slice, data) meshes, with
        ``minibatch_size`` through per-rank unbiased index draws
        (``parallel.data_parallel``)."""
        X, Y = self.data
        S, B, N = self.num_samples, self.minibatch_size, X.shape[0]
        if self.mesh is not None:
            from ..parallel import data_parallel as dp

            batch = dp.pad_shard_batch(self.mesh, X, Y, self.n_bucket)
            if B is not None and B < N:
                return dp.sharded_dgp_minibatch_loss(self.mesh, S, B), batch
            return dp.sharded_dgp_loss(self.mesh, S), batch
        if B is not None and B < N:
            if self.n_bucket:
                X, Y, _ = training.pad_to_bucket(X, Y, self.n_bucket)
            return minibatch_loss(S, B), (X, Y, N)
        if self.n_bucket:
            Xp, Yp, w = training.pad_to_bucket(X, Y, self.n_bucket)
            return full_batch_loss(S), (Xp, Yp, w, None)
        return full_batch_loss(S), (X, Y, None, None)

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

    def predict_y_sharded(self, Xnew, num_samples, mesh=None,
                          chunk_size=None):
        """Data-parallel batch inference: every rank passes the same
        ``Xnew``, computes its block of the rows and returns the full
        ``(mean, var)``, each ``[S, N, D]`` as ``predict_y``
        (``parallel.serving``).

        :param mesh: 1-D data mesh (default: the model's training mesh).
        :param chunk_size: optional row chunk, a multiple of the mesh size —
            bounds the ``[S, chunk, D]`` intermediates of very large
            prediction sets.
        """
        from ..parallel import serving

        return serving.predict_y_sharded(
            self, lambda m: serving.sharded_predict_y(m, num_samples), Xnew,
            mesh, chunk_size)

    def number_parameters(self, trainable=True):
        mask = training.make_mask(self.params)
        return sum(t.numel() for name, t in training.named_tensors(self.params)
                   if mask[name] or not trainable)

    def _checkpoint_fn(self, checkpoint_path):
        return training.checkpoint_fn_of(self, checkpoint_path)

    def optimize_adam(
        self, iterations=5000, lr=0.01, beta_1=0.9, beta_2=0.999,
        epsilon=1e-7, messages=100, checkpoint_path=None, checkpoint_every=0,
        shrink_inner=True,
    ):
        """Plain Adam on everything, inner q_sqrt shrunk 1e-3; returns the
        losses [iterations].

        The JAX package trains under a scope that drops the TPU's cotangent
        products to one bf16 pass; that has no counterpart here: the port
        trains in IEEE fp32 (``config.ieee_fp32``).

        :param checkpoint_path: with ``checkpoint_every`` > 0, the
            parameters are saved here every that many steps, so a long run
            survives preemption (restore via utils.checkpoint.load).
        :param shrink_inner: scale inner-layer q_sqrt by 1e-3 before the run
            (the reference does this at the top of every optimize call —
            correct for cold/warm full training, destructive for short warm
            refits, which pass False)."""
        if shrink_inner:
            shrink_inner_q_sqrt(self.params)
        mask = training.make_mask(self.params)
        loss_fn, batch = self._loss_spec()
        _, losses = training.adam_run(
            loss_fn, self.params, mask, self.generator,
            steps=iterations, lr=lr, b1=beta_1, b2=beta_2, eps=epsilon,
            messages=messages, data=batch,
            checkpoint_every=checkpoint_every,
            checkpoint_fn=self._checkpoint_fn(checkpoint_path),
        )
        return losses

    def optimize_nat_adam(
        self, iterations1=100, iterations2=5000, lr_adam=0.01, lr_gamma=0.01,
        beta_1=0.9, beta_2=0.999, epsilon=1e-7, ng_all=True, messages=100,
        checkpoint_path=None, checkpoint_every=0, shrink_inner=True,
    ):
        """Two-phase Adam -> Adam+NatGrad training, in IEEE fp32 (see
        :meth:`optimize_adam`); returns the losses
        [iterations1 + iterations2].

        :param ng_all: natural gradients on every layer's (q_mu, q_sqrt), or
            on the last layer's only.
        :param shrink_inner: scale inner-layer q_sqrt by 1e-3 first
            (reference parity); warm refits pass False — repeating the
            shrink per refit collapses the trained inner posterior by 1e-3
            each time."""
        if shrink_inner:
            shrink_inner_q_sqrt(self.params)
        n_layers = len(self.params.layers)
        sel = tuple(range(n_layers)) if ng_all else (n_layers - 1,)
        frozen = {i: {"q_mu", "q_sqrt"} for i in sel}
        euclid_mask = training.make_mask(self.params,
                                         frozen_layer_fields=frozen)
        loss_fn, batch = self._loss_spec()
        ckpt_fn = self._checkpoint_fn(checkpoint_path)

        _, losses1 = training.adam_run(
            loss_fn, self.params, euclid_mask, self.generator,
            steps=iterations1, lr=lr_adam, b1=beta_1, b2=beta_2, eps=epsilon,
            messages=messages, data=batch,
            checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn,
        )
        _, losses2 = training.nat_adam_run(
            loss_fn, self.params, euclid_mask,
            get_qs=lambda p: get_qs(p, sel),
            set_qs=lambda p, qs: set_qs(p, sel, qs),
            generator=self.generator,
            steps=iterations2, lr_adam=lr_adam, gamma=lr_gamma,
            b1=beta_1, b2=beta_2, eps=epsilon, messages=messages, data=batch,
            checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn,
        )
        return torch.cat([losses1, losses2]) if iterations1 else losses2
