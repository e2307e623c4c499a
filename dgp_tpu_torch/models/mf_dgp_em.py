"""Multi-fidelity deep GP with Embedded Mapping (fidelities whose inputs
have different dimensions), counterpart of ``dgp_tpu/models/mf_dgp_em.py``.

A chain of *reduction* layers maps the highest fidelity's inputs down to
each lower input space. Propagation runs the reduction chain first,
collecting the representations Hs, then the fidelity chain with skip
concatenation [Hs[-(i+1)], F]. The ELBO adds a projection data term that
supervises the reduction posterior with given projections ``X_red`` under a
Gaussian likelihood of its own, and the reduction layers' KLs.

Kept as the JAX package keeps it: the projection term of fidelity f is
scaled by N_{f+1} / N_f (the next fidelity's data size over the current
fidelity's), generalized to (n_next / eff_next) * (n_next / n_cur) under
minibatches and row weights; both reduce to N_{f+1} / N_f at full batch.

Random numbers as in ``mf_dgp``: every function takes a ``torch.Generator``
and, in its place, an optional ``noise``: fixed unit normals consumed in
the order the JAX functions draw theirs (:func:`elbo`: first
:func:`compute_full_zs_em`, for each fidelity i >= 1 one
[num_samples, M_i, D] draw per reduction layer of its sub-chain, then per
earlier fidelity layer; then, per fidelity f trained, one [S, N_f, D] draw
per reduction layer ``layers_red[L-f:]`` and per layer 0..f and, below the
last fidelity, one [S, N_{f+1}, D] per reduction layer
``layers_red[L-f-1:]`` for the projection term). The JAX package's
``propagate(project=True)`` also draws and computes a Z_right that it drops;
here nothing is drawn or computed for it.
Products run as IEEE fp32 (``config.ieee_fp32``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import default_float, ieee_fp32, resolve_device
from ..layers.svgp import (
    layer_kl,
    make_svgp_layer,
    mean_propagated_sample,
    sample_from_conditional,
    stack_projections,
)
from ..ops import kernels as K
from ..ops.likelihoods import Gaussian, fidelity_variational_expectations
from . import training
from .dgp import DGPParams, _like, moment_matched, weighted_data_term
from .mf_dgp import (
    _draw,
    _source,
    _white_variance,
    coupled_kernel,
    set_variance,
    with_white,
)


class MFDGPEMParams(DGPParams):
    """The fidelity layers (layer 0 plain, the others augmented), the
    reduction layers, the highest-fidelity likelihood and the projection
    term's likelihood."""

    def __init__(self, layers, layers_red, likelihood: Gaussian,
                 likelihood_projection: Gaussian):
        super().__init__(layers, likelihood)
        self.layers_red = nn.ModuleList(layers_red)
        self.likelihood_projection = likelihood_projection


# -- augmented inducing points through the reduction chain ----------------------


def z_right_em(layers: Sequence, zs_full: Sequence, layers_red: Sequence,
               zs_red: Sequence, points, generator=None, num_samples=50,
               noise=None):
    """Map ``points`` through the reduction chain, then through the earlier
    fidelity layers with skip concatenation, each as a mean of
    ``num_samples`` reparameterized samples: the augmented coordinate."""
    noise = _source(noise)
    H = points
    Hs = [H]
    for layer_red, z in zip(layers_red, zs_red):
        H = mean_propagated_sample(layer_red, z, H, generator, num_samples,
                                   z=_draw(noise, points))
        Hs.append(H)
    zr = None
    for i, (layer, zf) in enumerate(zip(layers, zs_full)):
        inp = Hs[-1] if i == 0 else torch.cat([Hs[-(i + 1)], zr], dim=1)
        zr = mean_propagated_sample(layer, zf, inp, generator, num_samples,
                                    z=_draw(noise, points))
    return zr


def compute_full_zs_em(params: MFDGPEMParams, generator=None, num_samples=50,
                       noise=None):
    """Effective per-layer inducing inputs, recomputed at each evaluation:
    layer i >= 1 maps its Z_left through the reduction sub-chain
    ``layers_red[L-i:]`` and the layers before it."""
    noise = _source(noise)
    L = len(params.layers_red)
    zs_red = [layer.z for layer in params.layers_red]
    zs = [params.layers[0].z]
    for i in range(1, len(params.layers)):
        zl = params.layers[i].z_left
        zr = z_right_em(params.layers[:i], zs[:i], params.layers_red[L - i:],
                        zs_red[L - i:], zl, generator, num_samples,
                        noise=noise)
        zs.append(torch.cat([zl, zr], dim=1))
    return zs


def _projections(params: MFDGPEMParams, zs_full, n_layers: int,
                 red_from: int):
    """Projections of the fidelity layers 0..n_layers-1 at ``zs_full`` and
    of the reduction layers from ``red_from`` on, from one stack (#8 once
    per (M, white) group): (fidelity list, reduction list with None before
    ``red_from``)."""
    reds = list(params.layers_red)[red_from:]
    projs = stack_projections(
        list(params.layers[:n_layers]) + reds,
        list(zs_full or ())[:n_layers] + [layer.z for layer in reds])
    return projs[:n_layers], [None] * red_from + projs[n_layers:]


# -- model math ---------------------------------------------------------------


@ieee_fp32()
def propagate(params: MFDGPEMParams, X, S: int, generator=None, zs_full=None,
              fidelity_dim: Optional[int] = None, project=False,
              full_cov=False, noise=None, projs=None):
    """The reduction chain, then the fidelity chain.

    :param zs_full: the layers' effective inducing inputs; recomputed
        (:func:`compute_full_zs_em`, drawing first) where not given, unless
        ``project``.
    :param fidelity_dim: how many reduction layers to apply
        (``layers_red[L-fidelity_dim:]``) and fidelity layers
        (0..fidelity_dim); None = all (the highest fidelity).
    :param project: return the reduction outputs (Hs) instead.
    :param projs: (fidelity, reduction) projection lists
        (:func:`_projections`), where the caller has them already.
    :return: (samples, means, variances) tuples of per-layer [S, N, D]
        tensors; with ``project``, Hs holds the [S, N, Din] inputs first.
    """
    X = _like(params, X)
    noise = _source(noise)
    L = len(params.layers_red)
    fidelity_dim = L if fidelity_dim is None else fidelity_dim
    n_layers = 0 if project else fidelity_dim + 1
    if not project and zs_full is None:
        zs_full = compute_full_zs_em(params, generator, noise=noise)
    if projs is None:
        projs = _projections(params, zs_full, n_layers, L - fidelity_dim)
    sX = X[None].expand(S, *X.shape)
    H = sX
    Hs = [H]
    Hmeans, Hvars = [], []
    for j in range(L - fidelity_dim, L):
        layer_red = params.layers_red[j]
        H, Hmean, Hvar = sample_from_conditional(
            layer_red, layer_red.z, H, generator, full_cov=full_cov,
            z=_draw(noise, X), proj=projs[1][j])
        Hs.append(H)
        Hmeans.append(Hmean)
        Hvars.append(Hvar)
    if project:
        return tuple(Hs), tuple(Hmeans), tuple(Hvars)

    F = None
    Fs, Fmeans, Fvars = [], [], []
    for i in range(n_layers):
        inp = Hs[-1] if i == 0 else torch.cat([Hs[-(i + 1)], F], dim=2)
        F, Fmean, Fvar = sample_from_conditional(
            params.layers[i], zs_full[i], inp, generator, full_cov=full_cov,
            z=_draw(noise, X), proj=projs[0][i])
        Fs.append(F)
        Fmeans.append(Fmean)
        Fvars.append(Fvar)
    return tuple(Fs), tuple(Fmeans), tuple(Fvars)


def predict_f(params: MFDGPEMParams, X, S: int, generator=None,
              fidelity: Optional[int] = None,
              fidelity_dim: Optional[int] = None, full_cov=False, noise=None):
    _, Fmeans, Fvars = propagate(params, X, S, generator,
                                 fidelity_dim=fidelity_dim, full_cov=full_cov,
                                 noise=noise)
    idx = -1 if fidelity is None else fidelity
    return Fmeans[idx], Fvars[idx]


def project(params: MFDGPEMParams, X, S: int, generator=None,
            fidelity: Optional[int] = None,
            fidelity_dim: Optional[int] = None, noise=None):
    """The reduction posterior at X: (mean, variance) of reduction output
    ``fidelity`` (the last by default)."""
    _, Hmeans, Hvars = propagate(params, X, S, generator,
                                 fidelity_dim=fidelity_dim, project=True,
                                 noise=noise)
    idx = -1 if fidelity is None else fidelity
    return Hmeans[idx], Hvars[idx]


@ieee_fp32()
def elbo(params: MFDGPEMParams, Xs, Ys, X_red, num_samples: int,
         generator=None, train_upto_fidelity: int = -1, row_weights=None,
         num_data=None, noise=None, data_term=None):
    """Fidelity data terms + projection data terms - every KL. The
    augmented inducing inputs are recomputed first; each layer's Kuu, the
    reduction layers' too, is then factored once (the projections, whose
    Lu the KLs take).

    :param train_upto_fidelity: fidelities 0..k only (with their projection
        terms and the KLs of reduction layers 0..k); -1 = all.
    :param row_weights: optional per-fidelity 0/1 row weights (padding);
        fidelity f + 1's weights also weigh projection term f.
    :param num_data: optional per-fidelity full-dataset sizes; data terms
        are then scaled N_f / B_f and projection term f by
        (N_{f+1} / B_{f+1}) * (N_{f+1} / N_f).
    :param data_term: ``(var_exp, row_weights) -> (row sum, row count)``
        (``dgp.weighted_data_term`` by default; a sharded loss sums both
        over the ranks).
    """
    data_term = data_term or weighted_data_term
    noise = _source(noise)
    zs_full = compute_full_zs_em(params, generator, noise=noise)
    n_layers = len(params.layers)
    used = (n_layers if train_upto_fidelity == -1
            else min(train_upto_fidelity + 1, n_layers))
    projs = _projections(params, zs_full, used, 0)
    L = KL = L_red = KL_red = 0.0
    for fidelity in range(used):
        Y = _like(params, Ys[fidelity])
        _, Fmeans, Fvars = propagate(
            params, Xs[fidelity], num_samples, generator, zs_full=zs_full,
            fidelity_dim=fidelity, noise=noise, projs=projs)
        Fmean, Fvar = Fmeans[fidelity], Fvars[fidelity]
        if fidelity == n_layers - 1:
            var_exp = params.likelihood.variational_expectations(Fmean, Fvar, Y)
        else:
            var_exp = fidelity_variational_expectations(
                Fmean, Fvar, Y, _white_variance(params.layers[fidelity]))
        w = None if row_weights is None else row_weights[fidelity]
        term, eff = data_term(var_exp, w)
        n_cur = eff if num_data is None else num_data[fidelity]
        L = L + term * (n_cur / eff)
        KL = KL + layer_kl(params.layers[fidelity], zs_full[fidelity],
                           projs[0][fidelity].Lu)
        if fidelity < n_layers - 1:
            _, Hmeans, Hvars = propagate(
                params, Xs[fidelity + 1], num_samples, generator,
                fidelity_dim=fidelity + 1, project=True, noise=noise,
                projs=projs)
            ve_red = params.likelihood_projection.variational_expectations(
                Hmeans[fidelity], Hvars[fidelity],
                _like(params, X_red[fidelity]))
            w_next = None if row_weights is None else row_weights[fidelity + 1]
            term_red, eff_next = data_term(ve_red, w_next)
            n_next = eff_next if num_data is None else num_data[fidelity + 1]
            # (estimation factor) * (the N_{f+1} / N_f scale, kept)
            L_red = L_red + term_red * ((n_next / eff_next) * (n_next / n_cur))
            red = params.layers_red[fidelity]
            KL_red = KL_red + layer_kl(red, red.z, projs[1][fidelity].Lu)
    return L + L_red - KL - KL_red


def predict_y(params: MFDGPEMParams, X, S: int, generator=None,
              full_cov=False, noise=None):
    Fmean, Fvar = predict_f(params, X, S, generator, full_cov=full_cov,
                            noise=noise)
    return params.likelihood.predict_mean_and_var(Fmean, Fvar)


def predict_density(params: MFDGPEMParams, X, Y, S: int, generator=None,
                    noise=None):
    """log E_S[p(y|f)] at the highest fidelity, a logsumexp over samples."""
    Y = _like(params, Y)
    Fmean, Fvar = predict_f(params, X, S, generator, noise=noise)
    log_p = params.likelihood.predict_density(Fmean, Fvar, Y)
    return torch.logsumexp(log_p - math.log(S), dim=0)


# -- loss factories -----------------------------------------------------------


def full_batch_loss(num_samples: int, train_upto: int = -1):
    """-ELBO over the full (possibly row-padded) batch; batch = (Xs, Ys,
    X_red, row_weights, num_data), the last two None for a plain full
    batch."""

    def loss(params, generator, batch):
        Xs, Ys, Xr, ws, nd = batch
        return -elbo(params, Xs, Ys, Xr, num_samples, generator,
                     train_upto_fidelity=train_upto, row_weights=ws,
                     num_data=nd)

    return loss


def minibatch_loss(num_samples: int, batch_sizes: tuple, train_upto: int = -1):
    """-ELBO over per-fidelity uniform random minibatches drawn from the
    generator; the projection targets X_red[f] pair with fidelity f + 1's
    rows, so they take its index draw. batch = (Xs, Ys, X_red, n_trues)."""

    def loss(params, generator, batch):
        Xs, Ys, Xr, n_trues = batch
        idxs = [torch.randint(0, n_trues[f], (B,), generator=generator,
                              device=Xs[f].device)
                for f, B in enumerate(batch_sizes)]
        Xb = [X[idx] for X, idx in zip(Xs, idxs)]
        Yb = [Y[idx] for Y, idx in zip(Ys, idxs)]
        Xrb = [Xr[f][idxs[f + 1]] for f in range(len(batch_sizes) - 1)]
        return -elbo(params, Xb, Yb, Xrb, num_samples, generator,
                     train_upto_fidelity=train_upto, num_data=n_trues)

    return loss


def get_qs(params: MFDGPEMParams):
    """(q_mu, q_sqrt) of every fidelity layer, then of every reduction
    layer: the natural gradient's pairs."""
    return [(layer.q_mu, layer.q_sqrt)
            for layer in (*params.layers, *params.layers_red)]


@torch.no_grad()
def set_qs(params: MFDGPEMParams, qs) -> MFDGPEMParams:
    """Write the pairs of :func:`get_qs`'s order, in place."""
    for layer, (q_mu, q_sqrt) in zip((*params.layers, *params.layers_red),
                                     qs):
        layer.q_mu.copy_(q_mu)
        layer.q_sqrt.copy_(q_sqrt)
    return params


# -- construction -------------------------------------------------------------


def make_mf_em_kernels(X: Sequence, add_linear=True, dtype=None, device=None):
    """Per-fidelity composite kernels on each fidelity's own input
    dimensions (White on every layer but the last), and the reduction
    layers' ARD RBFs: (kernels, kernels_red)."""
    f = dict(dtype=dtype, device=device)
    n_fidelities = len(X)
    Din0 = np.asarray(X[0]).shape[1]
    kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * Din0,
                            active_dims=list(range(Din0)), **f)]
    kernels += [coupled_kernel(np.asarray(X[l]).shape[1], add_linear, **f)
                for l in range(1, n_fidelities)]
    kernels = with_white(kernels, **f)
    kernels_red = [
        K.RBF.create(variance=1.0,
                     lengthscales=[1.0] * np.asarray(X[-(l + 1)]).shape[1],
                     **f)
        for l in range(n_fidelities - 1)]
    return kernels, kernels_red


@ieee_fp32()
@torch.no_grad()
def init_layers_mf_em(X, Z, W, kernels, kernels_red, num_outputs=1,
                      generator=None, num_samples=100, noise=None, dtype=None,
                      device=None):
    """(fidelity layers, reduction layers). Reduction layer i - 1 maps
    X[-i]'s space to X[-(1+i)]'s, its inducing inputs W[i-1]; fidelity
    layer i >= 1 is augmented, its initial q_sqrt the factor of Kuu at its
    full initial inducing inputs [Z_i, z_right_em(Z_i)] (kernel #7 where it
    applies, as for every layer's).

    :param generator: ``torch.Generator`` for the z_right draws; by default
        one seeded with 0 (the JAX package's default key is PRNGKey(0)).
    """
    dtype = dtype or default_float()
    device = torch.device("cpu") if device is None else torch.device(device)
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)
    noise = _source(noise)
    as_tensor = lambda z: torch.tensor(np.asarray(z), dtype=dtype,
                                       device=device)
    layers_red = [
        make_svgp_layer(kernels_red[i - 1], as_tensor(W[i - 1]),
                        np.asarray(X[-(1 + i)]).shape[1], dtype=dtype,
                        device=device)
        for i in range(1, len(X))]
    L = len(layers_red)
    zs_red = [layer.z for layer in layers_red]
    layers = [make_svgp_layer(kernels[0], as_tensor(Z[0]), num_outputs,
                              dtype=dtype, device=device)]
    zs_full = [layers[0].z]
    for i in range(1, len(Z)):
        zl = as_tensor(Z[i])
        zr = z_right_em(layers[:i], zs_full[:i], layers_red[L - i:],
                        zs_red[L - i:], zl, generator, num_samples,
                        noise=noise)
        z_full = torch.cat([zl, zr], dim=1)
        layers.append(make_svgp_layer(kernels[i], zl, num_outputs,
                                      augmented=True, Z_full_init=z_full,
                                      dtype=dtype, device=device))
        zs_full.append(z_full)
    return layers, layers_red


# -- stateful wrapper ---------------------------------------------------------


class MultiFidelityDeepGP_EM:
    """Reference-parity wrapper: 3-phase staged training, default Z = the
    training inputs and W = [X[-1], X[-2], ...], moment-matched prediction
    over 250 samples.

    :param X: per-fidelity inputs, low to high (their dimensions may
        differ).
    :param X_red: given projections of the higher fidelities' inputs into
        each lower space (Park_VD: ``X[1][:, :2]``).
    :param W: reduction layers' inducing inputs.
    :param minibatch_size: per-fidelity minibatch sizes (an int shared by
        all, or a list).
    :param n_bucket: pad each fidelity's rows (and the projection targets
        paired with them) to the next multiple of this many with zero-weight
        rows.
    :param mesh: a 1-D ``DeviceMesh`` (``parallel.mesh.make_mesh``): every
        fidelity's rows, and the projection targets paired with them, then
        shard over its ranks (``parallel.data_parallel.sharded_em_loss``).
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).
    """

    name = "mf_dgp_EM"

    def __init__(self, X, Y, X_red, Z=None, W=None, n_iter=5000,
                 fix_inducing=True, num_samples=100, seed=0,
                 minibatch_size=None, n_bucket=None, mesh=None, device=None,
                 dtype=None):
        device = resolve_device(device)
        dtype = dtype or default_float()
        self.device, self.dtype = device, dtype
        self._X = [self._as_input(np.asarray(x)) for x in X]
        self._Y = [self._as_input(np.asarray(y)) for y in Y]
        self._X_red = [self._as_input(np.asarray(x)) for x in X_red]
        self.n_fidelities = len(X)
        self.num_samples = num_samples
        if isinstance(minibatch_size, int):
            minibatch_size = [minibatch_size] * len(X)
        self.minibatch_size = minibatch_size
        self.n_bucket = n_bucket
        self.seed = seed
        self.generator = torch.Generator(device=device).manual_seed(seed)
        if Z is None:
            Z = self._make_inducing_points(X, Y)
        if W is None:
            W = [np.asarray(x).copy() for x in X[:0:-1]]
        self.Z, self.W = Z, W
        kernels, kernels_red = make_mf_em_kernels(X, dtype=dtype,
                                                  device=device)
        layers, layers_red = init_layers_mf_em(
            X, Z, W, kernels, kernels_red, generator=self.generator,
            dtype=dtype, device=device)
        self.params = MFDGPEMParams(
            layers, layers_red,
            Gaussian.create(1.0, dtype=dtype, device=device),
            Gaussian.create(1.0, dtype=dtype, device=device))
        self.n_iter = n_iter
        self.fix_inducing = fix_inducing
        self.mesh = training.on_mesh(self, mesh)

    def _as_input(self, X):
        return torch.as_tensor(X, dtype=self.dtype, device=self.device)

    def _loss_spec(self, train_upto: int = -1):
        """(loss_fn, batch) for the training loops. With ``minibatch_size``:
        per-fidelity uniform batches, the projection targets drawn with the
        next fidelity's rows. With ``n_bucket``: rows padded per fidelity
        with 0/1 weights, X_red[f-1] in lockstep with fidelity f. With
        ``mesh``: this rank's blocks of those rows, padded to a multiple of
        the ranks (and of ``n_bucket``), X_red[f-1] with fidelity f's."""
        Xs, Ys, Xr = list(self._X), list(self._Y), list(self._X_red)
        if self.mesh is not None:
            from ..parallel import data_parallel as dp

            Xs, Ys, ws, nds = dp.pad_shard_fidelity_batch(
                self.mesh, Xs, Ys, self.n_bucket)
            # X_red[f-1] rows pair with fidelity f's rows: padded alike
            Xr = tuple(dp.pad_shard_batch(self.mesh, self._X[f], Xr[f - 1],
                                          self.n_bucket)[1]
                       for f in range(1, len(Xs)))
            batch = (Xs, Ys, Xr, ws, nds)
            if self.minibatch_size is not None:
                sizes = tuple(min(int(b), x.shape[0])
                              for b, x in zip(self.minibatch_size, self._X))
                return (dp.sharded_em_minibatch_loss(
                    self.mesh, self.num_samples, sizes, train_upto), batch)
            return (dp.sharded_em_loss(self.mesh, self.num_samples,
                                       train_upto), batch)
        if self.minibatch_size is not None:
            sizes = tuple(min(int(b), x.shape[0])
                          for b, x in zip(self.minibatch_size, Xs))
            n_trues = tuple(x.shape[0] for x in Xs)
            return (minibatch_loss(self.num_samples, sizes, train_upto),
                    (tuple(Xs), tuple(Ys), tuple(Xr), n_trues))
        if self.n_bucket:
            ws, nd = [], []
            for f in range(len(Xs)):
                Xs[f], Ys[f], w = training.pad_to_bucket(Xs[f], Ys[f],
                                                         self.n_bucket)
                if f >= 1:  # X_red[f-1] rows pair with Xs[f] rows
                    Xr[f - 1] = training.pad_to_bucket(
                        self._X[f], Xr[f - 1], self.n_bucket)[1]
                ws.append(w)
                nd.append(self._X[f].shape[0])
            return (full_batch_loss(self.num_samples, train_upto),
                    (tuple(Xs), tuple(Ys), tuple(Xr), tuple(ws), tuple(nd)))
        return (full_batch_loss(self.num_samples, train_upto),
                (tuple(Xs), tuple(Ys), tuple(Xr), None, None))

    # -- reference API --------------------------------------------------------
    @torch.no_grad()
    def objective(self):
        return elbo(self.params, self._X, self._Y, self._X_red,
                    self.num_samples, self.generator)

    ELBO = objective

    @torch.no_grad()
    def propagate(self, X, full_cov=False, S=1, fidelity_dim=None,
                  project=False):
        return propagate(self.params, self._as_input(X), S, self.generator,
                         fidelity_dim=fidelity_dim, project=project,
                         full_cov=full_cov)

    def predict_all_layers(self, Xnew, num_samples):
        """Every layer's samples, means and variances."""
        return self.propagate(Xnew, full_cov=False, S=num_samples)

    @torch.no_grad()
    def predict_f(self, X, full_cov=False, S=1, fidelity=None,
                  fidelity_dim=None):
        return predict_f(self.params, self._as_input(X), S, self.generator,
                         fidelity=fidelity, fidelity_dim=fidelity_dim,
                         full_cov=full_cov)

    @torch.no_grad()
    def project(self, X, full_cov=False, S=1, fidelity=None,
                fidelity_dim=None):
        return project(self.params, self._as_input(X), S, self.generator,
                       fidelity=fidelity, fidelity_dim=fidelity_dim)

    @torch.no_grad()
    def predict_y(self, Xnew, num_samples, full_cov=False):
        return predict_y(self.params, self._as_input(Xnew), num_samples,
                         self.generator, full_cov=full_cov)

    def predict_y_sharded(self, Xnew, num_samples, mesh=None,
                          chunk_size=None):
        """Data-parallel batch inference of the highest fidelity (see
        ``DGP.predict_y_sharded``)."""
        from ..parallel import serving

        return serving.predict_y_sharded(
            self, lambda m: serving.sharded_predict_y_em(m, num_samples),
            Xnew, mesh, chunk_size)

    @torch.no_grad()
    def predict_density(self, Xnew, Ynew, num_samples):
        """log E_S[p(y|f)] via logsumexp over samples."""
        return predict_density(self.params, self._as_input(Xnew),
                               self._as_input(np.asarray(Ynew)), num_samples,
                               self.generator)

    def predict(self, X_test, full_cov=False):
        """Highest fidelity, moment-matched over 250 samples."""
        y_m, y_v = self.predict_y(X_test, 250, full_cov=full_cov)
        mean, var = moment_matched(y_m, y_v)
        return (mean.cpu().numpy().reshape(-1, 1),
                var.cpu().numpy().reshape(-1, 1))

    # -- staged training ------------------------------------------------------
    @torch.no_grad()
    def _init_variational(self, q_scale_fid=1e-3, q_scale_red=1e-5):
        """q init recipe: fidelity q_mu <- Y_f and reduction q_mu <- the
        matching X_red where the shapes agree; fidelity q_sqrt scaled by
        q_scale_fid times the population variance of Y_f, reduction q_sqrt
        by q_scale_red; the likelihood variances <- 1e-3 times the
        population variance of Y_last and of X_red[-1]."""
        for layer, y in zip(self.params.layers, self._Y):
            if layer.q_mu.shape == y.shape:
                layer.q_mu.copy_(y)
            layer.q_sqrt.mul_(q_scale_fid * torch.var(y, correction=0))
        for i, layer in enumerate(self.params.layers_red):
            xr = self._X_red[-(i + 1)]
            if layer.q_mu.shape == xr.shape:
                layer.q_mu.copy_(xr)
            layer.q_sqrt.mul_(q_scale_red)
        set_variance(self.params.likelihood,
                     float(torch.var(self._Y[-1], correction=0)) * 1e-3)
        set_variance(self.params.likelihood_projection,
                     float(torch.var(self._X_red[-1], correction=0)) * 1e-3)

    def _phase_masks(self):
        """Frozen sets per phase, both likelihoods frozen in the first two:
        (1) the kernels and the reduction layers' inducing inputs; (2) and
        the fidelity layers' inducing inputs; (3, Adam) everything but the
        projection likelihood and the reduction layers' q. The natural-
        gradient phase keeps (2)'s mask (its Adam takes no likelihood) and
        moves every q, the reduction layers' too."""
        q = {"q_mu", "q_sqrt"}
        lik = {"likelihood", "likelihood_projection"}
        m1 = training.make_mask(
            self.params, frozen_fields=lik,
            frozen_layer_fields={("layers", "all"): q | {"z", "z_left"},
                                 ("layers_red", "all"): q})
        m2 = training.make_mask(
            self.params, frozen_fields=lik,
            frozen_layer_fields={("layers", "all"): q,
                                 ("layers_red", "all"): q})
        m3 = training.make_mask(
            self.params, frozen_fields={"likelihood_projection"},
            frozen_layer_fields={("layers_red", "all"): q})
        return m1, m2, m3

    def _checkpoint_fn(self, checkpoint_path):
        return training.checkpoint_fn_of(self, checkpoint_path)

    def optimize_nat_adam(self, lr_adam=0.01, lr_gamma=0.01, iterations1=2000,
                          iterations2=5000, iterations3=7500, beta_1=0.9,
                          beta_2=0.999, epsilon=1e-7, messages=500,
                          train_upto_fidelity=-1, checkpoint_path=None,
                          checkpoint_every=0):
        """3-phase training: Adam on the kernels and the reduction inducing
        inputs, then also the fidelity inducing inputs, then Adam + natural
        gradients over the fidelity and the reduction layers' q, with both
        likelihoods frozen throughout. Returns the losses of all three
        phases."""
        self._init_variational()
        loss_fn, batch = self._loss_spec(train_upto_fidelity)
        ckpt_fn = self._checkpoint_fn(checkpoint_path)
        m1, m2, _ = self._phase_masks()
        traces = []
        for steps, mask in ((iterations1, m1), (iterations2, m2)):
            _, losses = training.adam_run(
                loss_fn, self.params, mask, self.generator, steps=steps,
                lr=lr_adam, b1=beta_1, b2=beta_2, eps=epsilon,
                messages=messages, data=batch,
                checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn)
            traces.append(losses)
        _, losses = training.nat_adam_run(
            loss_fn, self.params, m2, get_qs=get_qs, set_qs=set_qs,
            generator=self.generator, steps=iterations3, lr_adam=lr_adam,
            gamma=lr_gamma, b1=beta_1, b2=beta_2, eps=epsilon,
            messages=messages, data=batch,
            checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn)
        traces.append(losses)
        return torch.cat(traces)

    def optimize_adam(self, lr=0.01, iterations1=2000, iterations2=5000,
                      iterations3=7500, beta_1=0.9, beta_2=0.999,
                      epsilon=1e-7, messages=500, train_upto_fidelity=-1,
                      checkpoint_path=None, checkpoint_every=0):
        """3-phase plain Adam; phase 3 also trains the fidelity layers' q
        and the model likelihood. Returns the losses of all three
        phases."""
        self._init_variational(q_scale_fid=1e-2, q_scale_red=1e-2)
        loss_fn, batch = self._loss_spec(train_upto_fidelity)
        ckpt_fn = self._checkpoint_fn(checkpoint_path)
        traces = []
        for steps, mask in zip((iterations1, iterations2, iterations3),
                               self._phase_masks()):
            _, losses = training.adam_run(
                loss_fn, self.params, mask, self.generator, steps=steps,
                lr=lr, b1=beta_1, b2=beta_2, eps=epsilon, messages=messages,
                data=batch, checkpoint_every=checkpoint_every,
                checkpoint_fn=ckpt_fn)
            traces.append(losses)
        return torch.cat(traces)

    @staticmethod
    def _make_inducing_points(X: List, Y: List) -> List:
        return [np.asarray(x).copy() for x in X]
