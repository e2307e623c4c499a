"""Multi-fidelity deep GP (Cutajar et al. style, Hebbal improvements),
counterpart of ``dgp_tpu/models/mf_dgp.py``.

One SVGP layer per fidelity; layer i's input is [x, f_{i-1}(x)]; layers
i >= 1 carry *augmented inducing points* Z_i = [Z_left, Z_right]: Z_left is
trainable and Z_right is recomputed inside every loss, request and KL by
propagating Z_left through the earlier layers with a 50-sample mean, so
gradients reach Z_left through the concat and through the propagation.

Composite per-fidelity kernel: k_corr * (k_prev + Linear) + k_in, plus
White on every layer but the last, whose variance doubles as that
fidelity's likelihood noise.

As in the JAX package, each recomputation applies each earlier layer once
(the TF reference applies layer 0 twice for the first fidelity; the second
application only resamples the same distribution).

Random numbers: the JAX package draws through key splits; here every
function takes a ``torch.Generator`` and, in its place, an optional
``noise``: an iterable of fixed unit normals consumed in the order the JAX
functions draw theirs (:func:`elbo`: first :func:`compute_full_zs`, for each
fidelity i >= 1 one [num_samples, M_i, D] draw per earlier layer; then, per
fidelity trained, one [S, N_f, D] draw per layer up to that fidelity).
Products run as IEEE fp32 (``config.ieee_fp32``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

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
from ..ops.transforms import positive_inverse
from . import training
from .dgp import (
    DGPParams,
    _like,
    get_qs,
    moment_matched,
    set_qs,
    weighted_data_term,
)

class MFDGPParams(DGPParams):
    """The layers (layer 0 plain, the others augmented) and the
    highest-fidelity likelihood."""


def _source(noise):
    return None if noise is None else iter(noise)


def _draw(noise, like):
    """The next fixed unit normals of ``noise`` as a tensor like ``like``,
    or None (the layer then draws from the generator)."""
    if noise is None:
        return None
    return torch.as_tensor(next(noise), dtype=like.dtype, device=like.device)


# -- augmented inducing points ------------------------------------------------


def z_right(layers: Sequence, zs_full: Sequence, points, generator=None,
            num_samples=50, pad_cols: int = 0, noise=None):
    """Propagate ``points`` through ``layers`` (with their effective inducing
    inputs ``zs_full``) as a mean of reparameterized samples: the augmented
    coordinate.

    :param pad_cols: zero columns appended to the first chain input (the
        multi-output model's layer 0 takes [x, f]-shaped inputs).
    """
    noise = _source(noise)
    zr = None
    for j, (layer, zf) in enumerate(zip(layers, zs_full)):
        if j == 0:
            inp = points
            if pad_cols:
                inp = torch.cat([points, points.new_zeros(
                    (points.shape[0], pad_cols))], dim=1)
        else:
            inp = torch.cat([points, zr], dim=1)
        zr = mean_propagated_sample(layer, zf, inp, generator, num_samples,
                                    z=_draw(noise, points))
    return zr


def compute_full_zs(layers: Sequence, generator=None, num_samples=50,
                    pad_cols: int = 0, noise=None):
    """Effective per-layer inducing inputs, recomputed at each evaluation."""
    noise = _source(noise)
    zs = [layers[0].z]
    for i in range(1, len(layers)):
        zr = z_right(layers[:i], zs[:i], layers[i].z_left, generator,
                     num_samples, pad_cols=pad_cols, noise=noise)
        zs.append(torch.cat([layers[i].z_left, zr], dim=1))
    return zs


# -- model math ---------------------------------------------------------------


@ieee_fp32()
def propagate(params: MFDGPParams, X, S: int, generator=None, zs_full=None,
              upto: Optional[int] = None, full_cov=False, noise=None,
              projs=None):
    """Layer 0 on x; layer i on [x, F_{i-1}].

    :param zs_full: the layers' effective inducing inputs; recomputed
        (:func:`compute_full_zs`, drawing first) where not given.
    :param upto: propagate only fidelities 0..upto (inclusive); None = all.
    :param projs: the first layers' projections (stack_projections over
        ``zs_full``), where the caller has them already.
    :return: (Fs, Fmeans, Fvars) tuples of per-layer [S, N, D] tensors.
    """
    X = _like(params, X)
    noise = _source(noise)
    if zs_full is None:
        zs_full = compute_full_zs(params.layers, generator, noise=noise)
    n_layers = len(params.layers) if upto is None else upto + 1
    if projs is None:
        projs = stack_projections(params.layers[:n_layers],
                                  zs_full[:n_layers])
    sX = X[None].expand(S, *X.shape)
    F = sX
    Fs, Fmeans, Fvars = [], [], []
    for i in range(n_layers):
        inp = sX if i == 0 else torch.cat([sX, F], dim=2)
        F, Fmean, Fvar = sample_from_conditional(
            params.layers[i], zs_full[i], inp, generator, full_cov=full_cov,
            z=_draw(noise, X), proj=projs[i])
        Fs.append(F)
        Fmeans.append(Fmean)
        Fvars.append(Fvar)
    return tuple(Fs), tuple(Fmeans), tuple(Fvars)


def predict_f(params: MFDGPParams, X, S: int, generator=None,
              fidelity: Optional[int] = None, full_cov=False, noise=None):
    upto = fidelity if fidelity is not None and fidelity >= 0 else None
    _, Fmeans, Fvars = propagate(params, X, S, generator, upto=upto,
                                 full_cov=full_cov, noise=noise)
    idx = -1 if fidelity is None else fidelity
    return Fmeans[idx], Fvars[idx]


def _white_variance(layer):
    """Inner-fidelity likelihood noise: the trailing White kernel's
    variance."""
    return layer.kernel.kernels[-1].variance


@torch.no_grad()
def set_variance(likelihood: Gaussian, variance: float):
    """Set a Gaussian likelihood's variance in place."""
    likelihood.variance_raw.copy_(positive_inverse(torch.as_tensor(
        variance, dtype=likelihood.variance_raw.dtype)))


@ieee_fp32()
def elbo(params: MFDGPParams, Xs, Ys, num_samples: int, generator=None,
         train_upto_fidelity: int = -1, row_weights=None, num_data=None,
         noise=None, data_term=None):
    """Sum of per-fidelity data terms (the model likelihood on the last
    layer, the White-kernel Gaussian on inner layers) minus the per-layer
    KLs. The augmented inducing inputs are recomputed first; each layer's
    Kuu is then factored once (the projections, whose Lu the KL takes too).

    :param train_upto_fidelity: data terms and KLs of fidelities 0..k only;
        -1 = all.
    :param row_weights: optional per-fidelity 0/1 row weights (or None
        entries) marking shape padding.
    :param num_data: optional per-fidelity full-dataset sizes; each
        fidelity's data term is then scaled by N_f / batch_f.
    :param data_term: ``(var_exp, row_weights) -> (row sum, row count)``
        (``dgp.weighted_data_term`` by default; a sharded loss sums both
        over the ranks).
    """
    data_term = data_term or weighted_data_term
    noise = _source(noise)
    zs_full = compute_full_zs(params.layers, generator, noise=noise)
    n_layers = len(params.layers)
    used = (n_layers if train_upto_fidelity == -1
            else min(train_upto_fidelity + 1, n_layers))
    projs = stack_projections(params.layers[:used], zs_full[:used])
    L = 0.0
    KL = 0.0
    for fidelity in range(used):
        Y = _like(params, Ys[fidelity])
        _, Fmeans, Fvars = propagate(
            params, Xs[fidelity], num_samples, generator, zs_full=zs_full,
            upto=fidelity, noise=noise, projs=projs)
        Fmean, Fvar = Fmeans[fidelity], Fvars[fidelity]
        if fidelity == n_layers - 1:
            var_exp = params.likelihood.variational_expectations(Fmean, Fvar, Y)
        else:
            var_exp = fidelity_variational_expectations(
                Fmean, Fvar, Y, _white_variance(params.layers[fidelity]))
        w = None if row_weights is None else row_weights[fidelity]
        term, eff = data_term(var_exp, w)
        scale = 1.0 if num_data is None else num_data[fidelity] / eff
        L = L + term * scale
        KL = KL + layer_kl(params.layers[fidelity], zs_full[fidelity],
                           projs[fidelity].Lu)
    return L - KL


def predict_y(params: MFDGPParams, X, S: int, generator=None, full_cov=False,
              noise=None):
    Fmean, Fvar = predict_f(params, X, S, generator, full_cov=full_cov,
                            noise=noise)
    return params.likelihood.predict_mean_and_var(Fmean, Fvar)


def predict_density(params: MFDGPParams, X, Y, S: int, generator=None,
                    noise=None):
    """log E_S[p(y|f)] at the highest fidelity, a logsumexp over samples."""
    Y = _like(params, Y)
    Fmean, Fvar = predict_f(params, X, S, generator, noise=noise)
    log_p = params.likelihood.predict_density(Fmean, Fvar, Y)
    return torch.logsumexp(log_p - math.log(S), dim=0)


# -- loss factories -----------------------------------------------------------


def full_batch_loss(num_samples: int, train_upto: int = -1):
    """-ELBO over the full (possibly row-padded) batch; batch = (Xs, Ys,
    row_weights, num_data), the last two None for a plain full batch."""

    def loss(params, generator, batch):
        Xs, Ys, ws, nd = batch
        return -elbo(params, Xs, Ys, num_samples, generator,
                     train_upto_fidelity=train_upto, row_weights=ws,
                     num_data=nd)

    return loss


def minibatch_loss(num_samples: int, batch_sizes: tuple, train_upto: int = -1):
    """-ELBO over per-fidelity uniform random minibatches drawn from the
    generator, each fidelity's data term scaled by N_f / B_f; batch = (Xs,
    Ys, n_trues). Padded rows (if any) sit past n_true and are never
    sampled."""

    def loss(params, generator, batch):
        Xs, Ys, n_trues = batch
        Xb, Yb = [], []
        for f, B in enumerate(batch_sizes):
            idx = torch.randint(0, n_trues[f], (B,), generator=generator,
                                device=Xs[f].device)
            Xb.append(Xs[f][idx])
            Yb.append(Ys[f][idx])
        return -elbo(params, Xb, Yb, num_samples, generator,
                     train_upto_fidelity=train_upto, num_data=n_trues)

    return loss


# -- construction -------------------------------------------------------------


def coupled_kernel(Din: int, add_linear=True, dtype=None, device=None):
    """k_corr * (k_prev + Linear) + k_in on [x, f]: RBFs on x's Din
    columns (k_corr, k_in) and on the previous output's column Din
    (k_prev, Linear); without ``add_linear``, k_corr * k_prev + k_in."""
    f = dict(dtype=dtype, device=device)
    d_in = tuple(range(Din))
    d_prev = (Din,)
    k_corr = K.RBF.create(variance=1.0, active_dims=d_in, **f)
    k_prev = K.RBF.create(variance=1.0, active_dims=d_prev, **f)
    k_in = K.RBF.create(variance=1.0, active_dims=d_in, **f)
    if add_linear:
        return k_corr * (k_prev + K.Linear.create(
            variance=1.0, active_dims=d_prev, **f)) + k_in
    return k_corr * k_prev + k_in


def with_white(kernels, variance=1e-6, dtype=None, device=None):
    """White(variance) added to every kernel but the last (the inner
    layers' likelihood noise)."""
    return [kern + K.White.create(variance=variance, dtype=dtype,
                                  device=device)
            if i < len(kernels) - 1 else kern
            for i, kern in enumerate(kernels)]


def make_mf_kernels(Din: int, n_fidelities: int, add_linear=True, dtype=None,
                    device=None):
    """The multi-fidelity composite kernel stack: an ARD RBF on x for
    fidelity 0, the coupled kernel for the others, White on all but the
    last."""
    f = dict(dtype=dtype, device=device)
    kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * Din,
                            active_dims=list(range(Din)), **f)]
    kernels += [coupled_kernel(Din, add_linear, **f)
                for _ in range(1, n_fidelities)]
    return with_white(kernels, **f)


@ieee_fp32()
@torch.no_grad()
def init_layers_mf(Z: List, kernels, num_outputs=1, generator=None,
                   num_samples=100, pad_cols: int = 0, noise=None, dtype=None,
                   device=None):
    """Layer list with augmented inducing variables for i >= 1: layer i's
    initial q_sqrt is the factor of Kuu at its full initial inducing inputs
    [Z_i, z_right(Z_i)] (kernel #7 where it applies).

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
    layers = [make_svgp_layer(kernels[0], as_tensor(Z[0]), num_outputs,
                              dtype=dtype, device=device)]
    zs_full = [layers[0].z]
    for i in range(1, len(Z)):
        zl = as_tensor(Z[i])
        zr = z_right(layers[:i], zs_full[:i], zl, generator, num_samples,
                     pad_cols=pad_cols, noise=noise)
        z_full = torch.cat([zl, zr], dim=1)
        layers.append(make_svgp_layer(kernels[i], zl, num_outputs,
                                      augmented=True, Z_full_init=z_full,
                                      dtype=dtype, device=device))
        zs_full.append(z_full)
    return layers


@torch.no_grad()
def init_variational(params, Ys, q_sqrt_scale=1e-2):
    """The q init recipe, in place: each layer's q_mu <- its Y where the
    shapes agree (else zeros stay: a custom Z), q_sqrt scaled by
    ``q_sqrt_scale`` times the population variance of that Y; the
    likelihood variance <- var(Y_last) * 1e-2."""
    for layer, y in zip(params.layers, Ys):
        if layer.q_mu.shape == y.shape:
            layer.q_mu.copy_(y)
        layer.q_sqrt.mul_(q_sqrt_scale * torch.var(y, correction=0))
    set_variance(params.likelihood,
                 float(torch.var(Ys[-1], correction=0)) * 1e-2)


def phase_masks(params):
    """Frozen sets per training phase: (1) the kernels alone; (2) and the
    inducing inputs; (3) everything but q (which the natural gradient
    takes)."""
    q = {"q_mu", "q_sqrt"}
    z = {"z", "z_left"}
    lik = {"likelihood"}
    m1 = training.make_mask(params, frozen_fields=lik | z,
                            frozen_layer_fields={"all": q})
    m2 = training.make_mask(params, frozen_fields=lik,
                            frozen_layer_fields={"all": q})
    m3 = training.make_mask(params, frozen_layer_fields={"all": q})
    return m1, m2, m3


# -- stateful wrapper ---------------------------------------------------------


class MultiFidelityDeepGP:
    """Reference-parity wrapper: 3-phase staged training (kernel-only ->
    +inducing -> +q/likelihood with natural gradients), default Z = the
    training inputs, moment-matched prediction over 250 samples.

    :param minibatch_size: per-fidelity minibatch sizes (an int shared by
        all, or a list); each training evaluation then draws uniform batches
        and scales each data term by N_f / B_f.
    :param n_bucket: pad each fidelity's rows to the next multiple of this
        many with zero-weight rows.
    :param mesh: a 1-D ``DeviceMesh`` (``parallel.mesh.make_mesh``): every
        fidelity's rows then shard over its ranks, one process per rank
        (``parallel.data_parallel.sharded_mf_loss``).
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).
    """

    name = "mf_dgp"

    def __init__(self, X, Y, Z=None, n_iter=5000, fix_inducing=True,
                 num_samples=10, add_linear=True, seed=0,
                 minibatch_size=None, n_bucket=None, mesh=None, device=None,
                 dtype=None):
        device = resolve_device(device)
        dtype = dtype or default_float()
        self.device, self.dtype = device, dtype
        self._X = [self._as_input(np.asarray(x)) for x in X]
        self._Y = [self._as_input(np.asarray(y)) for y in Y]
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
        self.Z = Z
        kernels = make_mf_kernels(np.asarray(X[0]).shape[1], len(X),
                                  add_linear=add_linear, dtype=dtype,
                                  device=device)
        layers = init_layers_mf(Z, kernels, generator=self.generator,
                                dtype=dtype, device=device)
        self.params = MFDGPParams(layers, Gaussian.create(1.0, dtype=dtype,
                                                          device=device))
        self.n_iter = n_iter
        self.fix_inducing = fix_inducing
        self.mesh = training.on_mesh(self, mesh)

    def _as_input(self, X):
        return torch.as_tensor(X, dtype=self.dtype, device=self.device)

    def _loss_spec(self, train_upto: int = -1):
        """(loss_fn, batch) for the training loops. With ``minibatch_size``:
        per-fidelity uniform batches and the N_f / B_f scale. With
        ``n_bucket``: rows padded per fidelity with 0/1 weights. With
        ``mesh``: this rank's blocks of every fidelity's rows, padded to a
        multiple of the ranks (and of ``n_bucket``)."""
        Xs, Ys = list(self._X), list(self._Y)
        if self.mesh is not None:
            from ..parallel import data_parallel as dp

            batch = dp.pad_shard_fidelity_batch(self.mesh, Xs, Ys,
                                                self.n_bucket)
            if self.minibatch_size is not None:
                sizes = tuple(min(int(b), x.shape[0])
                              for b, x in zip(self.minibatch_size, Xs))
                return (dp.sharded_mf_minibatch_loss(
                    self.mesh, self.num_samples, sizes, train_upto), batch)
            return (dp.sharded_mf_loss(self.mesh, self.num_samples,
                                       train_upto), batch)
        if self.minibatch_size is not None:
            sizes = tuple(min(int(b), x.shape[0])
                          for b, x in zip(self.minibatch_size, Xs))
            n_trues = tuple(x.shape[0] for x in Xs)
            if self.n_bucket:
                padded = [training.pad_to_bucket(x, y, self.n_bucket)
                          for x, y in zip(Xs, Ys)]
                Xs = [p[0] for p in padded]
                Ys = [p[1] for p in padded]
            return (minibatch_loss(self.num_samples, sizes, train_upto),
                    (tuple(Xs), tuple(Ys), n_trues))
        if self.n_bucket:
            ws, nd = [], []
            for f in range(len(Xs)):
                Xs[f], Ys[f], w = training.pad_to_bucket(Xs[f], Ys[f],
                                                         self.n_bucket)
                ws.append(w)
                nd.append(self._X[f].shape[0])
            return (full_batch_loss(self.num_samples, train_upto),
                    (tuple(Xs), tuple(Ys), tuple(ws), tuple(nd)))
        return (full_batch_loss(self.num_samples, train_upto),
                (tuple(Xs), tuple(Ys), None, None))

    # -- reference API --------------------------------------------------------
    @torch.no_grad()
    def objective(self):
        return elbo(self.params, self._X, self._Y, self.num_samples,
                    self.generator)

    ELBO = objective

    @torch.no_grad()
    def propagate(self, X, full_cov=False, S=1):
        return propagate(self.params, self._as_input(X), S, self.generator,
                         full_cov=full_cov)

    def predict_all_layers(self, Xnew, num_samples):
        """Every layer's samples, means and variances."""
        return self.propagate(Xnew, full_cov=False, S=num_samples)

    @torch.no_grad()
    def predict_f(self, X, full_cov=False, S=1, fidelity=None):
        return predict_f(self.params, self._as_input(X), S, self.generator,
                         fidelity=fidelity, full_cov=full_cov)

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
            self, lambda m: serving.sharded_predict_y_mf(m, num_samples),
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
    def _init_variational(self, q_sqrt_scale=1e-2):
        """q init recipe: q_mu <- Y_f where the shapes agree, q_sqrt scaled
        by the population variance of Y_f; likelihood variance <-
        var(Y_last) * 1e-2."""
        init_variational(self.params, self._Y, q_sqrt_scale)

    def _phase_masks(self):
        return phase_masks(self.params)

    def _checkpoint_fn(self, checkpoint_path):
        return training.checkpoint_fn_of(self, checkpoint_path)

    def optimize_adam(self, lr=0.01, iterations1=2000, iterations2=5000,
                      iterations3=7500, beta_1=0.9, beta_2=0.999,
                      epsilon=1e-7, messages=500, q_sqrt_scale=1e-2,
                      train_upto_fidelity=-1, checkpoint_path=None,
                      checkpoint_every=0):
        """3-phase Adam; phase 3 trains everything but the mean functions
        (q and the likelihood by Adam, not by natural gradients). Returns
        the losses of all three phases.

        :param train_upto_fidelity: restrict the ELBO to fidelities 0..k;
            -1 = all.
        """
        self._init_variational(q_sqrt_scale)
        loss_fn, batch = self._loss_spec(train_upto_fidelity)
        ckpt_fn = self._checkpoint_fn(checkpoint_path)
        m1, m2, _ = self._phase_masks()
        m3 = training.make_mask(self.params)
        traces = []
        for steps, mask in ((iterations1, m1), (iterations2, m2),
                            (iterations3, m3)):
            _, losses = training.adam_run(
                loss_fn, self.params, mask, self.generator, steps=steps,
                lr=lr, b1=beta_1, b2=beta_2, eps=epsilon, messages=messages,
                data=batch, checkpoint_every=checkpoint_every,
                checkpoint_fn=ckpt_fn)
            traces.append(losses)
        return torch.cat(traces)

    def optimize_nat_adam(self, lr_adam=0.01, lr_gamma=0.01, iterations1=2000,
                          iterations2=5000, iterations3=7500, beta_1=0.9,
                          beta_2=0.999, epsilon=1e-7, messages=500,
                          q_sqrt_scale=1e-2, train_upto_fidelity=-1,
                          checkpoint_path=None, checkpoint_every=0):
        """3-phase Adam -> +inducing -> Adam + natural gradients on every
        layer's q. Returns the losses of all three phases.

        :param train_upto_fidelity: restrict the ELBO to fidelities 0..k;
            -1 = all.
        """
        self._init_variational(q_sqrt_scale)
        loss_fn, batch = self._loss_spec(train_upto_fidelity)
        ckpt_fn = self._checkpoint_fn(checkpoint_path)
        m1, m2, m3 = self._phase_masks()
        traces = []
        for steps, mask in ((iterations1, m1), (iterations2, m2)):
            _, losses = training.adam_run(
                loss_fn, self.params, mask, self.generator, steps=steps,
                lr=lr_adam, b1=beta_1, b2=beta_2, eps=epsilon,
                messages=messages, data=batch,
                checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn)
            traces.append(losses)
        # phase 3: the likelihood unfrozen; natural gradients on every q
        sel = tuple(range(len(self.params.layers)))
        _, losses = training.nat_adam_run(
            loss_fn, self.params, m3,
            get_qs=lambda p: get_qs(p, sel),
            set_qs=lambda p, qs: set_qs(p, sel, qs),
            generator=self.generator, steps=iterations3, lr_adam=lr_adam,
            gamma=lr_gamma, b1=beta_1, b2=beta_2, eps=epsilon,
            messages=messages, data=batch,
            checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn)
        traces.append(losses)
        return torch.cat(traces)

    @staticmethod
    def _make_inducing_points(X: List, Y: List) -> List:
        return [np.asarray(x).copy() for x in X]
