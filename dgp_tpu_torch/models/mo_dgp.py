"""Multi-objective deep GP, counterpart of ``dgp_tpu/models/mo_dgp.py``.

Each of the two objectives is one SVGP layer, and the layers are coupled
by a recurrent alternation: the chain is seeded with a random normal
column F0 (one [N, 1] draw per data point, shared by all S sample paths),
layer 0 is applied to [x, F], then layers 1, 0, 1, 0, ... alternate for
2·loop steps (with loop = 0, layer 1 once), and a final application of
layer 1 follows. The outputs before and after that last application are
objectives 0 and 1. Every layer, layer 0 included, takes the coupled
kernel on [x, f] (``mf_dgp.coupled_kernel``), and every layer but the last
also a White kernel, whose variance is that objective's likelihood noise.
Layer 1 carries augmented inducing points as the multi-fidelity layers do:
Z_right is layer 0 at [Z_left, 0] (``pad_cols=1``), a mean of 50 samples,
recomputed in every loss, request and KL. Each such set of inducing
inputs has its Kuu stack factored once (``stack_projections``).

Random numbers as in ``mf_dgp``: every function takes a ``torch.Generator``
and, in its place, an optional ``noise``: fixed unit normals consumed in
the order the JAX functions draw theirs. :func:`propagate` draws its own
Z_right ([50, M_1, 1], :func:`mf_dgp.compute_full_zs`), then the seed
column [N, 1], then one [S, N, 1] per conditional: 2·loop + 2 of them
(3 with loop = 0). :func:`elbo` draws its own Z_right first (the KL's
inducing inputs), then, per objective trained, one :func:`propagate`'s
draws. Products run as IEEE fp32 (``config.ieee_fp32``).
"""

from __future__ import annotations

import copy
import hashlib
import math
from typing import List, Optional

import numpy as np
import torch

from ..config import default_float, ieee_fp32, resolve_device
from ..layers.svgp import layer_kl, sample_from_conditional, stack_projections
from ..ops.likelihoods import Gaussian, fidelity_variational_expectations
from ..ops.transforms import positive, positive_inverse
from . import training
from .dgp import (
    DGPParams,
    _like,
    get_qs,
    moment_matched,
    set_qs,
    weighted_data_term,
)
from .mf_dgp import (
    _draw,
    _source,
    _white_variance,
    compute_full_zs,
    coupled_kernel,
    init_layers_mf,
    init_variational,
    phase_masks,
    with_white,
)


class MODGPParams(DGPParams):
    """The objectives' layers (layer 0 plain, the others augmented) and the
    last objective's likelihood."""


def _normals(noise, generator, shape, like):
    """The next fixed unit normals of ``noise``, or a draw of ``shape``
    from ``generator``, as a tensor like ``like``."""
    z = _draw(noise, like)
    if z is None:
        z = torch.randn(shape, generator=generator, dtype=like.dtype,
                        device=like.device)
    return z


@torch.no_grad()
def _jitter_lengthscales(params, generator=None, sigma=0.5, noise=None):
    """A copy of ``params`` whose every kernel lengthscale is multiplied by
    exp(sigma * eps), eps a unit normal per element (one draw per
    ``lengthscales_raw`` tensor, in parameter order); every other tensor is
    copied bit for bit. The restarts' init diversity."""
    noise = _source(noise)
    out = copy.deepcopy(params)
    for name, leaf in out.named_parameters():
        if name.split(".")[-1] == "lengthscales_raw":
            eps = _normals(noise, generator, leaf.shape, leaf)
            leaf.copy_(positive_inverse(positive(leaf) * torch.exp(sigma * eps)))
    return out


def _stream_key(generator) -> int:
    """An int naming the generator's current position (its state, hashed):
    the counterpart of the JAX package's current key, from which the
    restarts' streams derive (``bo.acquisition.fold_in``)."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_mo_kernels(Din: int, n_objectives: int, add_linear=True, dtype=None,
                    white_variance=1e-6, device=None):
    """The coupled kernel on [x, f] for every layer (layer 0 included),
    White(white_variance) on all but the last.

    :param white_variance: init of the inner objective's noise. The
        reference's 1e-6 makes the inner data term very stiff (the initial
        ELBO sits near -1.7e8), but a looser init destabilizes the coupled
        recursion, so the default stays the reference's.
    """
    f = dict(dtype=dtype, device=device)
    return with_white([coupled_kernel(Din, add_linear, **f)
                       for _ in range(n_objectives)], white_variance, **f)


# -- model math ---------------------------------------------------------------


def _alternation(loop: int):
    """The layers applied in turn before the final layer 1: 0, then 1 (loop
    = 0) or 1, 0, 1, 0, ... for 2·loop steps."""
    return [0] + ([1] if loop == 0 else [(j + 1) % 2 for j in range(2 * loop)])


@ieee_fp32()
def propagate(params: MODGPParams, X, S: int, generator=None, loop: int = 2,
              full_cov=False, noise=None):
    """The recurrent alternation. Recomputes its own Z_right (drawing
    first) and factors the layers' Kuu stack once at it.

    :return: (Fs, Fmeans, Fvars): exactly two [S, N, D] entries each,
        objective 0 then objective 1.
    """
    X = _like(params, X)
    noise = _source(noise)
    zs_full = compute_full_zs(params.layers, generator, pad_cols=1,
                              noise=noise)
    projs = stack_projections(params.layers, zs_full)
    sX = X[None].expand(S, *X.shape)
    F0 = _normals(noise, generator, (X.shape[0], 1), X)
    F = F0[None].expand(S, *F0.shape)
    out = []
    for i in _alternation(loop) + [1]:
        F, Fmean, Fvar = sample_from_conditional(
            params.layers[i], zs_full[i], torch.cat([sX, F], dim=2),
            generator, full_cov=full_cov, z=_draw(noise, X), proj=projs[i])
        out.append((F, Fmean, Fvar))
    # objective 0 is the alternation's output, objective 1 the final layer 1's
    return tuple(zip(*out[-2:]))


def predict_f(params: MODGPParams, X, S: int, generator=None,
              objective: Optional[int] = None, loop: int = 2, full_cov=False,
              noise=None):
    """(mean, variance) of objective ``objective`` (the last by default)."""
    _, Fmeans, Fvars = propagate(params, X, S, generator, loop=loop,
                                 full_cov=full_cov, noise=noise)
    idx = -1 if objective is None else objective
    return Fmeans[idx], Fvars[idx]


def predict_y(params: MODGPParams, X, S: int, generator=None, loop: int = 2,
              full_cov=False, noise=None):
    Fmean, Fvar = predict_f(params, X, S, generator, loop=loop,
                            full_cov=full_cov, noise=noise)
    return params.likelihood.predict_mean_and_var(Fmean, Fvar)


def predict_density(params: MODGPParams, X, Y, S: int, generator=None,
                    loop: int = 2, noise=None):
    """log E_S[p(y|f)] of the last objective, a logsumexp over samples."""
    Y = _like(params, Y)
    Fmean, Fvar = predict_f(params, X, S, generator, loop=loop, noise=noise)
    log_p = params.likelihood.predict_density(Fmean, Fvar, Y)
    return torch.logsumexp(log_p - math.log(S), dim=0)


@ieee_fp32()
def elbo(params: MODGPParams, Xs, Ys, num_samples: int, generator=None,
         loop: int = 2, train_upto_objective: int = -1, row_weights=None,
         num_data=None, noise=None, data_term=None):
    """Per-objective data terms (the model likelihood on the last
    objective, the White-kernel Gaussian on the others) minus the per-layer
    KLs. The KLs take inducing inputs recomputed first, their Kuu stack
    factored once; each objective's data term takes one :func:`propagate`
    of its own inputs.

    :param train_upto_objective: data terms and KLs of objectives 0..k
        only; -1 = all.
    :param row_weights: optional per-objective 0/1 row weights (or None
        entries) marking shape padding.
    :param num_data: optional per-objective full-dataset sizes; each data
        term is then scaled by N_f / batch_f.
    :param data_term: ``(var_exp, row_weights) -> (row sum, row count)``
        (``dgp.weighted_data_term`` by default; a sharded loss sums both
        over the ranks).
    """
    data_term = data_term or weighted_data_term
    noise = _source(noise)
    zs_full = compute_full_zs(params.layers, generator, pad_cols=1,
                              noise=noise)
    n_layers = len(params.layers)
    used = (n_layers if train_upto_objective == -1
            else min(train_upto_objective + 1, n_layers))
    projs = stack_projections(params.layers[:used], zs_full[:used])
    L = 0.0
    KL = 0.0
    for objective in range(used):
        Y = _like(params, Ys[objective])
        _, Fmeans, Fvars = propagate(params, Xs[objective], num_samples,
                                     generator, loop=loop, noise=noise)
        Fmean, Fvar = Fmeans[objective], Fvars[objective]
        if objective == n_layers - 1:
            var_exp = params.likelihood.variational_expectations(Fmean, Fvar, Y)
        else:
            var_exp = fidelity_variational_expectations(
                Fmean, Fvar, Y, _white_variance(params.layers[objective]))
        w = None if row_weights is None else row_weights[objective]
        term, eff = data_term(var_exp, w)
        scale = 1.0 if num_data is None else num_data[objective] / eff
        L = L + term * scale
        KL = KL + layer_kl(params.layers[objective], zs_full[objective],
                           projs[objective].Lu)
    return L - KL


# -- loss factories -----------------------------------------------------------


def full_batch_loss(num_samples: int, loop: int, train_upto: int = -1):
    """-ELBO over the full (possibly row-padded) batch; batch = (Xs, Ys,
    row_weights, num_data), the last two None for a plain full batch."""

    def loss(params, generator, batch):
        Xs, Ys, ws, nd = batch
        return -elbo(params, Xs, Ys, num_samples, generator, loop=loop,
                     train_upto_objective=train_upto, row_weights=ws,
                     num_data=nd)

    return loss


def minibatch_loss(num_samples: int, loop: int, batch_sizes: tuple,
                   train_upto: int = -1):
    """-ELBO over per-objective uniform random minibatches drawn from the
    generator, each data term scaled by N_f / B_f; batch = (Xs, Ys,
    n_trues)."""

    def loss(params, generator, batch):
        Xs, Ys, n_trues = batch
        Xb, Yb = [], []
        for f, B in enumerate(batch_sizes):
            idx = torch.randint(0, n_trues[f], (B,), generator=generator,
                                device=Xs[f].device)
            Xb.append(Xs[f][idx])
            Yb.append(Ys[f][idx])
        return -elbo(params, Xb, Yb, num_samples, generator, loop=loop,
                     train_upto_objective=train_upto, num_data=n_trues)

    return loss


# -- stateful wrapper ---------------------------------------------------------


class MultiObjDeepGP:
    """Reference-parity wrapper: default inducing points Z[0] = [X_0, Y_1]
    and Z[1] = X_1; 3-phase staged training (kernel-only -> +inducing ->
    +q/likelihood, q by natural gradients under the loss guard) with
    best-of-k restarts; moment-matched prediction over 250 samples.

    :param loop: the alternation's length (see the module docstring).
    :param white_variance: init of the inner objective's noise.
    :param minibatch_size: per-objective minibatch sizes (an int shared by
        all, or a list); each training evaluation then draws uniform
        batches and scales each data term by N_f / B_f.
    :param n_bucket: pad each objective's rows to the next multiple of this
        many with zero-weight rows.
    :param mesh: a 1-D ``DeviceMesh`` (``parallel.mesh.make_mesh``): every
        objective's rows then shard over its ranks, one process per rank
        (``parallel.data_parallel.sharded_mo_loss``); the restarts' streams
        and scores are the same on every rank.
    :param device: where the model lives and runs; the card unless given.
        With no card and no ``device``, construction raises.
    :param dtype: working dtype (default ``config.default_float()``).
    """

    name = "mo_dgp"

    def __init__(self, X, Y, Z=None, n_iter=5000, loop=2, fix_inducing=True,
                 num_samples=10, white_variance=1e-6, seed=0,
                 minibatch_size=None, n_bucket=None, mesh=None, device=None,
                 dtype=None):
        device = resolve_device(device)
        dtype = dtype or default_float()
        self.device, self.dtype = device, dtype
        self._X = [self._as_input(np.asarray(x)) for x in X]
        self._Y = [self._as_input(np.asarray(y)) for y in Y]
        self.loop = loop
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
        kernels = make_mo_kernels(np.asarray(X[0]).shape[1], len(X),
                                  dtype=dtype, white_variance=white_variance,
                                  device=device)
        layers = init_layers_mf(Z, kernels, generator=self.generator,
                                pad_cols=1, dtype=dtype, device=device)
        self.params = MODGPParams(layers, Gaussian.create(1.0, dtype=dtype,
                                                          device=device))
        self.n_fidelities = len(X)
        self.n_iter = n_iter
        self.fix_inducing = fix_inducing
        # the multi-objective acquisition (EHVI) reads .model.propagate
        self.model = self
        self.mesh = training.on_mesh(self, mesh)

    def _as_input(self, X):
        return torch.as_tensor(X, dtype=self.dtype, device=self.device)

    def _loss_spec(self, train_upto: int = -1):
        """(loss_fn, batch) for the training loops. With ``minibatch_size``:
        per-objective uniform batches and the N_f / B_f scale. With
        ``n_bucket``: rows padded per objective with 0/1 weights. With
        ``mesh``: this rank's blocks of every objective's rows, padded to a
        multiple of the ranks (and of ``n_bucket``)."""
        Xs, Ys = list(self._X), list(self._Y)
        if self.mesh is not None:
            from ..parallel import data_parallel as dp

            batch = dp.pad_shard_fidelity_batch(self.mesh, Xs, Ys,
                                                self.n_bucket)
            if self.minibatch_size is not None:
                sizes = tuple(min(int(b), x.shape[0])
                              for b, x in zip(self.minibatch_size, Xs))
                return (dp.sharded_mo_minibatch_loss(
                    self.mesh, self.num_samples, self.loop, sizes,
                    train_upto), batch)
            return (dp.sharded_mo_loss(self.mesh, self.num_samples,
                                       self.loop, train_upto), batch)
        if self.minibatch_size is not None:
            sizes = tuple(min(int(b), x.shape[0])
                          for b, x in zip(self.minibatch_size, Xs))
            n_trues = tuple(x.shape[0] for x in Xs)
            return (minibatch_loss(self.num_samples, self.loop, sizes,
                                   train_upto),
                    (tuple(Xs), tuple(Ys), n_trues))
        if self.n_bucket:
            ws, nd = [], []
            for f in range(len(Xs)):
                Xs[f], Ys[f], w = training.pad_to_bucket(Xs[f], Ys[f],
                                                         self.n_bucket)
                ws.append(w)
                nd.append(self._X[f].shape[0])
            return (full_batch_loss(self.num_samples, self.loop, train_upto),
                    (tuple(Xs), tuple(Ys), tuple(ws), tuple(nd)))
        return (full_batch_loss(self.num_samples, self.loop, train_upto),
                (tuple(Xs), tuple(Ys), None, None))

    # -- reference API --------------------------------------------------------
    @torch.no_grad()
    def objective(self):
        return elbo(self.params, self._X, self._Y, self.num_samples,
                    self.generator, loop=self.loop)

    ELBO = objective

    @torch.no_grad()
    def propagate(self, X, full_cov=False, S=1):
        return propagate(self.params, self._as_input(X), S, self.generator,
                         loop=self.loop, full_cov=full_cov)

    def predict_all_layers(self, Xnew, num_samples):
        """Both objectives' samples, means and variances."""
        return self.propagate(Xnew, full_cov=False, S=num_samples)

    @torch.no_grad()
    def predict_f(self, X, full_cov=False, S=1, objective=None):
        return predict_f(self.params, self._as_input(X), S, self.generator,
                         objective=objective, loop=self.loop,
                         full_cov=full_cov)

    @torch.no_grad()
    def predict_y(self, Xnew, num_samples, full_cov=False):
        return predict_y(self.params, self._as_input(Xnew), num_samples,
                         self.generator, loop=self.loop, full_cov=full_cov)

    def predict_y_sharded(self, Xnew, num_samples, mesh=None,
                          chunk_size=None):
        """Data-parallel batch inference of the last objective (see
        ``DGP.predict_y_sharded``)."""
        from ..parallel import serving

        return serving.predict_y_sharded(
            self, lambda m: serving.sharded_predict_y_mo(m, num_samples,
                                                         self.loop),
            Xnew, mesh, chunk_size)

    @torch.no_grad()
    def predict_density(self, Xnew, Ynew, num_samples):
        """log E_S[p(y|f)] of the last objective via logsumexp over
        samples."""
        return predict_density(self.params, self._as_input(Xnew),
                               self._as_input(np.asarray(Ynew)), num_samples,
                               self.generator, loop=self.loop)

    def predict(self, X_test, full_cov=False):
        """The last objective, moment-matched over 250 samples."""
        y_m, y_v = self.predict_y(X_test, 250, full_cov=full_cov)
        mean, var = moment_matched(y_m, y_v)
        return (mean.cpu().numpy().reshape(-1, 1),
                var.cpu().numpy().reshape(-1, 1))

    # -- staged training ------------------------------------------------------
    def _init_variational(self, q_sqrt_scale=1e-2):
        """q_mu <- Y_i where the shapes agree, q_sqrt scaled by
        q_sqrt_scale * var(Y_i); likelihood variance <- var(Y_last) *
        1e-2 (``mf_dgp.init_variational``)."""
        init_variational(self.params, self._Y, q_sqrt_scale)

    def _phase_masks(self):
        return phase_masks(self.params)

    def _checkpoint_fn(self, checkpoint_path):
        return training.checkpoint_fn_of(self, checkpoint_path)

    def optimize_nat_adam(self, lr_adam=0.01, lr_gamma=0.01, iterations1=2000,
                          iterations2=5000, iterations3=7500, messages=500,
                          q_sqrt_scale=1e-2, train_upto_objective=-1,
                          checkpoint_path=None, checkpoint_every=0,
                          restarts="auto", restart_select="fit",
                          restart_threshold=0.9, max_restarts=4):
        """3-phase training: Adam on the kernels, then also the inducing
        inputs, then Adam on everything but q with guarded natural
        gradients on every layer's q. Returns the kept run's losses.

        :param train_upto_objective: restrict the ELBO to objectives 0..k;
            -1 = all.
        :param restarts: best-of-k multi-start. The coupled landscape is
            chaotic, and a minority of runs land in poor basins that the
            natural-gradient loss guard cannot rescue. With ``restarts=k >
            1`` the schedule runs k times, and the best candidate's
            parameters and generator state are kept: restart 0 from the
            published init and the generator's own stream (so the single
            run is always a candidate), restart r > 0 from a stream derived
            by ``fold_in`` and with log-normally jittered lengthscales
            (sigma 0.5). ``"auto"`` (the default) runs once, scores the
            fit, and restarts only while the worst per-objective train r2
            is below ``restart_threshold``, up to ``max_restarts`` runs; a
            good first fit gives exactly the ``restarts=1`` result.
        :param restart_select: ``"fit"`` scores by the worst per-objective
            train r2 over 50 samples (moment-matched), ``"elbo"`` by the
            ELBO, both on one evaluation stream shared by every candidate;
            ``"auto"`` always scores by fit.
        """
        from ..bo.acquisition import fold_in

        auto = restarts == "auto"
        n_restarts = int(max_restarts) if auto else int(restarts)
        run = lambda path: self._nat_adam_guarded(
            lr_adam, lr_gamma, iterations1, iterations2, iterations3,
            messages, q_sqrt_scale, train_upto_objective, path,
            checkpoint_every)
        if n_restarts <= 1 and not auto:
            return run(checkpoint_path)
        # restart 0 trains self.params from the generator's own stream
        params0 = copy.deepcopy(self.params)
        key0 = self._shared(_stream_key(self.generator), torch.int64)
        eval_key = fold_in(key0, 0x5E1EC7)
        best = None
        for r in range(n_restarts):
            if r > 0:
                jitter = torch.Generator(device=self.device).manual_seed(
                    fold_in(key0, 0xD1CE + r))
                self.params = _jitter_lengthscales(params0, jitter)
                seed = fold_in(key0, r)
                if self.mesh is not None:
                    from ..parallel.data_parallel import rank_seed

                    seed = rank_seed(self.mesh, seed)
                self.generator.manual_seed(seed)
            losses = run(None if checkpoint_path is None
                         else f"{checkpoint_path}.r{r}")
            score = self._shared(self._restart_score(
                "fit" if auto else restart_select, eval_key))
            if messages:
                print(f"restart {r}: score={score:.4f}")
            # a non-finite score never wins, and a finite one beats a
            # non-finite best
            better = best is None or (
                math.isfinite(score)
                and (not math.isfinite(best[0]) or score > best[0]))
            if better:
                best = (score, self.params, self.generator.get_state(), losses)
            if auto and math.isfinite(score) and score >= restart_threshold:
                break
        _, self.params, state, losses = best
        self.generator.set_state(state)
        save = self._checkpoint_fn(checkpoint_path)
        if save is not None:
            save(self.params, -1)
        return losses

    def _shared(self, value, dtype=torch.float64):
        """``value`` as the mesh's first rank has it (on one device,
        ``value``): the restarts' key and scores, so that every rank takes
        the same decisions (``parallel.data_parallel.from_first_rank``)."""
        if self.mesh is None:
            return value
        from ..parallel.data_parallel import from_first_rank

        return from_first_rank(self.mesh, value, dtype)

    @torch.no_grad()
    def _restart_score(self, criterion, eval_key):
        """A candidate's score, higher is better, on ``eval_key``: an int
        seeding a fresh generator for each evaluation, or a list of fixed
        unit normals that each evaluation consumes from the start."""
        from ..bo.acquisition import _noise

        draws = lambda: _noise(eval_key, self.device, self.name)
        if criterion == "elbo":
            return float(elbo(self.params, self._X, self._Y, self.num_samples,
                              loop=self.loop, **draws()))
        if criterion != "fit":
            raise ValueError(f"unknown restart_select {criterion!r}")
        r2s = []
        for obj, (X, y) in enumerate(zip(self._X, self._Y)):
            Fmean, Fvar = predict_f(self.params, X, 50, objective=obj,
                                    loop=self.loop, **draws())
            mean, _ = moment_matched(Fmean, Fvar)
            ss_res = torch.sum((mean.reshape(y.shape) - y) ** 2)
            ss_tot = torch.sum((y - y.mean()) ** 2)
            r2s.append(float(1.0 - ss_res / ss_tot))
        return min(r2s)

    def _nat_adam_guarded(self, lr_adam, lr_gamma, iterations1, iterations2,
                          iterations3, messages, q_sqrt_scale,
                          train_upto_objective, checkpoint_path,
                          checkpoint_every):
        """One run of the 3-phase schedule from the current parameters. The
        natural-gradient steps are guarded (``guard_loss``): the 1e-6 White
        anchor makes a finite step able to raise the loss ~1e8-fold, and
        the same-normals guard rejects such steps."""
        self._init_variational(q_sqrt_scale)
        loss_fn, batch = self._loss_spec(train_upto_objective)
        ckpt_fn = self._checkpoint_fn(checkpoint_path)
        m1, m2, m3 = self._phase_masks()
        traces = []
        for steps, mask in ((iterations1, m1), (iterations2, m2)):
            _, losses = training.adam_run(
                loss_fn, self.params, mask, self.generator, steps=steps,
                lr=lr_adam, messages=messages, data=batch,
                checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn)
            traces.append(losses)
        sel = tuple(range(len(self.params.layers)))
        _, losses = training.nat_adam_run(
            loss_fn, self.params, m3,
            get_qs=lambda p: get_qs(p, sel),
            set_qs=lambda p, qs: set_qs(p, sel, qs),
            generator=self.generator, steps=iterations3, lr_adam=lr_adam,
            gamma=lr_gamma, messages=messages, data=batch,
            checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn,
            guard_loss=True)
        traces.append(losses)
        return torch.cat(traces)

    def optimize_adam(self, lr=0.01, iterations1=2000, iterations2=5000,
                      iterations3=7500, messages=500, q_sqrt_scale=1e-5,
                      train_upto_objective=-1, checkpoint_path=None,
                      checkpoint_every=0):
        """3-phase plain Adam; phase 3 trains everything (q and the
        likelihood by Adam). Returns the losses of all three phases."""
        self._init_variational(q_sqrt_scale)
        loss_fn, batch = self._loss_spec(train_upto_objective)
        ckpt_fn = self._checkpoint_fn(checkpoint_path)
        m1, m2, _ = self._phase_masks()
        m3 = training.make_mask(self.params)
        traces = []
        for steps, mask in ((iterations1, m1), (iterations2, m2),
                            (iterations3, m3)):
            _, losses = training.adam_run(
                loss_fn, self.params, mask, self.generator, steps=steps,
                lr=lr, messages=messages, data=batch,
                checkpoint_every=checkpoint_every, checkpoint_fn=ckpt_fn)
            traces.append(losses)
        return torch.cat(traces)

    @staticmethod
    def _make_inducing_points(X: List, Y: List) -> List:
        """Z[0] = [X_0, Y_1] (layer 0 takes [x, f] inputs), Z[i] = X_i."""
        Z = [np.concatenate((np.asarray(X[0]).copy(), np.asarray(Y[1]).copy()),
                            axis=1)]
        return Z + [np.asarray(x).copy() for x in X[1:]]
