"""Multi-fidelity Bayesian optimization driver (counterpart of
``dgp_tpu/bo/mf_bo.py``): MF surrogates, EI / WB2 / WB2S infill with EV or
PoF constraint handling, and the cost-aware choice of the fidelity each
query is evaluated at.

Per infill:

1. Train a fresh surrogate on the per-fidelity archives (one pooled output
   normalization, so the cross-fidelity structure is kept).
   ``model_dic['type']`` picks the form: ``'ar1'`` = exact AR(1)
   co-kriging (:mod:`~dgp_tpu_torch.models.cokriging`), ``'nargp'`` =
   nonlinear autoregressive GP (:mod:`~dgp_tpu_torch.models.nargp`),
   ``'em'`` = the embedded-mapping MF-DGP
   (:mod:`~dgp_tpu_torch.models.mf_dgp_em`, for fidelity stacks whose input
   spaces have different dimensions), or ``'mf_dgp'`` / no ``'type'`` =
   :class:`~dgp_tpu_torch.models.mf_dgp.MultiFidelityDeepGP`.
2. Maximize the infill criterion on the highest-fidelity latent posterior
   over the unit box (``bo/acquisition.py``). Constrained problems
   (``constraints=[g_i]``, g_i(x) <= 0 feasible, in the top-fidelity input
   space) combine it with EV or PoF handling over one exact GPR per
   constraint, trained on every queried point.
3. Pick the evaluation fidelity by the cost-aware rule of MF-GP-UCB / BOCA
   (Kandasamy et al. 2016/2017): the lowest fidelity f whose posterior std
   at the proposal still exceeds ``gamma * sqrt(cost_f / cost_top)``, past
   any fidelity that already holds the point.

With ``batch_size=q`` (or across ``suggest()`` calls, through the pending
registry) the surrogate is conditioned on a believer lie between picks: the
posterior mean at the pick's fidelity is appended to the surrogate's data
(exact conditioning for the AR(1) and NARGP forms; a short warm Adam refit
for the variational ones) and, where the pick targets the top fidelity and
is predicted feasible, the in-batch EI incumbent drops to it (Kriging
Believer, Ginsbourger et al. 2010). The archives record only real
evaluations.

The archives, their normalization and the fidelity and constraint
callables stay numpy on the host; the surrogates live on ``device`` (the
card unless the caller names another) in ``dtype``. One persistent host
``torch.Generator`` takes the place of the JAX package's run key: each
acquisition round draws its int seed from it, so successive ``run`` calls
and a reloaded checkpoint continue the stream. The seeds are PyTorch's, so a
run takes other (equally valid) steps than the JAX package's from the same
seed; the DoE, numpy in both, is the same. The inducing inputs of the
variational forms are pinned to the initial DoE (``Z = X_doe`` per
fidelity), so their parameter shapes stay the same as the archives grow.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..models import training
from ..models.cokriging import AR1CoKriging
from ..models.dgp import moment_matched
from ..models.mf_dgp import MultiFidelityDeepGP
from ..models.mf_dgp_em import MultiFidelityDeepGP_EM
from ..models.nargp import NARGP
from .acquisition import EI, EV, WB2, WB2S, PoF
from .doe import lhs
from .so_bo import (_safe_std, fantasy_mean, make_single_model,
                    match_pending_row, normalize)

#: Default surrogate, the winner of the JAX package's bake-off
#: (``benchmarks/mf_bo_bakeoff.py``): exact AR(1) co-kriging. Any dict
#: without ``'type'`` (e.g. ``{"num_samples": 5, "schedule": (200, 200,
#: 400)}``) selects the MF-DGP surrogate.
DEFAULT_MODEL_DIC = {"type": "ar1", "n_starts": 8, "iterations": 2000}


class MF_BO:
    """Single-objective minimization over [0, 1]^d with a choice of
    information sources (fidelities) per evaluation.

    :param fidelities: callables low -> high, each mapping numpy [n, d_f]
        -> [n, 1] on the unit box (the last is the objective minimized).
        With the ``'em'`` surrogate the input dimensions may differ (see
        ``projections``).
    :param costs: per-fidelity evaluation costs, ascending; by default a
        10x-per-level ladder ending at 1.0.
    :param DoE_sizes: per-fidelity LHS DoE sizes (low -> high), e.g.
        (20, 5). Variant-dimension ('em') stacks pass archives (X, Y).
    :param X, Y: optional known per-fidelity archives instead of a DoE.
    :param d: input dimension (required to draw a DoE).
    :param model_dic: surrogate spec (:data:`DEFAULT_MODEL_DIC`):
        ``{'type': 'ar1', 'n_starts': k, 'iterations': n, 'lr': r,
        'kernel': 'rbf'|'matern32'|'matern52'}``; ``{'type': 'nargp', ...
        the same keys..., 'num_samples': S}``; ``{'type': 'em',
        'num_samples': S, 'schedule': (it1, it2, it3)}`` (two fidelities);
        ``{'num_samples': S, 'schedule': (it1, it2, it3)}`` (no ``'type'``)
        = the MF-DGP surrogate.
    :param constraints: optional callables g_i mapping top-space [n, d] ->
        [n] / [n, 1], feasible iff g_i(x) <= 0; evaluated at every queried
        point and modeled by one exact GPR each on the pooled archive.
        ``best_trace`` then tracks the best feasible top-fidelity value
        (the top-fidelity maximum while none is feasible). Not supported
        with variant-dimension stacks.
    :param model_C_dic: constraint-surrogate spec (default ``{'kernels':
        'rbf', 'iterations': 2000}``).
    :param C: optional known per-fidelity constraint values aligned with
        ``X`` (:meth:`load` passes them, so the callables are not run).
    :param projections: per-lower-fidelity callables mapping top-space
        [n, d] rows into that fidelity's input space (e.g. ``lambda x:
        x[:, :2]`` for Park_VD); identity when omitted.
    :param gamma: fidelity threshold in normalized output units (0 always
        queries the lowest non-duplicate fidelity, ``inf`` the highest).
    :param dup_tol: duplicate-escalation tolerance (relative to sqrt(d)); 0
        disables the guard.
    :param device: where the surrogates live and run; the card unless
        given. With no card and no ``device``, construction raises.
    :param dtype: the surrogates' dtype (default ``config.default_float()``).
    """

    def __init__(self, fidelities: Sequence = None, costs=None,
                 DoE_sizes=None, X=None, Y=None, d: Optional[int] = None,
                 model_dic: Optional[dict] = None,
                 constraints: Optional[Sequence] = None,
                 model_C_dic: Optional[dict] = None, C=None,
                 projections: Optional[Sequence] = None,
                 seed: Optional[int] = None, n_bucket: Optional[int] = 8,
                 gamma: float = 0.3, dup_tol: float = 1e-3, device=None,
                 dtype=None):
        if not fidelities or len(fidelities) < 2:
            raise ValueError("fidelities must list >= 2 callables, low->high")
        self.fidelities = list(fidelities)
        self.n_fid = len(self.fidelities)
        if costs is None:
            costs = [10.0 ** (f - (self.n_fid - 1))
                     for f in range(self.n_fid)]
        self.costs = [float(c) for c in costs]
        if len(self.costs) != self.n_fid or any(
                a > b for a, b in zip(self.costs, self.costs[1:])):
            raise ValueError("costs must be ascending, one per fidelity")
        self.model_dic = dict(DEFAULT_MODEL_DIC if model_dic is None
                              else model_dic)
        self.constraints = list(constraints or [])
        self.n_con = len(self.constraints)
        self.model_C_dic = dict(model_C_dic
                                or {"kernels": "rbf", "iterations": 2000})
        self.projections = list(projections) if projections else None
        if (self.projections is not None
                and len(self.projections) != self.n_fid - 1):
            raise ValueError(
                f"projections must have one entry per lower fidelity "
                f"({self.n_fid - 1}), got {len(self.projections)}")
        self.gamma = float(gamma)
        self.dup_tol = float(dup_tol)
        self.n_bucket = n_bucket
        self._seed = seed

        kind = self.model_dic.get("type", "mf_dgp")
        if kind == "em" and self.n_fid != 2:
            raise ValueError(
                "the 'em' surrogate supports exactly 2 fidelities "
                "(reference MF_DGP_EM scope)")
        if X is None and (DoE_sizes is None or d is None):
            raise ValueError(
                "You have to specify either (DoE_sizes, d) to generate "
                "a DoE or known per-fidelity archives (X, Y)")
        # before any fidelity or constraint callable runs
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        if X is None:
            if len(DoE_sizes) != self.n_fid:
                raise ValueError("one DoE size per fidelity")
            # each fidelity's DoE is drawn in the top space and projected
            # into its own, so the archives hold each source's coordinates
            X = []
            for f, n in enumerate(DoE_sizes):
                x_top = lhs(d, n, seed=None if seed is None else seed + f)
                X.append(self._project(x_top, f))
            Y = [np.asarray(self.fidelities[f](X[f]), dtype=float)
                 .reshape(-1, 1) for f in range(self.n_fid)]
        else:
            X = [np.array(x, copy=True) for x in X]
            Y = [np.array(y, copy=True).reshape(-1, 1) for y in Y]
        self.X = X
        self.Y = Y
        self.d = X[-1].shape[1]
        if len({x.shape[1] for x in X}) > 1:
            if kind != "em":
                raise ValueError(
                    "per-fidelity input dimensions differ — that needs the "
                    "embedded-mapping surrogate (model_dic={'type': 'em'})")
            if self.n_con:
                raise ValueError(
                    "constraints are not supported with variant-dimension "
                    "('em') fidelity stacks")
        # per-fidelity constraint values aligned with X[f]'s rows; known
        # values (a checkpoint's) are taken as they are
        if not self.n_con:
            self.C = None
        elif C is not None:
            self.C = [np.array(c, copy=True).reshape(len(x), -1)
                      for c, x in zip(C, self.X)]
        else:
            self.C = [self._eval_cons(x) for x in self.X]
        # inducing inputs pinned to the DoE (module docstring)
        self._Z0 = [x.copy() for x in X]

        self._run_gen = torch.Generator().manual_seed(seed or 0)
        self._iteration = 0
        self.cost_spent: float = 0.0
        self.best_trace: List[float] = [self._best_feasible()]
        self.cost_trace: List[float] = [0.0]
        self.fidelity_choices: List[int] = []
        # pending registry (asynchronous ask/tell): top-space rows and their
        # fidelities suggested but not yet observed; they condition later
        # proposals as believer lies and survive save/load
        self.pending_X = np.zeros((0, self.d))
        self.pending_f = np.zeros((0,), dtype=int)
        self._batch_open = False
        self._bstate = None
        self._n_lied = 0

    # -- helpers ----------------------------------------------------------------
    def _next_run_key(self):
        """The next acquisition seed (an int) from the run's stream."""
        return int(torch.randint(0, 2 ** 62, (), generator=self._run_gen))

    def _project(self, x_top, f):
        """Top-space [n, d] -> fidelity f's own query coordinates."""
        x_top = np.asarray(x_top, dtype=float)
        if f == self.n_fid - 1 or self.projections is None:
            return x_top
        return np.asarray(self.projections[f](x_top), dtype=float)

    def _eval_cons(self, X_rows):
        """[n, n_con] constraint values at top-space rows (<= 0 feasible)."""
        return np.hstack([
            np.asarray(g(X_rows), dtype=float).reshape(len(X_rows), 1)
            for g in self.constraints])

    def _feasible_top(self):
        """Mask of the feasible top-fidelity rows (constrained problems)."""
        return self.C[-1].max(axis=1) <= 0

    def _best_feasible(self):
        """Best observed top-fidelity value; with constraints the best
        feasible one (the top-fidelity maximum while none is feasible)."""
        y_top = self.Y[-1]
        if self.n_con:
            feas = self._feasible_top()
            if feas.any():
                return float(y_top[feas].min())
            return float(y_top.max())
        return float(np.min(y_top))

    def _normalized_Y(self):
        """The per-fidelity archives under one pooled normalization (mean
        and std over every fidelity's observations), and the stats. A
        per-fidelity normalization would distort the cross-fidelity map the
        surrogates model."""
        pooled = np.vstack(self.Y)
        mu, sd = float(pooled.mean()), float(pooled.std() or 1.0)
        return [(y - mu) / sd for y in self.Y], mu, sd

    def _as_tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def make_model(self, Ys_n, seed):
        """Untrained surrogate per ``model_dic['type']`` (class docstring)
        on this loop's device and dtype."""
        kind = self.model_dic.get("type", "mf_dgp")
        on = dict(device=self.device, dtype=self.dtype)
        if kind == "ar1":
            return AR1CoKriging(
                (self.X, Ys_n), n_bucket=self.n_bucket,
                kernel=self.model_dic.get("kernel", "rbf"), **on)
        if kind == "nargp":
            return NARGP(
                (self.X, Ys_n), n_bucket=self.n_bucket,
                kernel=self.model_dic.get("kernel", "rbf"),
                num_samples=int(self.model_dic.get("num_samples", 100)),
                seed=seed, **on)
        if kind == "em":
            if self.projections is None and self.X[0].shape[1] != self.d:
                raise ValueError(
                    "variant-dimension 'em' stacks need projections= to "
                    "supervise the reduction layers (X_red)")
            # X_red: the projections of the top-fidelity inputs into each
            # lower space
            X_red = [self._project(self.X[-1], f)
                     for f in range(self.n_fid - 1)]
            return MultiFidelityDeepGP_EM(
                self.X, Ys_n, X_red=X_red, Z=[z.copy() for z in self._Z0],
                num_samples=int(self.model_dic.get("num_samples", 5)),
                seed=seed, n_bucket=self.n_bucket, **on)
        if kind != "mf_dgp":
            raise ValueError(f"unknown surrogate type {kind!r}")
        return MultiFidelityDeepGP(
            self.X, Ys_n, Z=[z.copy() for z in self._Z0],
            num_samples=int(self.model_dic.get("num_samples", 5)),
            seed=seed, n_bucket=self.n_bucket, **on)

    def _fit_model(self, Ys_n, seed):
        """Build and train one fresh surrogate on the current archives."""
        model = self.make_model(Ys_n, seed=seed)
        if self.model_dic.get("type", "mf_dgp") in ("ar1", "nargp"):
            model.optimize(
                n_starts=int(self.model_dic.get("n_starts", 8)),
                iterations=int(self.model_dic.get("iterations", 2000)),
                lr=float(self.model_dic.get("lr", 0.05)), seed=seed)
        else:
            sched = self.model_dic.get("schedule", (200, 200, 400))
            model.optimize_nat_adam(
                iterations1=sched[0], iterations2=sched[1],
                iterations3=sched[2], messages=0)
        return model

    def _make_train_con_models(self):
        """The infill's constraint surrogates: one exact GPR per constraint
        on the pooled archive (constraints do not depend on the fidelity),
        and the feasibility threshold in normalized units. (None, None)
        without constraints."""
        if not self.n_con:
            return None, None
        X_all = np.vstack(self.X)
        model_C, zero_n = [], []
        for i in range(self.n_con):
            c = np.vstack([cf[:, i:i + 1] for cf in self.C])
            spec = {"num_layers": 0,
                    "kernels": self.model_C_dic.get("kernels", "rbf")}
            m = make_single_model(spec, X_all, normalize(c),
                                  n_bucket=self.n_bucket, seed=self._seed,
                                  device=self.device, dtype=self.dtype)
            m.optimize_adam(
                iterations=int(self.model_C_dic.get("iterations", 2000)),
                lr=0.001)
            model_C.append(m)
            zero_n.append(float((0.0 - c.mean()) / _col_std(c)))
        return model_C, np.asarray(zero_n)

    def _fidelity_sigma(self, model, x_new, f, S=100):
        """The surrogate's moment-matched posterior std of fidelity ``f`` at
        the top-space row ``x_new``: what the fidelity rule compares."""
        m_s, v_s = model.predict_f(x_new, S=S, fidelity=f)
        _, var = moment_matched(m_s, v_s)
        return float(np.sqrt(max(float(torch.max(var)), 0.0)))

    def _select_fidelity(self, model, x_new, S=100, extra_queries=()):
        """BOCA-style rule: the lowest fidelity still informative at x_new
        (posterior std >= gamma * sqrt(cost ratio)), else the highest; a
        fidelity whose archive already holds a point within ``dup_tol``
        (relative to sqrt(d)) of x_new is skipped, since the sources are
        deterministic and a repeat adds nothing (without the guard the
        Forrester pair's deceptive low-fidelity minimum at x ~ 0.092 draws
        the whole budget into repeats). ``extra_queries``, (row, fidelity)
        pairs in query coordinates, extends the guard to pending points and
        earlier picks of the batch, which the archives do not hold yet."""

        def _is_dup(f):
            xq = self._project(x_new, f).reshape(1, -1)
            tol = self.dup_tol * np.sqrt(xq.shape[1])
            rows = [self.X[f]] + [np.asarray(r).reshape(1, -1)
                                  for r, fe in extra_queries if fe == f]
            return bool(min(
                float(np.min(np.linalg.norm(block - xq, axis=1)))
                for block in rows) < tol)

        for f in range(self.n_fid - 1):
            if _is_dup(f):
                continue
            sigma = self._fidelity_sigma(model, x_new, f, S)
            if sigma >= self.gamma * np.sqrt(
                    self.costs[f] / self.costs[-1]):
                return f
        return self.n_fid - 1

    # -- batch / pending conditioning --------------------------------------------
    def clear_pending(self):
        """Drop every suggested-but-unobserved point; their lies stop
        conditioning proposals at the next fresh surrogate fit."""
        self.pending_X = np.zeros((0, self.d))
        self.pending_f = np.zeros((0,), dtype=int)
        self._archive_changed()

    def _archive_changed(self):
        self._batch_open = False
        self._bstate = None
        self._n_lied = 0

    def _lie_value(self, st, x_new, f, lie):
        """The fantasized observation (normalized units) at ``x_new`` for
        fidelity ``f``: the surrogate's believer mean, or the constant
        liar's min / max of that fidelity's normalized archive."""
        if lie == "believer":
            m_s, v_s = st["model"].predict_f(x_new, S=64, fidelity=f)
            m, _ = moment_matched(m_s, v_s)
            return float(m.reshape(-1)[0])
        y_f_n = (np.asarray(self.Y[f]) - st["mu"]) / st["sd"]
        if lie == "min":
            return float(y_f_n.min())
        if lie == "max":
            return float(y_f_n.max())
        raise ValueError(f"unknown lie {lie!r}")

    def _lie_at(self, st, x_new, f, lie, lie_train_iterations):
        """Condition the batch state on a fantasized observation at
        (``x_new`` top-space [1, d], fidelity ``f``): append the lie row to
        the surrogate's fidelity-f data (exact conditioning for AR(1) and
        NARGP; the variational forms move only through the warm refit of
        ``lie_train_iterations`` Adam steps, 200 by default), condition the
        constraint GPRs on their believer means, and, where the pick
        targets the top fidelity and is predicted feasible, drop the
        in-batch incumbent to the lie (Kriging Believer)."""
        model = st["model"]
        x_new = np.asarray(x_new, dtype=float).reshape(1, self.d)
        xq = self._as_tensor(self._project(x_new, f))
        y_lie_n = self._lie_value(st, x_new, f, lie)
        y_lie = self._as_tensor([[y_lie_n]])

        if model.name in ("ar1", "nargp"):
            Xs, Ys = (list(ts) for ts in model.data)
            Xs[f] = torch.cat([Xs[f], xq], dim=0)
            Ys[f] = torch.cat([Ys[f], y_lie], dim=0)
            # NARGP's setter voids its cached mean chain
            model.data = (tuple(Xs), tuple(Ys))
        else:
            model._X[f] = torch.cat([model._X[f], xq], dim=0)
            model._Y[f] = torch.cat([model._Y[f], y_lie], dim=0)
            if model.name == "mf_dgp_EM" and f == self.n_fid - 1:
                # a top-fidelity row also supervises the reduction chain
                for r in range(self.n_fid - 1):
                    model._X_red[r] = torch.cat(
                        [model._X_red[r],
                         self._as_tensor(self._project(x_new, r))], dim=0)
            # a variational posterior moves only through training, so the
            # lie is followed by a short warm Adam refit on the current
            # parameters; optimize_nat_adam would first re-initialize q and
            # the likelihood and lose the trained posterior mid-batch
            iters = 200 if lie_train_iterations is None \
                else lie_train_iterations
            if iters:
                loss_fn, batch = model._loss_spec()
                training.adam_run(
                    loss_fn, model.params, training.make_mask(model.params),
                    model.generator, steps=iters, lr=0.01, messages=0,
                    data=batch)

        feasible_lie = True
        for i, m in enumerate(st["model_C"] or ()):
            c_lie = fantasy_mean(m, x_new)
            feasible_lie &= bool(float(c_lie[0, 0]) <= st["zero_n"][i])
            m.data = (torch.cat([m.data[0], self._as_tensor(x_new)]),
                      torch.cat([m.data[1], self._as_tensor(c_lie)]))
        if f == self.n_fid - 1 and feasible_lie:
            st["ic"].y_min = min(st["ic"].y_min, y_lie_n)

    def _build_ic(self, IC, mu, sd, model):
        """The incumbent-bearing criterion in pooled-normalized units."""
        y_min_n = float((self._best_feasible() - mu) / sd)
        if IC == "EI":
            ic = EI(y_min_n, self.d)
        elif IC == "WB2":
            ic = WB2(y_min_n, self.d)
        elif IC == "WB2S":
            ic = WB2S(y_min_n, self.d)
        else:
            raise ValueError(f"unknown IC {IC!r}")
        if isinstance(ic, WB2S):
            ic.resolve_scale(model, (0.0, 1.0), key=self._next_run_key())
        return ic

    def _fresh_batch_state(self, IC):
        """Fit a fresh surrogate and the constraint models on the real
        archives and freeze the batch state (pooled normalization stats and
        the incumbent-bearing criterion)."""
        Ys_n, mu, sd = self._normalized_Y()
        model = self._fit_model(Ys_n, seed=self._iteration)
        model_C, zero_n = self._make_train_con_models()
        st = dict(model=model, model_C=model_C, zero_n=zero_n, mu=mu, sd=sd)
        st["ic"] = self._build_ic(IC, mu, sd, model)
        return st

    # -- the loop ---------------------------------------------------------------
    def run(self, iterations=1, IC="EI", popsize_DE=300, iterations_DE=400,
            num_samples=500, batch_size=1, lie="believer",
            lie_train_iterations=None, constraint_handling="PoF",
            threshold=0.1, verbose=True):
        """``iterations`` infill rounds of ``batch_size`` picks each;
        returns the best observed (feasible) top-fidelity value after each
        evaluation (index 0 = the DoE's best). A lower-fidelity evaluation
        leaves the best trace as it was; its cost is still accounted in
        ``cost_trace``."""
        for _ in range(iterations):
            it = self._iteration
            picks_x, picks_f = self._propose(
                IC=IC, popsize_DE=popsize_DE, iterations_DE=iterations_DE,
                num_samples=num_samples, batch_size=batch_size, lie=lie,
                lie_train_iterations=lie_train_iterations,
                constraint_handling=constraint_handling, threshold=threshold)
            ys, cs = [], []
            for x, f in zip(picks_x, picks_f):
                xq = self._project(x, f)
                ys.append(np.asarray(self.fidelities[f](xq),
                                     dtype=float).reshape(1, 1))
                if self.n_con:
                    cs.append(self._eval_cons(x))
            self.observe(np.vstack(picks_x), np.vstack(ys), picks_f,
                         np.vstack(cs) if self.n_con else None)
            if verbose:
                for x, f, y in zip(picks_x, picks_f, ys):
                    print(f"infill {it}: x={np.round(x.ravel(), 4)} "
                          f"fidelity={f} y={y.item():.4f} "
                          f"best_hf={self.best_trace[-1]:.4f} "
                          f"cost={self.cost_spent:.2f}", flush=True)
        return list(self.best_trace)

    def _propose(self, IC="EI", popsize_DE=300, iterations_DE=400,
                 num_samples=500, batch_size=1, lie="believer",
                 lie_train_iterations=None, constraint_handling="PoF",
                 threshold=0.1, verbose=False, _continue_batch=False):
        """One acquisition round: fit a fresh surrogate (or, on the
        suggest() path with an unchanged archive, reuse the batch state),
        condition it on every outstanding pending point, then pick
        ``batch_size`` (point, fidelity) pairs with believer lies between
        them. Returns (top-space [1, d] rows, fidelities); the archives are
        not touched."""
        if IC not in ("EI", "WB2", "WB2S"):
            raise ValueError(f"unknown IC {IC!r}")
        # another criterion voids the continuation: the incumbent drops of
        # the lies already made live only in the old criterion, so the fresh
        # path applies every pending lie again under the new one
        cont = (_continue_batch and self._batch_open
                and len(self.pending_X) > 0 and self._bstate is not None
                and type(self._bstate["ic"]).__name__ == IC)
        if not cont:
            self._bstate = self._fresh_batch_state(IC)
            self._n_lied = 0
        st = self._bstate
        for i in range(self._n_lied, len(self.pending_X)):
            self._lie_at(st, self.pending_X[i:i + 1],
                         int(self.pending_f[i]), lie, lie_train_iterations)
        self._n_lied = len(self.pending_X)
        # queries committed but not in the archives: the duplicate guard
        # sees them, or a deterministic source is queried twice at one point
        extras = [(self._project(self.pending_X[i:i + 1],
                                 int(self.pending_f[i])),
                   int(self.pending_f[i]))
                  for i in range(len(self.pending_X))]

        picks_x, picks_f = [], []
        for bq in range(batch_size):
            sub = self._next_run_key()
            if self.n_con:
                if constraint_handling == "PoF":
                    handler = PoF(st["zero_n"], self.d)
                    x_new = handler.optimize_with_IC(
                        st["ic"], st["model"], st["model_C"], (0.0, 1.0),
                        popsize_DE=popsize_DE, iterations_DE=iterations_DE,
                        method="DE", key=sub)
                elif constraint_handling == "EV":
                    handler = EV(st["zero_n"], self.d)
                    x_new = handler.optimize_with_IC(
                        st["ic"], st["model"], st["model_C"], (0.0, 1.0),
                        threshold=threshold, popsize_DE=popsize_DE,
                        iterations_DE=iterations_DE, method="DE", key=sub)
                else:
                    raise ValueError(
                        f"unknown constraint_handling {constraint_handling!r}")
            else:
                x_new = st["ic"].optimize(
                    st["model"], bounds=(0.0, 1.0), popsize_DE=popsize_DE,
                    iterations_DE=iterations_DE, num_samples=num_samples,
                    key=sub)
            # float64 like the archives (the search runs in the surrogate's
            # dtype)
            x_new = np.clip(np.asarray(x_new, dtype=float).reshape(1, self.d),
                            0.0, 1.0)
            f = self._select_fidelity(st["model"], x_new,
                                      extra_queries=extras)
            picks_x.append(x_new)
            picks_f.append(f)
            extras.append((self._project(x_new, f), f))
            if bq < batch_size - 1:
                self._lie_at(st, x_new, f, lie, lie_train_iterations)
        return picks_x, picks_f

    # -- ask/tell interface ---------------------------------------------------------
    def suggest(self, batch_size=1, **propose_kwargs):
        """Ask/tell, step 1: the next query, ``(x_new [1, d], fidelity)``
        for ``batch_size=1``, else ``(X [q, d], fidelities [q])``, without
        evaluating a source. Feed the results back with :meth:`observe`.
        Takes :meth:`run`'s keyword arguments and shares its infill counter
        and seed stream.

        Every suggested point is registered as pending and conditions later
        proposals as a believer lie until :meth:`observe` resolves it, so
        back-to-back ``suggest()`` calls propose different queries, and
        ``suggest(1); suggest(1)`` walks the same surrogate state and seed
        stream as one ``suggest(2)``. Abandon pending points with
        :meth:`clear_pending`."""
        picks_x, picks_f = self._propose(batch_size=batch_size,
                                         _continue_batch=True,
                                         **propose_kwargs)
        X = np.vstack(picks_x)
        self.pending_X = np.vstack([self.pending_X, X])
        self.pending_f = np.concatenate(
            [self.pending_f, np.asarray(picks_f, dtype=int)])
        # _propose conditioned the state on every pick but the last
        self._n_lied = len(self.pending_X) - 1
        self._batch_open = True
        if batch_size == 1:
            return picks_x[0], picks_f[0]
        return X, np.asarray(picks_f, dtype=int)

    def observe(self, x_new, y_new, fidelity, c_new=None):
        """Ask/tell, step 2: append externally evaluated observations,
        account their cost, resolve the matching pending entries and
        advance the infill counter. ``x_new`` [q, d] is in top-space
        coordinates (lower fidelities are projected here); ``fidelity`` is
        an int or one per row; ``c_new`` [q, n_con] is required for
        constrained problems."""
        x_new = np.asarray(x_new, dtype=float).reshape(-1, self.d)
        q = len(x_new)
        y_new = np.asarray(y_new, dtype=float).reshape(q, 1)
        fids = ([int(fidelity)] * q if np.ndim(fidelity) == 0
                else [int(v) for v in fidelity])
        if len(fids) != q:
            raise ValueError("one fidelity per observed row")
        for f in fids:
            if not 0 <= f < self.n_fid:
                raise ValueError(f"fidelity must be in [0, {self.n_fid - 1}]")
        if self.n_con:
            if c_new is None:
                raise ValueError(
                    "constrained problem: constraint values are required")
            c_new = np.asarray(c_new, dtype=float).reshape(q, self.n_con)
        for i, f in enumerate(fids):
            self.X[f] = np.vstack([self.X[f], self._project(x_new[i:i + 1], f)])
            self.Y[f] = np.vstack([self.Y[f], y_new[i:i + 1]])
            if self.n_con:
                self.C[f] = np.vstack([self.C[f], c_new[i:i + 1]])
            self.fidelity_choices.append(f)
            self.cost_spent += self.costs[f]
            self.best_trace.append(self._best_feasible())
            self.cost_trace.append(self.cost_spent)
        self._resolve_pending(x_new, fids)
        self._archive_changed()
        self._iteration += 1
        return list(self.best_trace)

    def _resolve_pending(self, X_obs, fids):
        """Remove the observed (row, fidelity) pairs from the pending
        registry (:func:`so_bo.match_pending_row`, among the entries of the
        same fidelity: one x can be pending at two fidelities, and an
        observation pops its own)."""
        pending_X = np.asarray(self.pending_X,
                               dtype=float).reshape(-1, self.d)
        pending_f = np.asarray(self.pending_f, dtype=int)
        keep_mask = np.ones(len(pending_X), dtype=bool)
        for row, f in zip(np.asarray(X_obs, dtype=float).reshape(-1, self.d),
                          fids):
            cand = np.flatnonzero(keep_mask & (pending_f == int(f)))
            if not len(cand):
                continue
            k = match_pending_row(pending_X[cand], row)
            if k is not None:
                keep_mask[cand[k]] = False
        self.pending_X = pending_X[keep_mask]
        self.pending_f = pending_f[keep_mask]

    @property
    def x_best(self):
        """Best observed top-fidelity input; for constrained problems the
        best feasible one (as ``best_trace``), the unconstrained argmin
        while no top-fidelity point is feasible."""
        y = np.asarray(self.Y[-1]).reshape(-1)
        if self.n_con:
            feas = self._feasible_top()
            if feas.any():
                idx = np.flatnonzero(feas)
                return self.X[-1][idx[int(np.argmin(y[feas]))]]
        return self.X[-1][int(np.argmin(y))]

    # -- checkpoint / resume -----------------------------------------------------
    def save(self, path: str):
        """Checkpoint the loop as one .npz (written atomically): archives,
        constraint values, traces, the seed stream's state, the infill
        counter and the pending registry. The format is the port's own; it
        does not read the JAX package's."""
        state = {
            "n_fid": np.asarray(self.n_fid),
            "costs": np.asarray(self.costs),
            "gamma": np.asarray(self.gamma),
            "dup_tol": np.asarray(self.dup_tol),
            "seed": np.asarray(self._seed if self._seed is not None else -1),
            "iteration": np.asarray(self._iteration),
            "n_bucket": np.asarray(self.n_bucket or 0),
            "run_gen": self._run_gen.get_state().numpy(),
            "cost_spent": np.asarray(self.cost_spent),
            "best_trace": np.asarray(self.best_trace),
            "cost_trace": np.asarray(self.cost_trace),
            "fidelity_choices": np.asarray(self.fidelity_choices, dtype=int),
            "model_dic": np.asarray(json.dumps(self.model_dic)),
            "model_C_dic": np.asarray(json.dumps(self.model_C_dic)),
            "pending_X": self.pending_X,
            "pending_f": self.pending_f,
        }
        for f in range(self.n_fid):
            state[f"X{f}"] = self.X[f]
            state[f"Y{f}"] = self.Y[f]
            state[f"Z{f}"] = self._Z0[f]
            if self.n_con:
                state[f"C{f}"] = self.C[f]
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **state)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, fidelities, model_dic=None, constraints=None,
             projections=None, device=None, dtype=None):
        """Restore a saved loop. The callables (``fidelities``, and
        ``constraints`` / ``projections`` where used) are supplied again;
        everything else comes from the checkpoint, the constraint values
        included, so no constraint is evaluated. ``device`` and ``dtype``
        as for the constructor."""
        data = np.load(path)
        n_fid = int(data["n_fid"])
        if len(fidelities) != n_fid:
            raise ValueError(f"checkpoint has {n_fid} fidelities")
        seed = int(data["seed"])
        if model_dic is None:
            model_dic = json.loads(str(data["model_dic"]))
            if isinstance(model_dic.get("schedule"), list):
                model_dic["schedule"] = tuple(model_dic["schedule"])
        bo = cls(fidelities=fidelities,
                 costs=[float(c) for c in data["costs"]],
                 X=[data[f"X{f}"] for f in range(n_fid)],
                 Y=[data[f"Y{f}"] for f in range(n_fid)],
                 model_dic=model_dic,
                 constraints=constraints,
                 model_C_dic=json.loads(str(data["model_C_dic"])),
                 C=([data[f"C{f}"] for f in range(n_fid)]
                    if constraints and "C0" in data.files else None),
                 projections=projections,
                 seed=None if seed == -1 else seed,
                 n_bucket=int(data["n_bucket"]) or None,
                 gamma=float(data["gamma"]),
                 dup_tol=float(data["dup_tol"]), device=device, dtype=dtype)
        bo._Z0 = [np.asarray(data[f"Z{f}"]) for f in range(n_fid)]
        bo._run_gen.set_state(torch.as_tensor(data["run_gen"]))
        bo._iteration = int(data["iteration"])
        bo.cost_spent = float(data["cost_spent"])
        bo.best_trace = [float(v) for v in data["best_trace"]]
        bo.cost_trace = [float(v) for v in data["cost_trace"]]
        bo.fidelity_choices = [int(v) for v in data["fidelity_choices"]]
        bo.pending_X = np.asarray(data["pending_X"],
                                  dtype=float).reshape(-1, bo.d)
        bo.pending_f = np.asarray(data["pending_f"], dtype=int).reshape(-1)
        return bo


def _col_std(a):
    """Scalar std of one column with :func:`so_bo._safe_std`'s zero-variance
    guard."""
    return float(_safe_std(np.asarray(a, dtype=float)).item())
