"""Single-objective (un)constrained Bayesian optimization driver
(counterpart of ``dgp_tpu/bo/so_bo.py``): GP/DGP surrogates built from spec
dicts, EI/WB2/WB2S infill with EV/PoF constraint handling, LHS DoE,
input/output normalization, batch infill with believer/min/max lies, the
ask/tell interface with its pending registry, and save/load.

The archive (X, Y, C) and its normalization stay numpy on the host, as in
the JAX package; the surrogates live on ``device`` (the card unless the
caller names another) in ``dtype``. One persistent ``torch.Generator`` on
the host takes the place of the JAX package's run key: each acquisition
round draws its seed from it, so successive ``run`` calls and a reloaded
checkpoint continue the stream. The seeds are PyTorch's, not JAX's, so a
run takes other (equally valid) steps than the JAX package's from the same
seed; the DoE, numpy in both, is the same.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..models import training
from ..models.dgp import DGP, moment_matched
from ..models.gpr import GPR
from ..ops import kernels as kernels_lib
from ..ops.likelihoods import Gaussian
from .acquisition import EI, EV, WB2, WB2S, PoF
from .doe import doe


def _safe_std(a):
    """Columnwise std with (numerically) zero-variance columns mapped to 1
    (a constant column would make the normalization divide by zero). The
    check is relative: a column of identical
    values has std ~1e-16 from fp rounding, not exactly 0."""
    sd = a.std(axis=0)
    tiny = 1e-12 * np.maximum(1.0, np.abs(a).max(axis=0))
    return np.where(sd <= tiny, 1.0, sd)


def normalize(*args):
    out = [(a - a.mean(axis=0)) / _safe_std(a) for a in args]
    return out[0] if len(out) == 1 else out


def normalize_X(X):
    mu, sd = X.mean(axis=0), _safe_std(X)
    return (X - mu) / sd, (0 - mu) / sd, (1 - mu) / sd


def normalize_C(C):
    mu, sd = C.mean(axis=0), _safe_std(C)
    return (C - mu) / sd, (0 - mu) / sd


def denormalize(Xstar_n, X):
    """Inverse of normalize_X; uses _safe_std so the round-trip stays an
    inverse on zero-variance columns (raw std would pin the de-normalized
    coordinate of a constant DoE column to the column mean forever)."""
    return _safe_std(X) * Xstar_n + X.mean(axis=0)


def denormalize_var(var_n, X):
    return _safe_std(X) ** 2 * var_n


def bucketed_inducing(X, n_bucket, seed=None):
    """Default inducing set Z = X (the training inputs), padded to multiples of ``n_bucket`` with distinct in-range
    points so M only changes at bucket boundaries (duplicate rows would make
    Kuu singular). Extra inducing points only add variational capacity."""
    if not n_bucket:
        return X.copy()
    n, d = X.shape
    n_pad = training.bucket_rows(n, n_bucket)
    if n_pad == n:
        return X.copy()
    rng = np.random.default_rng(seed or 0)
    lo, hi = X.min(axis=0), X.max(axis=0)
    extra = rng.uniform(size=(n_pad - n, d)) * (hi - lo) + lo
    return np.concatenate([X, extra], axis=0)


def make_single_model(dic, X, Y, n_bucket=None, seed=None, device=None,
                      dtype=None):
    """Spec-dict surrogate factory: num_layers=0 builds an exact GPR,
    otherwise a (non-whitened) DGP with Z = bucketed training inputs, on
    ``device`` (the card unless given; with no card and no ``device`` this
    raises) in ``dtype`` (default ``config.default_float()``)."""
    device = resolve_device(device)
    dtype = dtype or default_float()
    if "num_layers" not in dic:
        raise ValueError("num_layers entry is not specified")
    num_layers = dic["num_layers"]
    kern_names = dic.get("kernels")
    if kern_names is None:
        raise ValueError("kernels entry is not specified")

    if num_layers == 0:
        if not isinstance(kern_names, str):
            raise ValueError("for num_layers=0, kernels must be a string")
        kernel = kernels_lib.by_name(kern_names, X.shape[1], dtype=dtype,
                                     device=device)
        return GPR((X, Y), kernel, noise_variance=1e-5, n_bucket=n_bucket,
                   device=device, dtype=dtype)

    num_samples = dic.get("num_samples")
    if num_samples is None:
        raise ValueError("num_samples entry is not specified")
    num_units = dic.get("num_units")
    if num_units is None:
        raise ValueError("num_units entry is not specified")
    if isinstance(num_units, int):
        num_units = [num_units] * num_layers
    elif len(num_units) != num_layers:
        raise ValueError(
            "the length of num_units has to equal the number of layers"
        )
    if isinstance(kern_names, str):
        kern_names = [kern_names] * (num_layers + 1)
    elif len(kern_names) != num_layers + 1:
        raise ValueError("the length of kernels has to equal num_layers + 1")
    kernels = []
    for l in range(num_layers + 1):
        units = X.shape[1] if l == 0 else num_units[l - 1]
        kernels.append(kernels_lib.by_name(kern_names[l], units, dtype=dtype,
                                           device=device))
    Z = bucketed_inducing(X, n_bucket, seed=seed)
    return DGP(X, Y, Z, kernels, num_units,
               Gaussian.create(1.0, dtype=dtype, device=device),
               num_samples=num_samples, n_bucket=n_bucket, device=device,
               dtype=dtype)


def match_pending_row(pending_rows, row):
    """The pending-registry matching policy: the index of the nearest row
    of ``pending_rows`` within the tolerance (1e-8, relative to the
    observed row's norm), or None. One implementation, so that the BO
    drivers cannot drift apart (the JAX package's three share it)."""
    pending_rows = np.asarray(pending_rows, dtype=float)
    if not len(pending_rows):
        return None
    row = np.asarray(row, dtype=float).reshape(-1)
    dist = np.linalg.norm(pending_rows - row[None], axis=1)
    k = int(np.argmin(dist))
    if dist[k] <= 1e-8 * max(1.0, float(np.linalg.norm(row))):
        return k
    return None


def resolve_pending_rows(pending, X_obs, d):
    """Indices of ``pending`` rows NOT matched by any observed row. Each
    observed row removes at most its nearest pending row (policy:
    :func:`match_pending_row`) — unmatched observations are legitimate
    external data and leave pending untouched."""
    pending = np.asarray(pending, dtype=float).reshape(-1, d)
    keep = list(range(len(pending)))
    for row in np.asarray(X_obs, dtype=float).reshape(-1, d):
        if not keep:
            break
        k = match_pending_row(pending[keep], row)
        if k is not None:
            keep.pop(k)
    return keep


def fantasy_mean(model, x_n, S=64):
    """Surrogate posterior mean at x_n [1, d] (normalized coords): the
    Kriging-Believer lie value for batch infills. GPR means are exact; DGP
    means are moment-matched over S posterior samples."""
    if model.name == "gpr":
        m, _ = model.predict_f(x_n)
    else:
        m, _ = moment_matched(*model.predict_f(x_n, S=S))
    return m.cpu().numpy().reshape(1, -1)


class SO_BO:
    """Minimize f(x) over [0,1]^d subject to g(x) <= 0.

    :param model_Y_dic: {'num_layers': l, 'num_units': [...], 'kernels':
        'rbf'|'matern32'|'matern52'|[...], 'num_samples': S}; num_layers=0
        builds an exact GPR surrogate.
    :param model_C_dic: one dict (shared) or a list per constraint.
    :param device: where the surrogates live and run; the card unless
        given. With no card and no ``device``, construction raises.
    :param dtype: the surrogates' dtype (default ``config.default_float()``).
    """

    def __init__(self, problem=None, X=None, Y=None, C=None, DoE_size=None,
                 model_Y_dic=None, model_C_dic=None, normalize_input=True,
                 seed: Optional[int] = None, n_bucket: Optional[int] = 8,
                 device=None, dtype=None):
        if problem is None:
            raise ValueError("You have to specify a problem to optimize")
        if not isinstance(model_Y_dic, dict):
            raise ValueError(
                "You have to specify a dictionary for the architecture of the "
                "objective function model"
            )
        if problem.constraint and model_C_dic is None:
            raise ValueError(
                "You have to specify a dictionary for the architecture of the "
                "constraint functions models"
            )
        self.problem = problem
        self.model_Y_dic = model_Y_dic
        self.model_C_dic = model_C_dic
        self._seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        # Pad the surrogates' rows (data, and the default Z of from-scratch
        # DGP rebuilds) to multiples of n_bucket, as the JAX package does
        # (there to keep its compiled programs stable; here it keeps the
        # sizes, and so the kernels' launch shapes, stable while the loop
        # adds one point per infill). n_bucket=None disables it.
        self.n_bucket = n_bucket

        if DoE_size is None and X is None:
            raise ValueError(
                "You have to specify either a size to generate a DoE or a "
                "known DoE (X, Y)"
            )
        if X is None:
            if problem.constraint:
                self.X, self.Y, self.C = doe(problem, DoE_size, seed=seed)
            else:
                self.X, self.Y = doe(problem, DoE_size, seed=seed)
                self.C = None
        else:
            self.X = np.array(X, copy=True)
            self.Y = np.array(Y, copy=True)
            self.C = np.array(C, copy=True) if problem.constraint else None

        self.d = problem.dim
        self.n = self.X.shape[0]
        self.normalize_input = normalize_input
        self._refresh_normalization()

        self.model_Y = self.make_model(model_Y_dic, self.X_train, self.Y_train)
        if problem.constraint:
            n_c = self.C.shape[1]
            if not isinstance(model_C_dic, list):
                self.model_C_dic = [model_C_dic] * n_c
            self.model_C = [
                self.make_model(
                    self.model_C_dic[i], self.X_train,
                    self.C_train[:, i].reshape(-1, 1),
                )
                for i in range(n_c)
            ]

        self.Xfeasible, self.Yfeasible, self.Ymin = [], [], []
        self.feasible()
        self.added_points = []
        self.IC = None
        self.constrained_IC = None
        # pending-point registry (asynchronous ask/tell): raw-coordinate
        # rows suggested but not yet observed. They persist as believer
        # lies across suggest() calls — a second suggest() before any
        # observe() proposes DIFFERENT points — and survive save/load.
        self.pending = np.zeros((0, self.d))
        # session-only continuation state: normalized coords of the pending
        # rows (valid while the archive is unchanged), how many of them the
        # current surrogates are already conditioned on, and whether an
        # in-progress suggest sequence can skip retraining
        self._pending_n = []
        self._n_lied = 0
        self._batch_open = False
        # one persistent seed stream: successive run() calls (and checkpoint
        # resumes) continue it instead of restarting at the seed
        self._run_gen = torch.Generator().manual_seed(seed or 0)
        self._iteration = 0

    def _next_run_key(self):
        """The next acquisition seed (an int) from the run's stream."""
        return int(torch.randint(0, 2 ** 62, (), generator=self._run_gen))

    # -- data management --------------------------------------------------------
    def _refresh_normalization(self):
        if self.normalize_input:
            self.X_n, self.lw_n, self.up_n = normalize_X(self.X)
            self.Y_n = normalize(self.Y)
            self.X_train, self.Y_train = self.X_n, self.Y_n
            if self.problem.constraint:
                self.C_n, self.feasible_0 = normalize_C(self.C)
                self.C_train = self.C_n
        else:
            self.X_train, self.Y_train = self.X, self.Y
            self.lw_n = np.zeros(self.d)
            self.up_n = np.ones(self.d)
            if self.problem.constraint:
                self.C_train = self.C
                self.feasible_0 = np.zeros(self.C.shape[1])

    def feasible(self):
        """Track the feasible subset and the running observed minimum."""
        if self.C is not None:
            mask = self.C.max(axis=1) <= 0
            self.Xfeasible = self.X[mask]
            self.Yfeasible = self.Y[mask]
            self.Cfeasible = self.C[mask]
            if len(self.Yfeasible) == 0:
                self.Ymin = [np.max(self.Y)]
            else:
                self.Ymin = [np.min(self.Yfeasible)]
        else:
            self.Xfeasible = self.X
            self.Yfeasible = self.Y
            self.Ymin = [np.min(self.Y)]

    # -- model factory (spec dict) ----------------------------------------------
    def make_model(self, dic, X, Y):
        return make_single_model(dic, X, Y, n_bucket=self.n_bucket,
                                 seed=self._seed, device=self.device,
                                 dtype=self.dtype)

    def _bucketed_inducing(self, X):
        return bucketed_inducing(X, self.n_bucket, seed=self._seed)

    # -- training -----------------------------------------------------------------
    def train_model(self, model, iteration=3000):
        if model.name == "gpr":
            model.optimize_adam(iterations=iteration, lr=0.001)
        elif model.name == "dgp":
            model.optimize_nat_adam(iterations1=500, iterations2=iteration,
                                    beta_1=0.8, beta_2=0.9, lr_gamma=0.01,
                                    messages=0)

    def train_models(self, iteration_Y=3000, iteration_C=3000):
        self.train_model(self.model_Y, iteration_Y)
        if self.problem.constraint:
            if not isinstance(iteration_C, list):
                iteration_C = [iteration_C] * self.C.shape[1]
            for i in range(self.C.shape[1]):
                self.train_model(self.model_C[i], iteration_C[i])

    # -- batch (q-point) infill helpers -------------------------------------------
    def _fantasy_mean(self, model, x_n):
        return fantasy_mean(model, x_n)

    def _apply_lie(self, x_new_n, lie, lie_train_iterations):
        """Append a fantasized observation at ``x_new_n`` to the SURROGATE
        training data only (the real archive is untouched) so the next
        in-batch acquisition sees a conditioned posterior. For exact GPR
        this is exact posterior conditioning at fixed hyperparameters
        (zero retraining); SVGP-based DGP posteriors only move through
        training, so a short Adam refit runs when ``lie_train_iterations``
        is nonzero (default 200 for DGP surrogates, 0 for GPR)."""
        x = np.asarray(x_new_n, dtype=float).reshape(1, self.d)

        def _lie_value(model):
            Yt = model.data[1].cpu().numpy()
            if lie == "believer":
                return self._fantasy_mean(model, x)
            if lie == "min":
                return Yt.min(axis=0, keepdims=True)
            if lie == "max":
                return Yt.max(axis=0, keepdims=True)
            raise ValueError(f"unknown lie {lie!r}")

        models = [self.model_Y] + (
            list(self.model_C) if self.problem.constraint else [])
        y_lie_obj = None
        feasible_lie = True
        for k, model in enumerate(models):
            # constraints always use the believer mean: min/max lies are
            # statements about the OBJECTIVE's optimism, not feasibility
            y_lie = (self._fantasy_mean(model, x) if k > 0
                     else _lie_value(model))
            if k == 0:
                y_lie_obj = y_lie
            else:
                # believer feasibility: the fantasy point counts as
                # feasible iff every constraint surrogate's mean is
                # (feasible_0 is the image of 0 under C's normalization)
                feasible_lie &= bool(
                    float(np.min(y_lie)) <= float(self.feasible_0[k - 1]))
            Xt = np.vstack([model.data[0].cpu().numpy(), x])
            Yt = np.vstack([model.data[1].cpu().numpy(), y_lie])
            model.data = (self._as_model_data(Xt), self._as_model_data(Yt))
            iters = lie_train_iterations
            if iters is None:
                iters = 0 if model.name == "gpr" else 200
            if iters:
                if model.name == "gpr":
                    model.optimize_adam(iterations=iters, lr=0.001)
                else:
                    # short Adam-only refit (MO_BO._condition_on_lie's
                    # recipe) — train_model would prepend its fixed
                    # 500-step phase to every in-batch lie.
                    # shrink_inner=False: the 1e-3 inner-q_sqrt shrink is an
                    # at-init stabilizer; repeating it per lie collapses the
                    # trained posterior 1e-3x per pick.
                    model.optimize_nat_adam(iterations1=iters, iterations2=0,
                                            messages=0, shrink_inner=False)

        if self.IC is not None and feasible_lie:
            # Kriging Believer treats the lie as an observation, so the
            # in-batch incumbent drops with it (Ginsbourger et al. 2010).
            # Without this, EI at an already-picked point stays
            # ~(y_min - mu) > 0 whenever the believed mean undercuts the
            # real incumbent, and the batch re-picks the same point.
            # Gated on believer feasibility for constrained problems: the
            # incumbent is the best FEASIBLE value, and an infeasible
            # fantasy must not deflate EI across the feasible region
            # (the JAX package's MF_BO has the same gate). The REAL Ymin trace and
            # every fresh _build_IC are untouched.
            self.IC.y_min = min(self.IC.y_min, float(np.min(y_lie_obj)))

    # -- BO loop --------------------------------------------------------------------
    def run(self, iterations, from_scratch=None, IC="EI",
            constraint_handling="PoF", threshold=0.1, train_iterations=1000,
            popsize_DE=300, popstd_DE=1.5, iterations_DE=400, init_adam=None,
            iterations_adam=1000, IC_method="DE+Adam", analytic=True,
            batch_size=1, lie="believer", lie_train_iterations=None,
            verbose=True):
        """``batch_size`` > 1 proposes q points per infill for parallel
        evaluation: after each in-batch pick the
        surrogates are conditioned on a fantasized observation at the pick
        (``lie='believer'`` = posterior mean, Kriging Believer; ``'min'``/
        ``'max'`` = constant liar of Ginsbourger et al. 2010), the
        acquisition re-optimizes against the conditioned posterior (EI at
        an already-picked point collapses, so the batch spreads), and all
        q points are then evaluated on the real problem together. y_min
        always comes from REAL observations only."""
        for _ in range(iterations):
            raw = self._propose(
                batch_size=batch_size, IC=IC,
                constraint_handling=constraint_handling, threshold=threshold,
                train_iterations=train_iterations, popsize_DE=popsize_DE,
                popstd_DE=popstd_DE, iterations_DE=iterations_DE,
                init_adam=init_adam, iterations_adam=iterations_adam,
                IC_method=IC_method, analytic=analytic, lie=lie,
                lie_train_iterations=lie_train_iterations,
                from_scratch=from_scratch, verbose=verbose)
            for x in raw:
                self.add_point(x)
            self._iteration += 1
            if verbose:
                print("Actual Y min:", self.Ymin[-1])

    def _build_IC(self, IC, bounds):
        """Construct self.IC from the current incumbent. The incumbent must
        live in the surrogate's OUTPUT space: normalized when the surrogate
        trains on Y_n, raw when normalize_input=False."""
        if self.normalize_input:
            y_min_n = (self.Ymin[-1] - self.Y.mean(axis=0)) / _safe_std(self.Y)
        else:
            y_min_n = np.asarray(self.Ymin[-1])
        if IC == "EI":
            self.IC = EI(y_min_n, self.d)
        elif IC == "WB2":
            self.IC = WB2(y_min_n, self.d)
        elif IC == "WB2S":
            self.IC = WB2S(y_min_n, self.d)
        else:
            raise ValueError(f"unknown IC {IC!r}")
        if isinstance(self.IC, WB2S):
            # adaptive s is resolved from the unconstrained EI maximizer
            # once per infill (fresh y_min => fresh IC object)
            self.IC.resolve_scale(self.model_Y, bounds,
                                  key=self._next_run_key())

    def _normalize_x(self, x_raw):
        """Raw [1, d] -> the surrogate's input coordinates."""
        x_raw = np.asarray(x_raw, dtype=float).reshape(1, self.d)
        if not self.normalize_input:
            return x_raw
        return (x_raw - self.X.mean(axis=0)) / _safe_std(self.X)

    def clear_pending(self):
        """Drop all outstanding suggested-but-unobserved points (e.g. after
        abandoning external evaluations). Their believer lies stop
        conditioning future proposals at the next (re)training."""
        self.pending = np.zeros((0, self.d))
        self._pending_n = []
        self._n_lied = 0
        self._batch_open = False

    def _propose(self, batch_size=1, IC="EI", constraint_handling="PoF",
                 threshold=0.1, train_iterations=1000, popsize_DE=300,
                 popstd_DE=1.5, iterations_DE=400, init_adam=None,
                 iterations_adam=1000, IC_method="DE+Adam", analytic=True,
                 lie="believer", lie_train_iterations=None, from_scratch=None,
                 verbose=False, _continue_batch=False):
        """One acquisition round: (re)train the surrogates on the current
        archive, maximize the infill criterion ``batch_size`` times with
        believer/liar conditioning between picks, and return the picks as a
        list of raw-coordinate [1, d] rows (the archive is NOT touched —
        callers evaluate and append via :meth:`add_point` /
        :meth:`observe`). Also sets ``added_points`` (normalized [q, d]).

        Outstanding :attr:`pending` points (suggested, not yet observed)
        always condition the proposal as believer lies, so proposals avoid
        in-flight evaluations. With ``_continue_batch`` (the suggest() path)
        and an unchanged archive, the already-trained-and-conditioned
        surrogates are reused — a second suggest() before any observe()
        then continues the in-progress batch exactly (same surrogate state
        and key stream as one bigger batch_size)."""
        # global infill counter (survives run() calls and save/load, so a
        # resumed loop keeps the exact from_scratch/full-vs-half-train
        # cadence of the uninterrupted one)
        j = self._iteration
        if verbose:
            print(f"adding the most promising data point in iteration {j}")
        if IC not in ("EI", "WB2", "WB2S"):
            raise ValueError(f"unknown IC {IC!r}")
        bounds = (self.lw_n, self.up_n)
        # switching the criterion mid-batch voids the continuation: a
        # rebuilt IC starts from the REAL incumbent, and the believer
        # drops of already-conditioned lies exist only in the old IC
        # object — the fresh path re-applies every pending lie (data rows
        # AND incumbent) under the new criterion
        cont = (_continue_batch and self._batch_open
                and len(self.pending) > 0
                and self.IC is not None
                and type(self.IC).__name__ == IC)
        if not cont:
            # from_scratch None or 0 = never rebuild (0 would divide by zero)
            rebuild = bool(from_scratch) and j != 0 and j % from_scratch == 0
            if rebuild:
                self.model_Y = self.make_model(
                    self.model_Y_dic, self.X_train, self.Y_train
                )
                if self.problem.constraint:
                    self.model_C = [
                        self.make_model(
                            self.model_C_dic[i], self.X_train,
                            self.C_train[:, i].reshape(-1, 1),
                        )
                        for i in range(self.C.shape[1])
                    ]
            if not rebuild:
                # re-point the surrogates at the real archive before
                # training — fantasy rows (pending lies included) must
                # never be trained on as real observations; pending lies
                # are re-applied AFTER training, below
                self._rebind_data()
            if j == 0 or rebuild:
                self.train_models(train_iterations, train_iterations)
            else:
                self.train_models(train_iterations // 2, train_iterations // 2)
            self._build_IC(IC, bounds)
            # fresh surrogates: none of the pending rows condition them yet
            self._pending_n = [self._normalize_x(p) for p in self.pending]
            self._n_lied = 0

        # condition on pending rows the current surrogates have not seen
        for i in range(self._n_lied, len(self._pending_n)):
            self._apply_lie(self._pending_n[i], lie, lie_train_iterations)
        self._n_lied = len(self._pending_n)

        candidates = []
        for b in range(batch_size):
            sub = self._next_run_key()
            if self.problem.constraint:
                if constraint_handling == "PoF":
                    self.constrained_IC = PoF(self.feasible_0, self.d)
                    pick = self.constrained_IC.optimize_with_IC(
                        self.IC, self.model_Y, self.model_C, bounds,
                        popsize_DE=popsize_DE, popstd_DE=popstd_DE,
                        iterations_DE=iterations_DE, init_adam=init_adam,
                        iterations_adam=iterations_adam, method=IC_method,
                        key=sub,
                    )
                elif constraint_handling == "EV":
                    self.constrained_IC = EV(self.feasible_0, self.d)
                    pick = self.constrained_IC.optimize_with_IC(
                        self.IC, self.model_Y, self.model_C, bounds,
                        threshold=threshold, popsize_DE=popsize_DE,
                        popstd_DE=popstd_DE, iterations_DE=iterations_DE,
                        init_adam=init_adam, iterations_adam=iterations_adam,
                        method=IC_method, analytic=analytic, key=sub,
                    )
                else:
                    raise ValueError(
                        f"unknown constraint_handling {constraint_handling!r}"
                    )
            else:
                pick = self.IC.optimize(
                    self.model_Y, bounds, popsize_DE=popsize_DE,
                    popstd_DE=popstd_DE, iterations_DE=iterations_DE,
                    init_adam=init_adam, iterations_adam=iterations_adam,
                    method=IC_method, analytic=analytic, key=sub,
                )
            candidates.append(np.asarray(pick).reshape(1, self.d))
            if b < batch_size - 1:
                self._apply_lie(candidates[-1], lie, lie_train_iterations)
        # denormalize the whole batch against the PRE-append archive:
        # every candidate was proposed in that normalization
        if self.normalize_input:
            raw = [denormalize(x_n, self.X) for x_n in candidates]
        else:
            raw = candidates
        self.added_points = np.vstack(candidates)
        return raw

    # -- ask/tell interface ---------------------------------------------------------
    def suggest(self, batch_size=1, **propose_kwargs):
        """Ask/tell interface, step 1: train the
        surrogates and return ``batch_size`` proposed points as a raw-
        coordinate [q, d] array WITHOUT evaluating the problem — for
        external/asynchronous evaluation (simulators the loop cannot call).
        Feed the results back with :meth:`observe`. Accepts the same
        keyword arguments as :meth:`run` (IC=, IC_method=, lie=, ...).

        Every suggested point is registered in :attr:`pending` and
        conditions later proposals as a believer lie until :meth:`observe`
        resolves it — so back-to-back ``suggest()`` calls without an
        ``observe()`` propose *different* points (a genuinely asynchronous
        lab can keep asking while evaluations are in flight), and
        ``suggest(1); suggest(1); observe(both)`` walks the same surrogate
        state and key stream as one ``suggest(2)``. Abandon outstanding
        points with :meth:`clear_pending`.

        ``suggest``/``observe`` and ``run`` share the infill counter and
        PRNG stream, so they can be interleaved (and checkpointed with
        save/load — pending state included) freely."""
        raw = self._propose(batch_size=batch_size, _continue_batch=True,
                            **propose_kwargs)
        arr = np.vstack(raw)
        self.pending = np.vstack([self.pending, arr])
        # the picks were proposed in the CURRENT normalization — keep their
        # normalized coords so in-batch continuation conditions on exactly
        # the optimized coordinates (renormalizing raw would round-trip
        # through denormalize and can clip at the domain box)
        self._pending_n.extend(
            row[None] for row in np.asarray(self.added_points))
        # _propose already conditioned the surrogates on all old pending
        # rows and on every in-batch pick except the last
        self._n_lied = len(self._pending_n) - 1
        self._batch_open = True
        return arr

    def observe(self, X_new, Y_new, C_new=None):
        """Ask/tell interface, step 2: append externally evaluated points
        (raw coordinates + objective values, and constraint values for
        constrained problems), update the feasible set / Ymin trace /
        normalization, resolve matching :attr:`pending` entries, and
        advance the infill counter."""
        X_new = np.asarray(X_new, dtype=float).reshape(-1, self.d)
        Y_new = np.asarray(Y_new, dtype=float).reshape(len(X_new), -1)
        if C_new is not None:
            C_new = np.asarray(C_new, dtype=float).reshape(len(X_new), -1)
        for i in range(len(X_new)):
            self._append_observation(
                X_new[i], Y_new[i], C_new[i] if C_new is not None else None)
        self._resolve_pending(X_new)
        self._iteration += 1

    def _resolve_pending(self, X_obs):
        """Remove observed rows from the pending registry (shared policy,
        :func:`resolve_pending_rows`)."""
        keep = resolve_pending_rows(self.pending, X_obs, self.d)
        self.pending = np.asarray(self.pending,
                                  dtype=float).reshape(-1, self.d)[keep]

    def _as_model_data(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _rebind_data(self):
        as_t = self._as_model_data
        self.model_Y.data = (as_t(self.X_train), as_t(self.Y_train))
        if self.problem.constraint:
            for i in range(self.C.shape[1]):
                self.model_C[i].data = (
                    as_t(self.X_train),
                    as_t(self.C_train[:, i].reshape(-1, 1)),
                )

    def add_point(self, x_new=None):
        """Evaluate the problem at the new point, append, renormalize
        With ``x_new=None`` (the single-pick path) the
        point is ``added_points`` [1, d] in normalized coordinates;
        batched callers pass a raw-coordinate row directly."""
        if x_new is None:
            x_new_n = np.asarray(self.added_points).reshape(1, self.d)
            if self.normalize_input:
                x_new = denormalize(x_new_n, self.X)
            else:
                x_new = x_new_n
        x_new = np.asarray(x_new, dtype=float).reshape(1, self.d)
        out = self.problem.fun(x_new)
        self._append_observation(
            x_new, out[0], out[1] if self.problem.constraint else None)

    def _append_observation(self, x_new, y_new, c_new=None):
        """Archive bookkeeping for ONE observed point: append, update the
        feasible set + Ymin trace, renormalize, rebind surrogate data."""
        x_new = np.asarray(x_new, dtype=float).reshape(1, self.d)
        if self.problem.constraint and c_new is None:
            # validate BEFORE any append — a raised observe() must leave
            # the archive untouched
            raise ValueError(
                "constrained problem: constraint values are required")
        self.X = np.append(self.X, x_new, axis=0)
        self.Y = np.append(self.Y, np.reshape(y_new, (1, -1)), axis=0)
        if self.problem.constraint:
            self.C = np.append(self.C, np.reshape(c_new, (1, -1)), axis=0)
            if self.C[-1].max() <= 0:
                # append as rows: an axis-less np.append would flatten the
                # feasible archive to 1-D,
                # interleaving coordinates for d > 1
                self.Yfeasible = np.append(
                    np.asarray(self.Yfeasible).reshape(-1, self.Y.shape[1]),
                    self.Y[-1:], axis=0)
                self.Xfeasible = np.append(
                    np.asarray(self.Xfeasible).reshape(-1, self.d),
                    self.X[-1:], axis=0)
                self.Ymin = np.append(self.Ymin, np.min(self.Yfeasible))
            else:
                self.Ymin = np.append(self.Ymin, self.Ymin[-1])
        else:
            self.Yfeasible = self.Y
            self.Xfeasible = self.X
            self.Ymin = np.append(self.Ymin, np.min(self.Y))
        self._refresh_normalization()
        self._rebind_data()
        # the archive (and its normalization) changed: any in-progress
        # suggest continuation is stale, and the rebind stripped all lies
        self._batch_open = False
        self._pending_n = []
        self._n_lied = 0

    # -- checkpoint / resume ------------------------------------------------------
    def save(self, path: str):
        """Checkpoint the BO state as one .npz (written atomically): the
        data archive, the Ymin trace, the seed stream's position, the infill
        counter, the pending rows and every surrogate tensor by name. The
        format is the port's own; it does not read the JAX package's."""
        state = {
            "X": self.X,
            "Y": self.Y,
            "Ymin": np.asarray(self.Ymin, dtype=float),
            "run_gen": self._run_gen.get_state().numpy(),
            "seed": np.asarray(self._seed if self._seed is not None else -1),
            "n_bucket": np.asarray(self.n_bucket or 0),
            "normalize_input": np.asarray(bool(self.normalize_input)),
            "iteration": np.asarray(self._iteration),
            "pending": self.pending,
        }
        if self.problem.constraint:
            state["C"] = self.C
        for prefix, model in self._prefixed_models():
            for name, t in training.named_tensors(model.params):
                state[f"{prefix}.{name}"] = t.detach().cpu().numpy()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **state)
        os.replace(tmp, path)

    def _prefixed_models(self):
        yield "mY", self.model_Y
        if self.problem.constraint:
            for k, m in enumerate(self.model_C):
                yield f"mC{k}", m

    @classmethod
    def load(cls, path: str, problem, model_Y_dic, model_C_dic=None,
             device=None, dtype=None):
        """Rebuild a BO loop from :meth:`save`. ``problem`` and the spec
        dicts are user objects and must be supplied again (they are not
        saved); ``device`` and ``dtype`` as for the constructor."""
        data = np.load(path)
        seed = int(data["seed"])
        bo = cls(
            problem=problem,
            X=data["X"],
            Y=data["Y"],
            C=data["C"] if "C" in data.files else None,
            model_Y_dic=model_Y_dic,
            model_C_dic=model_C_dic,
            normalize_input=bool(data["normalize_input"]),
            seed=None if seed == -1 else seed,
            n_bucket=int(data["n_bucket"]) or None,
            device=device,
            dtype=dtype,
        )
        with torch.no_grad():
            for prefix, model in bo._prefixed_models():
                for name, t in training.named_tensors(model.params):
                    arr = data[f"{prefix}.{name}"]
                    if arr.shape != tuple(t.shape):
                        raise ValueError(
                            f"checkpoint tensor {prefix}.{name} has shape "
                            f"{arr.shape}, the rebuilt model expects "
                            f"{tuple(t.shape)}: was it written with another "
                            "spec or n_bucket?")
                    t.copy_(torch.as_tensor(arr))
        bo.Ymin = list(np.asarray(data["Ymin"], dtype=float))
        bo._run_gen.set_state(torch.as_tensor(data["run_gen"]))
        bo._iteration = int(data["iteration"])
        bo.pending = np.asarray(data["pending"], dtype=float).reshape(-1, bo.d)
        return bo
