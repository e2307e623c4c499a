"""Multi-objective Bayesian optimization driver (counterpart of
``dgp_tpu/bo/mo_bo.py``): bi-objective minimization over [0, 1]^d with
EHVI infill, the nb_modgp notebook's loop (train a surrogate, build the
padded non-dominated front, maximize EHVI, evaluate, append, retrain) as a
driver with SO_BO's conventions: LHS DoE, input/output normalization, a
persistent seed stream across ``run()`` calls, batch infill with believer
lies, the ask/tell interface with its pending registry, and save/load.

Per infill the surrogate is rebuilt and retrained from scratch, as the
notebook does. The default surrogate is a pair of independent exact GPRs
(:data:`DEFAULT_MODEL_DIC`; the JAX package's bake-off,
``benchmarks/mo_bo_bakeoff.py``, measured it best on hypervolume and wall
time). A dict without ``'type'`` selects the notebook's coupled
:class:`~dgp_tpu_torch.models.mo_dgp.MultiObjDeepGP`, whose default
``restarts='auto'`` escalates to a best-of-k multi-start only when the
trained surrogate's fit score flags a bad basin.

The archive (X, F, C) and its normalization stay numpy on the host; the
surrogates live on ``device`` (the card unless the caller names another) in
``dtype``. The run's seed stream is an int key advanced by
``acquisition.split_key``, as the JAX package advances its PRNG key, so a
checkpoint stores one integer; the draws are PyTorch's, so a run takes
other (equally valid) steps than the JAX package's from the same seed. The
DoE, numpy in both, is the same, and so are the padded inducing rows of
the coupled surrogate.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..models import training
from ..models.dgp import moment_matched
from ..models.mo_dgp import MultiObjDeepGP
from .acquisition import split_key
from .doe import lhs
from .ehvi import HV_calcul, NDC, Y_ND, optimize_EHVI, pad_front
from .so_bo import (_safe_std, denormalize, fantasy_mean, make_single_model,
                    normalize, normalize_X, resolve_pending_rows)

#: The measured default surrogate (module docstring): two exact GPRs.
DEFAULT_MODEL_DIC = {"type": "independent", "num_layers": 0,
                     "kernels": "rbf", "iterations": 2000}


class MO_BO:
    """Bi-objective minimization over [0, 1]^d with EHVI infill.

    :param problem: a ``bo.problems.MOProblem`` (``dim``, ``bounds`` =
        (ideal1, ideal2, nadir1, nadir2) hypervolume reference box,
        ``fun(x) -> [f1, f2]``, and ``con(x)`` / ``n_con`` where
        constrained).
    :param model_dic: surrogate spec. ``None`` uses
        :data:`DEFAULT_MODEL_DIC`. A dict WITHOUT ``'type'`` (or
        ``{'type': 'mo_dgp', ...}``) is the coupled MO-DGP: {'loop': 2,
        'num_samples': 5, 'schedule': (it1, it2, it3), 'restarts':
        'auto'}, the schedule (100, 0, 0) unless given. ``{'type':
        'independent', 'num_layers': L, ...}`` builds per-objective GPR
        (L = 0, 'iterations' Adam steps each) or DGP (L >= 1, 'schedule'
        (it1, it2), (100, 0) unless given) pairs via
        so_bo.make_single_model.
    :param X, F: optional known DoE: X [n, d] and F a list of two [n, 1]
        objective columns; otherwise an LHS DoE of ``DoE_size`` points is
        drawn and evaluated.
    :param C: optional known [n, n_con] constraint values (<= 0 feasible);
        evaluated by ``problem.con`` when omitted.
    :param model_C_dic: the constraint surrogates' spec ({'kernels': 'rbf',
        'iterations': 2000} unless given): one exact GPR per constraint,
        trained per infill; the acquisition becomes EHVI(x) * prod_i
        PoF_i(x), with a PoF-only bootstrap while no point is feasible.
    :param n_bucket: pad the surrogates' rows (and the coupled model's
        default inducing rows) to multiples of this, so the sizes, and so
        the kernels' launch shapes, change only at bucket boundaries.
    :param device: where the surrogates live and run; the card unless
        given. With no card and no ``device``, construction raises.
    :param dtype: the surrogates' dtype (default ``config.default_float()``).
    """

    def __init__(self, problem=None, X=None, F=None, C=None, DoE_size=None,
                 model_dic: Optional[dict] = None,
                 model_C_dic: Optional[dict] = None,
                 seed: Optional[int] = None, n_bucket: Optional[int] = 8,
                 device=None, dtype=None):
        if problem is None:
            raise ValueError("You have to specify a problem to optimize")
        self.problem = problem
        self.d = problem.dim
        # None -> the measured default (independent GPR pair); an explicit
        # dict without 'type' means the notebook's coupled MO-DGP
        self.model_dic = dict(DEFAULT_MODEL_DIC if model_dic is None
                              else model_dic)
        self.n_con = int(getattr(problem, "n_con", 0) or 0)
        self.model_C_dic = dict(model_C_dic
                                or {"kernels": "rbf", "iterations": 2000})
        self._seed = seed
        self.n_bucket = n_bucket

        if X is None and DoE_size is None:
            raise ValueError(
                "You have to specify either a size to generate a DoE or "
                "a known DoE (X, F)")
        # before the problem is evaluated
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        if X is None:
            X = lhs(self.d, DoE_size, seed=seed)
            F = self._evaluate(X)
            C = self._evaluate_cons(X)
        else:
            X = np.array(X, copy=True)
            F = [np.array(f, copy=True).reshape(-1, 1) for f in F]
            if self.n_con and C is None:
                C = self._evaluate_cons(X)
        self.X = X
        self.F = F
        # feasibility column(s) for the filtered non-dominated sort (NDC,
        # feasible iff max <= 0): real constraint values for constrained
        # problems, the all-pass -1 column otherwise
        self.C = (np.array(C, copy=True).reshape(len(X), -1)
                  if self.n_con else -np.ones((len(X), 1)))

        self.hv_trace: List[float] = [self._hv()]
        self.added_points: List[np.ndarray] = []
        # pending registry (asynchronous ask/tell): raw-coordinate rows
        # suggested but not yet observed. They stay on the fantasy front
        # (and, for independent surrogates, in the surrogate data as
        # believer lies) across suggest() calls, and survive save/load.
        self.pending = np.zeros((0, self.d))
        # in-memory continuation state (not saved): the pending rows'
        # normalized coordinates, how many of them the batch state
        # conditions on, and the in-progress batch state itself
        self._pending_n: List[np.ndarray] = []
        self._n_lied = 0
        self._batch_open = False
        self._bstate = None
        self._run_key = seed or 0
        self._iteration = 0

    # -- helpers ----------------------------------------------------------------
    def _evaluate(self, X):
        rows = [self.problem.fun(x) for x in X]
        return [np.asarray([np.reshape(r[i], ()) for r in rows],
                           dtype=float).reshape(-1, 1) for i in (0, 1)]

    def _evaluate_cons(self, X):
        """[n, n_con] constraint values (<= 0 feasible), or None."""
        if not self.n_con:
            return None
        return np.asarray([self.problem.con(x) for x in X], dtype=float)

    def _as_tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _make_train_con_models(self, Xn):
        """Per-infill constraint surrogates: one exact GPR on each
        normalized constraint column, and the feasibility threshold in that
        normalized space (the image of 0). (None, None) for unconstrained
        problems."""
        if not self.n_con:
            return None, None
        if self.model_C_dic.get("num_layers", 0) != 0:
            raise ValueError(
                "MO_BO constraint surrogates are exact GPRs "
                "(model_C_dic['num_layers'] must be 0 or absent)")
        model_C, zero_n = [], []
        for i in range(self.n_con):
            c = self.C[:, i:i + 1]
            spec = {"num_layers": 0,
                    "kernels": self.model_C_dic.get("kernels", "rbf")}
            m = make_single_model(spec, Xn, normalize(c),
                                  n_bucket=self.n_bucket, seed=self._seed,
                                  device=self.device, dtype=self.dtype)
            m.optimize_adam(
                iterations=int(self.model_C_dic.get("iterations", 2000)),
                lr=0.001)
            model_C.append(m)
            zero_n.append(float((0.0 - c.mean()) / _safe_std(c).item()))
        return model_C, np.asarray(zero_n)

    def _next_run_key(self):
        """The next acquisition seed; the stream advances by split_key."""
        self._run_key, sub = split_key(self._run_key)
        return sub

    def _hv(self):
        return HV_calcul(NDC(self.F, self.C), self.F, self.problem.bounds)

    def pareto(self):
        """(X_nd, F_nd): the current feasible non-dominated set."""
        nd = NDC(self.F, self.C)
        F = np.hstack(self.F)
        return self.X[nd], F[nd]

    def _normalized(self):
        """(Xn, Fn, lw_n, up_n): normalized data and the [0,1]^d domain box
        mapped through the same normalization (zero-variance columns
        guarded by so_bo._safe_std). The EHVI search runs over the mapped
        box, not the unit box of normalized coordinates (which would
        confine denormalized proposals to [mean, mean+std] per
        dimension)."""
        Xn, lw_n, up_n = normalize_X(self.X)
        Fn = [normalize(f) for f in self.F]
        return Xn, Fn, lw_n, up_n

    def _bucketed_inducing(self, Xn, Fn):
        """MO-DGP's default inducing rows (Z0 = [X, Y_2], Z1 = X) padded to
        the bucket with distinct in-range rows (duplicates would make Kuu
        singular; extra inducing points only add variational capacity)."""
        Z = [np.concatenate([Xn, np.asarray(Fn[1])], axis=1), Xn.copy()]
        if not self.n_bucket:
            return Z
        rng = np.random.default_rng(self._seed or 0)
        out = []
        for z in Z:
            n, d = z.shape
            n_pad = training.bucket_rows(n, self.n_bucket)
            if n_pad > n:
                lo, hi = z.min(axis=0), z.max(axis=0)
                extra = rng.uniform(size=(n_pad - n, d)) * (hi - lo) + lo
                z = np.concatenate([z, extra], axis=0)
            out.append(z)
        return out

    def make_model(self, Xn, Fn, seed):
        """Untrained surrogate per model_dic['type'] on this loop's device
        and dtype: ``"mo_dgp"`` (no ``'type'``), the coupled recurrent
        MultiObjDeepGP; ``"independent"``, a list of two per-objective
        surrogates from so_bo.make_single_model (``num_layers=0`` exact
        GPRs or ``num_layers>=1`` DGPs), over which EHVI is evaluated."""
        mtype = self.model_dic.get("type", "mo_dgp")
        on = dict(device=self.device, dtype=self.dtype)
        if mtype == "mo_dgp":
            return MultiObjDeepGP(
                [Xn, Xn.copy()], Fn, Z=self._bucketed_inducing(Xn, Fn),
                loop=int(self.model_dic.get("loop", 2)),
                num_samples=int(self.model_dic.get("num_samples", 5)),
                seed=seed, n_bucket=self.n_bucket, **on)
        if mtype == "independent":
            spec = {
                "num_layers": int(self.model_dic.get("num_layers", 0)),
                "kernels": self.model_dic.get("kernels", "rbf"),
                "num_units": self.model_dic.get("num_units", 1),
                "num_samples": int(self.model_dic.get("num_samples", 5)),
            }
            return [make_single_model(spec, Xn, np.asarray(f),
                                      n_bucket=self.n_bucket,
                                      seed=self._seed, **on)
                    for f in Fn]
        raise ValueError(f"unknown model_dic type {mtype!r}")

    def _train_model(self, model, sched, restarts):
        """Per-infill surrogate training (from scratch). mo_dgp: the
        three-phase staged natural-gradient schedule. GPR pair: Adam on the
        log marginal likelihood, model_dic['iterations'] (2,000) steps
        each. DGP pair: the two-phase Adam -> Adam+NatGrad trainer with
        (sched[0], sched[1])."""
        if not isinstance(model, list):
            model.optimize_nat_adam(
                iterations1=sched[0], iterations2=sched[1],
                iterations3=sched[2], messages=0, restarts=restarts)
            return
        for m in model:
            if m.name == "gpr":
                m.optimize_adam(
                    iterations=int(self.model_dic.get("iterations", 2000)),
                    lr=0.001)
            else:
                m.optimize_nat_adam(iterations1=sched[0],
                                    iterations2=sched[1], messages=0)

    # -- batch (q-point) infill helpers -------------------------------------------
    def _fantasy_objectives(self, model, x_n):
        """Believer lie values for both objectives at x_n [1, d]: the
        surrogate posterior means in normalized objective space."""
        if isinstance(model, list):
            return [float(fantasy_mean(m, x_n)[0, 0]) for m in model]
        out = []
        for i in (0, 1):
            m_s, v_s = model.predict_f(x_n, S=64, objective=i)
            m, _ = moment_matched(m_s, v_s)
            out.append(float(m.reshape(-1)[0]))
        return out

    def _condition_on_lie(self, model, model_C, x_n, f_lie_n,
                          lie_train_iterations):
        """Append the fantasized (normalized) observation to the surrogate
        training data. Exact posterior conditioning for GPRs (their
        posterior recomputes from ``data``); DGP pairs take a short warm
        Adam refit (the SVGP posterior only moves through training). The
        coupled MO-DGP is not conditioned: its in-batch deduplication comes
        from the fantasy front alone (EHVI at a point whose believer outcome
        is already on the front is ~0)."""

        def _append(m, y_val):
            Xt = np.vstack([m.data[0].cpu().numpy(), x_n])
            Yt = np.vstack([m.data[1].cpu().numpy(),
                            np.asarray(y_val, dtype=float).reshape(1, -1)])
            m.data = (self._as_tensor(Xt), self._as_tensor(Yt))
            iters = lie_train_iterations
            if iters is None:
                iters = 0 if m.name == "gpr" else 200
            if iters:
                if m.name == "gpr":
                    m.optimize_adam(iterations=iters, lr=0.001)
                else:
                    # shrink_inner=False: a warm refit, not a cold
                    # (re)train (SO_BO._apply_lie)
                    m.optimize_nat_adam(iterations1=iters, iterations2=0,
                                        messages=0, shrink_inner=False)

        if isinstance(model, list):
            for i, m in enumerate(model):
                _append(m, f_lie_n[i])
        if model_C:
            for m in model_C:
                _append(m, fantasy_mean(m, x_n))

    # -- the loop ---------------------------------------------------------------
    def run(self, iterations=1, approximation="None", S=1000, method="DE",
            popsize_DE=300, iterations_DE=400, iterations_adam=1000,
            batch_size=1, lie_train_iterations=None, verbose=True):
        """``iterations`` EHVI infills; returns the hypervolume trace
        (the initial DoE hypervolume at index 0).

        :param approximation: EHVI estimator: "None" (exact 2-D),
            "Gaussian", or "KDE" (bo/ehvi.py).
        :param batch_size: q points per infill. After each in-batch pick
            the believer outcome (posterior means of both objectives) joins
            a fantasy front and, for independent surrogates, the surrogate
            data (Kriging Believer, Ginsbourger et al. 2010), so the batch
            spreads. The hypervolume trace and archive record only real
            evaluations.
        :param lie_train_iterations: in-batch refit steps after each lie
            (None = 0 for exact GPRs, whose conditioning is exact, and 200
            Adam steps for DGP pairs).
        """
        for _ in range(iterations):
            it = self._iteration
            raw = self._propose(
                batch_size=batch_size, approximation=approximation, S=S,
                method=method, popsize_DE=popsize_DE,
                iterations_DE=iterations_DE,
                iterations_adam=iterations_adam,
                lie_train_iterations=lie_train_iterations)
            for x_new in raw:
                f_new = self._evaluate(x_new)
                c_new = self._evaluate_cons(x_new)

                self.X = np.vstack([self.X, x_new])
                self.F = [np.vstack([self.F[i], f_new[i]]) for i in (0, 1)]
                self.C = np.vstack([self.C, c_new if self.n_con
                                    else [[-1.0]]])
                self.added_points.append(x_new)
                self.hv_trace.append(self._hv())
                if verbose:
                    print(f"infill {it}: x={np.round(x_new.ravel(), 4)} "
                          f"f=({f_new[0].item():.4f}, {f_new[1].item():.4f}) "
                          f"HV={self.hv_trace[-1]:.5f}", flush=True)
            self._archive_changed()
            self._iteration += 1
        return list(self.hv_trace)

    def _normalize_x(self, x_raw):
        """Raw [1, d] -> the surrogate's normalized input coordinates."""
        x_raw = np.asarray(x_raw, dtype=float).reshape(1, self.d)
        return (x_raw - self.X.mean(axis=0)) / _safe_std(self.X)

    def clear_pending(self):
        """Drop every suggested-but-unobserved point; their believer
        outcomes stop conditioning proposals at the next fresh batch."""
        self.pending = np.zeros((0, self.d))
        self._pending_n = []
        self._n_lied = 0
        self._batch_open = False
        self._bstate = None

    def _fresh_batch_state(self, it):
        """Train surrogates on the real archive and freeze the batch state:
        the normalized domain box, the objective-normalization stats, the
        hypervolume box mapped through them, and fantasy copies of the
        archive (believer outcomes land there, and in the surrogate data,
        never in self.F/self.C). The stats stay frozen for the whole batch:
        the surrogate was trained under them."""
        sched = self.model_dic.get("schedule", (100, 0, 0))
        # "auto" = run once, escalate to best-of-k only on a measured bad
        # basin (MultiObjDeepGP.optimize_nat_adam)
        restarts = self.model_dic.get("restarts", "auto")
        if restarts != "auto":
            restarts = int(restarts)
        Xn, Fn, lw_n, up_n = self._normalized()
        model = self.make_model(Xn, Fn, seed=it)
        self._train_model(model, sched, restarts)
        model_C, zero_n = self._make_train_con_models(Xn)

        b = self.problem.bounds
        f0, f1 = self.F
        mu = (f0.mean(), f1.mean())
        sd = (_safe_std(f0).item(), _safe_std(f1).item())
        nadir = (float((b[2] - mu[0]) / sd[0]),
                 float((b[3] - mu[1]) / sd[1]))
        ideal = (float((b[0] - mu[0]) / sd[0]),
                 float((b[1] - mu[1]) / sd[1]))
        return dict(model=model, model_C=model_C, zero_n=zero_n,
                    mu=mu, sd=sd, nadir=nadir, ideal=ideal,
                    lw_n=lw_n, up_n=up_n,
                    F_fant=[self.F[0].copy(), self.F[1].copy()],
                    C_fant=self.C.copy())

    def _lie_at(self, st, x_n, lie_train_iterations):
        """Fantasize a believer outcome at normalized ``x_n``: append it to
        the batch state's fantasy front (raw objective units) and condition
        the independent surrogates on it."""
        f_lie_n = self._fantasy_objectives(st["model"], x_n)
        mu, sd = st["mu"], st["sd"]
        st["F_fant"] = [np.vstack([st["F_fant"][i],
                                   [[f_lie_n[i] * sd[i] + mu[i]]]])
                        for i in (0, 1)]
        if self.n_con:
            # believer constraint row: the fantasy point counts as feasible
            # for the fantasy front iff every constraint surrogate's mean is
            c_row = [1.0 if float(fantasy_mean(st["model_C"][i],
                                               x_n)[0, 0]) > st["zero_n"][i]
                     else -1.0 for i in range(self.n_con)]
            st["C_fant"] = np.vstack([st["C_fant"], [c_row]])
        else:
            st["C_fant"] = np.vstack([st["C_fant"], [[-1.0]]])
        self._condition_on_lie(st["model"], st["model_C"], x_n, f_lie_n,
                               lie_train_iterations)

    def _propose(self, batch_size=1, approximation="None", S=1000,
                 method="DE", popsize_DE=300, iterations_DE=400,
                 iterations_adam=1000, lie_train_iterations=None,
                 verbose=False, _continue_batch=False):
        """One acquisition round: train a fresh surrogate on the current
        archive, maximize EHVI ``batch_size`` times with believer
        conditioning and fantasy-front updates between picks, and return
        the picks as raw-coordinate [1, d] rows (clipped to the domain box;
        the archive is not touched).

        Outstanding :attr:`pending` points always join the fantasy front
        (and condition independent surrogates) before picking. With
        ``_continue_batch`` (the suggest() path) and an unchanged archive,
        the in-progress batch state is reused: a second suggest() before any
        observe() continues the batch exactly as one larger batch_size
        would."""
        cont = (_continue_batch and self._batch_open
                and len(self.pending) > 0 and self._bstate is not None)
        if not cont:
            self._bstate = self._fresh_batch_state(self._iteration)
            self._pending_n = [self._normalize_x(p) for p in self.pending]
            self._n_lied = 0
        st = self._bstate
        # condition on pending rows the current batch state has not seen
        for i in range(self._n_lied, len(self._pending_n)):
            self._lie_at(st, self._pending_n[i], lie_train_iterations)
        self._n_lied = len(self._pending_n)

        picks = []
        for bq in range(batch_size):
            # the nadir corner repeated up to the bucket: zero-width
            # staircase segments leave every estimator unchanged and keep
            # its shapes stable while the front grows. Constrained problems
            # can start with no feasible row: then there is no front, and
            # optimize_EHVI runs the PoF-only bootstrap (YND=None)
            NDT = NDC(st["F_fant"], st["C_fant"], obj1_ascending=False)
            Fn_fant = [(st["F_fant"][i] - st["mu"][i]) / st["sd"][i]
                       for i in (0, 1)]
            YND = (pad_front(Y_ND(Fn_fant, NDT, nadir=st["nadir"],
                                  ideal=st["ideal"]), self.n_bucket)
                   if len(NDT) else None)

            x_opt_n = optimize_EHVI(
                st["model"], YND, method=method, popsize_DE=popsize_DE,
                iterations_DE=iterations_DE,
                iterations_adam=iterations_adam,
                approximation=approximation, S=S,
                bounds=(st["lw_n"], st["up_n"]),
                key=self._next_run_key(),
                model_C=st["model_C"], zero_c=st["zero_n"])
            x_opt_n = np.asarray(x_opt_n, dtype=float).reshape(1, self.d)
            picks.append(x_opt_n)
            if bq < batch_size - 1:
                self._lie_at(st, x_opt_n, lie_train_iterations)

        # normalized picks for suggest()'s pending bookkeeping
        self._proposed_n = picks
        # denormalize against the batch-start archive (self.X is untouched
        # here, so its stats are the frozen ones every pick was proposed
        # in) and clip to the domain box
        return [np.clip(denormalize(x_opt_n, self.X), 0.0, 1.0)
                for x_opt_n in picks]

    # -- ask/tell interface ---------------------------------------------------------
    def suggest(self, batch_size=1, **propose_kwargs):
        """Ask/tell, step 1: train a fresh surrogate and return
        ``batch_size`` EHVI-proposed points as a raw-coordinate [q, d] array
        without evaluating the problem. Feed results back with
        :meth:`observe`. Takes :meth:`run`'s keyword arguments and shares
        its infill counter and seed stream.

        Every suggested point is registered in :attr:`pending` and joins
        the fantasy front until :meth:`observe` resolves it, so back-to-back
        ``suggest()`` calls propose different points, and ``suggest(1);
        suggest(1); observe(both)`` walks the same batch state and key
        stream as one ``suggest(2)``. Abandon outstanding points with
        :meth:`clear_pending`; pending state survives save/load."""
        raw = self._propose(batch_size=batch_size, _continue_batch=True,
                            **propose_kwargs)
        arr = np.vstack(raw)
        self.pending = np.vstack([self.pending, arr])
        # keep the exact normalized coords the picks were optimized in
        # (renormalizing raw would round-trip through the domain clip)
        self._pending_n.extend(self._proposed_n)
        # _propose conditioned on all old pending rows and on every
        # in-batch pick except the last
        self._n_lied = len(self._pending_n) - 1
        self._batch_open = True
        return arr

    def observe(self, X_new, F_new, C_new=None):
        """Ask/tell, step 2: append externally evaluated points.

        :param X_new: [q, d] raw coordinates.
        :param F_new: the two objective columns: a list/tuple of two
            [q]- or [q, 1]-shaped arrays, or one [q, 2] array.
        :param C_new: [q, n_con] constraint values for constrained
            problems (<= 0 feasible)."""
        X_new = np.asarray(X_new, dtype=float).reshape(-1, self.d)
        q = len(X_new)
        if isinstance(F_new, (list, tuple)):
            F_cols = [np.asarray(F_new[i], dtype=float).reshape(q, 1)
                      for i in (0, 1)]
        else:
            F_new = np.asarray(F_new, dtype=float).reshape(q, 2)
            F_cols = [F_new[:, i:i + 1] for i in (0, 1)]
        if self.n_con:
            if C_new is None:
                raise ValueError(
                    "constrained problem: constraint values are required")
            C_rows = np.asarray(C_new, dtype=float).reshape(q, self.n_con)
        for i in range(q):
            self.X = np.vstack([self.X, X_new[i:i + 1]])
            self.F = [np.vstack([self.F[j], F_cols[j][i:i + 1]])
                      for j in (0, 1)]
            self.C = np.vstack([self.C, C_rows[i:i + 1] if self.n_con
                                else [[-1.0]]])
            self.added_points.append(X_new[i:i + 1])
            self.hv_trace.append(self._hv())
        self._resolve_pending(X_new)
        self._archive_changed()
        self._iteration += 1
        return list(self.hv_trace)

    def _resolve_pending(self, X_obs):
        """Remove observed rows from the pending registry (shared policy,
        :func:`so_bo.resolve_pending_rows`)."""
        keep = resolve_pending_rows(self.pending, X_obs, self.d)
        self.pending = np.asarray(self.pending,
                                  dtype=float).reshape(-1, self.d)[keep]

    def _archive_changed(self):
        """The archive (and its normalization) changed: any in-progress
        batch state is stale."""
        self._batch_open = False
        self._bstate = None
        self._pending_n = []
        self._n_lied = 0

    # -- checkpoint / resume -----------------------------------------------------
    def save(self, path: str):
        """One .npz (written atomically) with the data archive, the
        hypervolume trace, the seed stream's key, the infill counter, the
        specs and the pending rows. The surrogate retrains from scratch
        every infill, so these reproduce the continuation exactly. The
        format is the port's own; it does not read the JAX package's."""
        state = {
            "X": self.X, "F0": self.F[0], "F1": self.F[1], "C": self.C,
            "hv_trace": np.asarray(self.hv_trace, dtype=float),
            "run_key": np.asarray(self._run_key, dtype=np.int64),
            "seed": np.asarray(self._seed if self._seed is not None else -1),
            "iteration": np.asarray(self._iteration),
            "n_bucket": np.asarray(self.n_bucket or 0),
            # the surrogate spec travels with the checkpoint: a resume that
            # forgot to pass model_dic again would otherwise retrain with
            # defaults and break the exact continuation
            "model_dic": np.asarray(json.dumps(self.model_dic)),
            "model_C_dic": np.asarray(json.dumps(self.model_C_dic)),
            "added_points": (np.concatenate(self.added_points, axis=0)
                             if self.added_points
                             else np.zeros((0, self.d))),
            "pending": self.pending,
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **state)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, problem, model_dic=None, device=None,
             dtype=None):
        """Restore a saved loop. ``model_dic`` defaults to the dict the
        checkpoint was saved with; pass one only to override it. ``device``
        and ``dtype`` as for the constructor."""
        data = np.load(path)
        seed = int(data["seed"])
        if model_dic is None:
            model_dic = json.loads(str(data["model_dic"]))
            if isinstance(model_dic.get("schedule"), list):
                model_dic["schedule"] = tuple(model_dic["schedule"])
        bo = cls(problem=problem, X=data["X"], F=[data["F0"], data["F1"]],
                 C=data["C"] if getattr(problem, "n_con", 0) else None,
                 model_dic=model_dic,
                 model_C_dic=json.loads(str(data["model_C_dic"])),
                 seed=None if seed == -1 else seed,
                 n_bucket=int(data["n_bucket"]) or None, device=device,
                 dtype=dtype)
        bo.hv_trace = [float(v) for v in data["hv_trace"]]
        bo._run_key = int(data["run_key"])
        bo._iteration = int(data["iteration"])
        bo.C = np.asarray(data["C"], dtype=float)
        bo.added_points = [row[None, :] for row in
                           np.asarray(data["added_points"], dtype=float)]
        bo.pending = np.asarray(data["pending"],
                                dtype=float).reshape(-1, bo.d)
        return bo
