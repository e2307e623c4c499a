"""Infill criteria for single-objective BO (counterpart of
``dgp_tpu/bo/acquisition.py``): EI / WB2 / WB2S acquisitions, EV (expected
violation) and PoF (probability of feasibility) constraint handling, each
optimized by DE and Adam on a sigmoid box map.

As in the JAX package, the acquisition surface is evaluated with common
random numbers: one seed per optimize call, from which every evaluation
draws the same unit normals, so DE and Adam see a deterministic surface.
A key here is an int seed (``split_key`` and ``fold_in`` derive others from
it, as ``jax.random.split`` / ``fold_in`` do); the draws are PyTorch's, not
JAX's. The moments come from the pure model functions (``models/gpr.py``,
``models/cokriging.py``, ``models/nargp.py``, ``predict_y`` / ``predict_f`` /
``propagate`` of ``models/dgp.py``, ``models/mf_dgp.py`` and
``models/mf_dgp_em.py``), not from the wrappers' ``@torch.no_grad``
methods, because Adam refinement needs the acquisition's gradient in x. The
JAX package caches each loss function so its compiled optimizers are
reused across infills; eager PyTorch compiles nothing, so the losses here
are plain closures.

Surrogate kinds (``model.name``): ``gpr``, ``dgp`` and the multi-fidelity
``ar1`` (exact), ``nargp``, ``mf_dgp`` and ``mf_dgp_EM`` (whose state kind
is ``em``), each predicting its highest fidelity; MC moments are moment
matched over the samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..models import cokriging as ar1_mod
from ..models import dgp as dgp_mod
from ..models import gpr as gpr_mod
from ..models import mf_dgp as mf_mod
from ..models import mf_dgp_em as em_mod
from ..models import nargp as nargp_mod
from . import de

# the sampled kinds' model functions, by state kind
_MC_MODELS = {"dgp": dgp_mod, "mf_dgp": mf_mod, "em": em_mod}


def split_key(key, num=2):
    """``num`` seeds derived from ``key`` (the counterpart of
    ``jax.random.split``)."""
    state = np.random.SeedSequence(int(key)).generate_state(num, np.uint64)
    return [int(s >> np.uint64(1)) for s in state]


def fold_in(key, i):
    """A seed derived from ``key`` and the integer ``i``."""
    state = np.random.SeedSequence([int(key), int(i)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _generator(key, device):
    """A fresh generator seeded with ``key``: every evaluation with the
    same key draws the same normals (common random numbers)."""
    return torch.Generator(device=device).manual_seed(int(key))


def _noise(key, device, kind="dgp"):
    """The draws of one evaluation: :func:`_generator`, or, where ``key``
    is a list of tensors, those fixed unit normals (the DGP's ``zs``, the
    other sampled models' ``noise``)."""
    if isinstance(key, (list, tuple)):
        return {"zs" if kind == "dgp" else "noise": key}
    return {"generator": _generator(key, device)}


def sigmoid_box_map(lw, up, V):
    """Unconstrained -> box: x = lw + (up-lw) / (1 + exp(V))."""
    return lw + (up - lw) / (1.0 + torch.exp(V))


def inverse_box_map(lw, up, x):
    """Box -> unconstrained init for Adam."""
    return torch.log((up - x + 1e-3) / (x - lw + 1e-3))


def _moment_matched(m_s, v_s):
    mean = torch.mean(m_s, dim=0)
    var = torch.mean(v_s + m_s ** 2, dim=0) - mean ** 2
    return mean, var


def _floored_sigma(var):
    """sqrt(var) with a variance floor: an exact-interpolation surrogate at
    an observed x drives var -> 0, and the z-scores would be 0/0."""
    return torch.sqrt(torch.clamp_min(var, 1e-12))


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _expected_improvement(y_min, mean, var):
    """EI(x) = (y_min - mu) Phi(z) + sigma phi(z)."""
    sigma = _floored_sigma(var)
    z = (y_min - mean) / sigma
    return (y_min - mean) * torch.special.ndtr(z) + sigma * _norm_pdf(z)


# -- pure model forwards ----------------------------------------------------------


def _model_state(model):
    """(kind, state) of a surrogate: a GPR, an AR(1) co-kriging and a NARGP
    carry (params, padded train data), the sampled deep GPs their
    parameters (the MF-DGPs' augmented inducing rows are recomputed from
    them in each evaluation)."""
    if model.name in ("gpr", "ar1", "nargp"):
        return model.name, (model.params, model.train_data)
    if model.name in ("dgp", "mf_dgp"):
        return model.name, model.params
    if model.name == "mf_dgp_EM":
        return "em", model.params
    # fail at the dispatch boundary: an unknown wrapper's parameters would
    # otherwise reach a model function and fail (or mis-predict) deep inside
    raise ValueError(
        f"unsupported surrogate kind {model.name!r} for acquisition moments; "
        "supported: gpr, ar1, nargp, mf_dgp, mf_dgp_EM, dgp")


def _mc_moments(kind, state, x, key, num_samples, predict):
    """``predict`` ('predict_f' or 'predict_y') of a sampled surrogate at
    its highest fidelity, moment matched over the samples."""
    noise = _noise(key, x.device, kind)
    if kind == "nargp":
        params, datas = state
        m_s, v_s = getattr(nargp_mod, predict)(params, datas, x, num_samples,
                                               **noise)
    else:
        m_s, v_s = getattr(_MC_MODELS[kind], predict)(state, x, num_samples,
                                                      **noise)
    return _moment_matched(m_s, v_s)


def _y_moments_pure(kind, state, x, key, num_samples):
    if kind == "gpr":
        return gpr_mod.predict_y(*state, x)
    if kind == "ar1":
        return ar1_mod.predict_y(*state, x, -1)
    return _mc_moments(kind, state, x, key, num_samples, "predict_y")


def _f_moments_pure(kind, state, x, key, num_samples):
    # a GPR's EI takes its predictive-y moments, as in the JAX package
    if kind == "gpr":
        return gpr_mod.predict_y(*state, x)
    if kind == "ar1":
        return ar1_mod.predict_f(*state, x, -1)
    return _mc_moments(kind, state, x, key, num_samples, "predict_f")


def _unit_normals(key, shape, like):
    """Unit normals of ``shape`` in ``like``'s dtype and device: drawn from
    the seed ``key``, or ``key`` itself where it is an array (a fixed
    draw)."""
    if torch.is_tensor(key) or isinstance(key, np.ndarray):
        return torch.as_tensor(key, dtype=like.dtype,
                               device=like.device).reshape(shape)
    return torch.randn(shape, dtype=like.dtype, device=like.device,
                       generator=_generator(key, like.device))


def _samples_pure(kind, state, x, key, num_samples):
    """Highest-fidelity samples [S, n, 1]: the exact surrogates' predictive
    normal, NARGP's per-sample predictive (its moments from one half of the
    key, the normals from the other), the deep GPs' last layer. A list key
    holds the draws in the JAX package's order: the exact surrogates' one,
    NARGP's predict_y's and then its sample's, the deep GPs' (``_noise``)."""
    fixed = isinstance(key, (list, tuple))
    if kind in ("gpr", "ar1"):
        mean, var = _y_moments_pure(kind, state, x, key, num_samples)
        z = _unit_normals(key[0] if fixed else key,
                          (num_samples,) + tuple(mean.shape), mean)
        return mean[None] + torch.sqrt(var)[None] * z
    if kind == "nargp":
        params, datas = state
        if fixed:
            noise, k2 = {"noise": list(key[:-1])}, key[-1]
        else:
            k1, k2 = split_key(key)
            noise = {"generator": _generator(k1, x.device)}
        m_s, v_s = nargp_mod.predict_y(params, datas, x, num_samples, **noise)
        z = _unit_normals(k2, m_s.shape, m_s)
        return m_s + torch.sqrt(torch.clamp_min(v_s, 0.0)) * z
    Fs, _, _ = _MC_MODELS[kind].propagate(state, x, num_samples,
                                          **_noise(key, x.device, kind))
    return Fs[-1]


def _ei_loss(kind, analytic, num_samples):
    """args = (state, y_min, key) -> -EI [n, 1]."""

    def loss(x, args):
        state, y_min, key = args
        if analytic:
            mean, var = _f_moments_pure(kind, state, x, key, num_samples)
            return -_expected_improvement(y_min, mean, var)
        F = _samples_pure(kind, state, x, key, num_samples)
        return -torch.mean(torch.clamp_min(y_min - F, 0.0), dim=0)

    return loss


def _wb2_loss(kind, num_samples):
    """args = (state, y_min, scale, key) -> -(scale*EI - mean); scale=1
    recovers WB2."""

    def loss(x, args):
        state, y_min, scale, key = args
        mean, var = _y_moments_pure(kind, state, x, key, num_samples)
        return -(scale * _expected_improvement(y_min, mean, var) - mean)

    return loss


def _ev_one_pure(kind, state, x, key, zero_c, analytic, num_samples):
    if analytic:
        S = 500 if kind == "dgp" else num_samples
        mean, var = _y_moments_pure(kind, state, x, key, S)
        sigma = _floored_sigma(var)
        z = (mean - zero_c) / sigma
        return (mean - zero_c) * torch.special.ndtr(z) + sigma * _norm_pdf(z)
    F = _samples_pure(kind, state, x, key, num_samples)
    return torch.mean(torch.clamp_min(F - zero_c, 0.0), dim=0)


def _ev_ic_loss(ic_loss, c_kinds, analytic, num_samples):
    """args = (ic_args, c_states, zero_c [n_c], threshold, key)."""

    def loss(x, args):
        ic_args, c_states, zero_c, threshold, key = args
        ev = torch.cat([
            _ev_one_pure(kind, c_states[i], x, fold_in(key, i), zero_c[i],
                         analytic, num_samples)
            for i, kind in enumerate(c_kinds)], dim=1)
        ev_max = torch.amax(ev, dim=1, keepdim=True)
        ei = ic_loss(x, ic_args)
        penalty = torch.sum(ev, dim=1, keepdim=True) + 10000.0
        return torch.where(ev_max > threshold, penalty, ei)

    return loss


def _pof_ic_loss(ic_loss, c_kinds, num_samples):
    """args = (ic_args, c_states, zero_c [n_c], key) -> -(EI * prod PoF_i).
    The IC loss is clamped to <= 0 before the weighting (weighting only
    preserves order for non-positive losses; WB2's can be positive)."""

    def loss(x, args):
        ic_args, c_states, zero_c, key = args
        pof = 1.0
        for i, kind in enumerate(c_kinds):
            mean, var = _y_moments_pure(kind, c_states[i], x, fold_in(key, i),
                                        num_samples)
            pof = pof * torch.special.ndtr((zero_c[i] - mean) / _floored_sigma(var))
        return torch.clamp_max(ic_loss(x, ic_args), 0.0) * pof

    return loss


def optimize_box(loss_fn, loss_args, bounds, d, popsize_DE=300, popstd_DE=1.5,
                 iterations_DE=400, init_adam=None, iterations_adam=1000,
                 lr_adam=0.01, method="DE", key=None, device=None, dtype=None):
    """DE + Adam-on-sigmoid optimizer over a box domain, the scaffold every
    acquisition drives its search through.

    ``loss_fn(x [P, d] in the box, loss_args) -> [P] or [P, 1]``. The search
    runs on ``device`` (the card unless given) in ``dtype``. Returns
    ``(x_opt [1, d] numpy, objective)``."""
    device = resolve_device(device)
    dtype = dtype or default_float()
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    lw = torch.broadcast_to(as_t(bounds[0]), (d,))
    up = torch.broadcast_to(as_t(bounds[1]), (d,))
    key = 0 if key is None else key

    def fct(V, args):
        return loss_fn(sigmoid_box_map(lw, up, V), args)

    x_opt = objective = None
    if method in ("DE", "DE+Adam"):
        res = de.minimize(
            fct, torch.zeros((d,), dtype=dtype, device=device),
            _generator(key, device),
            population_size=popsize_DE, population_stddev=popstd_DE,
            max_iterations=iterations_DE, fn_args=loss_args)
        x_opt = sigmoid_box_map(lw, up, res.position)
        objective = float(res.objective)
    if method in ("Adam", "DE+Adam"):
        if init_adam is not None:
            v0 = inverse_box_map(lw, up, as_t(init_adam).reshape(d))
        elif x_opt is not None:
            v0 = inverse_box_map(lw, up, x_opt)
        else:
            v0 = torch.zeros((d,), dtype=dtype, device=device)
        v, obj = de.adam_refine(fct, v0, iterations=iterations_adam,
                                lr=lr_adam, fn_args=loss_args)
        x_opt = sigmoid_box_map(lw, up, v)
        objective = float(obj)
    if x_opt is None:
        raise ValueError(
            f"unknown method {method!r}: use 'DE', 'Adam' or 'DE+Adam'")
    return x_opt.detach().cpu().numpy()[None, :], objective


def _as_input(model, x):
    return torch.as_tensor(x, dtype=model.dtype, device=model.device)


class InfillCriteria:
    name = "Infill criteria"

    def __init__(self, d):
        self.d = d
        self.IC_optimized = None
        self.x_opt = None

    # -- model forwards (pure in the model's parameters) ----------------------
    @staticmethod
    def _predict_y_moments(model, x, key, num_samples):
        """Moment-matched predictive-y moments, [n, 1] each."""
        kind, state = _model_state(model)
        return _y_moments_pure(kind, state, _as_input(model, x), key, num_samples)

    @staticmethod
    def _predict_f_moments(model, x, key, num_samples):
        """Moment-matched latent-f moments (EI's analytic DGP branch)."""
        kind, state = _model_state(model)
        return _f_moments_pure(kind, state, _as_input(model, x), key, num_samples)

    @staticmethod
    def _samples(model, x, key, num_samples):
        """Last-layer MC samples [S, n, 1]."""
        kind, state = _model_state(model)
        return _samples_pure(kind, state, _as_input(model, x), key, num_samples)

    def _optimize_box(self, model, loss_fn, loss_args, bounds, popsize_DE=300,
                      popstd_DE=1.5, iterations_DE=400, init_adam=None,
                      iterations_adam=1000, method="DE", key=None):
        """:func:`optimize_box` with this criterion's d, on ``model``'s
        device and dtype, recording the optimum into ``x_opt`` /
        ``IC_optimized``; returns x_opt [1, d]."""
        self.x_opt, self.IC_optimized = optimize_box(
            loss_fn, loss_args, bounds, self.d, popsize_DE=popsize_DE,
            popstd_DE=popstd_DE, iterations_DE=iterations_DE,
            init_adam=init_adam, iterations_adam=iterations_adam,
            method=method, key=key, device=model.device, dtype=model.dtype)
        return self.x_opt


def _y_min(y_min):
    return float(np.asarray(y_min, dtype=float).reshape(()))


class EI(InfillCriteria):
    """Expected improvement; ``run`` returns -EI."""

    name = "Expected Improvement"

    def __init__(self, y_min, d):
        super().__init__(d)
        self.y_min = _y_min(y_min)

    def run(self, model, x, analytic=True, num_samples=1000, key=None):
        key = 0 if key is None else key
        if analytic:
            mean, var = self._predict_f_moments(model, x, key, num_samples)
            return -_expected_improvement(self.y_min, mean, var)
        F = self._samples(model, x, key, num_samples)
        return -torch.mean(torch.clamp_min(self.y_min - F, 0.0), dim=0)

    def _default_loss_spec(self, model, key, analytic=True, num_samples=1000):
        """(loss_fn, args): run()'s semantics at its defaults (the
        constrained combiners evaluate the IC at defaults)."""
        kind, state = _model_state(model)
        return _ei_loss(kind, analytic, num_samples), (state, self.y_min, key)

    def optimize(self, model, bounds, popsize_DE=300, popstd_DE=1.5,
                 iterations_DE=400, init_adam=None, iterations_adam=1000,
                 method="DE", analytic=True, num_samples=1000, key=None):
        key, sub = split_key(0 if key is None else key)
        loss_fn, args = self._default_loss_spec(model, sub, analytic=analytic,
                                                num_samples=num_samples)
        return self._optimize_box(model, loss_fn, args, bounds, popsize_DE,
                                  popstd_DE, iterations_DE, init_adam,
                                  iterations_adam, method, key)


class WB2(InfillCriteria):
    """WB2 = EI - predicted mean; run returns -(EI - mean)."""

    name = "WB2 criterion"

    def __init__(self, y_min, d):
        super().__init__(d)
        self.y_min = _y_min(y_min)

    def _scale(self):
        return 1.0

    def run(self, model, x, num_samples=500, key=None):
        key = 0 if key is None else key
        mean, var = self._predict_y_moments(model, x, key, num_samples)
        ei = _expected_improvement(self.y_min, mean, var)
        return -(self._scale() * ei - mean)

    def _default_loss_spec(self, model, key, analytic=True, num_samples=500):
        kind, state = _model_state(model)
        return (_wb2_loss(kind, num_samples),
                (state, self.y_min, self._scale(), key))

    def optimize(self, model, bounds, popsize_DE=300, popstd_DE=1.5,
                 iterations_DE=400, init_adam=None, iterations_adam=1000,
                 method="DE", num_samples=500, key=None, analytic=True):
        """``analytic`` is accepted for a uniform interface with EI and
        ignored: WB2's EI term is defined on the analytic moments."""
        key, sub = split_key(0 if key is None else key)
        loss_fn, args = self._default_loss_spec(model, sub,
                                                num_samples=num_samples)
        return self._optimize_box(model, loss_fn, args, bounds, popsize_DE,
                                  popstd_DE, iterations_DE, init_adam,
                                  iterations_adam, method, key)


class WB2S(WB2):
    """WB2S = scale*EI - mean with the adaptive scale of Bartoli et al.
    (2019): s = beta * |mean(x*_EI)| / EI(x*_EI), x*_EI the EI maximizer;
    s falls back to 1 when EI* ~ 0. ``scale`` is 'auto' (resolved per
    :meth:`optimize` / :meth:`resolve_scale` call) or a number."""

    name = "WB2S criterion"

    def __init__(self, y_min, d, scale="auto", beta=100.0):
        super().__init__(y_min, d)
        self.scale = scale
        self.beta = beta
        self._scale_value = None if isinstance(scale, str) else float(scale)

    def resolve_scale(self, model, bounds, key=None, popsize_DE=100,
                      iterations_DE=100, num_samples=500):
        """Compute (and cache) the adaptive s from a short EI
        pre-optimization; no-op when a numeric scale was given."""
        if self._scale_value is not None:
            return self._scale_value
        k_opt, k_mean = split_key(0 if key is None else key)
        ei = EI(self.y_min, self.d)
        x_star = ei.optimize(model, bounds, popsize_DE=popsize_DE,
                             iterations_DE=iterations_DE, method="DE",
                             key=k_opt)
        ei_star = -ei.IC_optimized  # optimize minimizes -EI
        with torch.no_grad():
            mean_star, _ = self._predict_y_moments(model, x_star, k_mean,
                                                   num_samples)
        m_abs = abs(float(mean_star.reshape(-1)[0]))
        self._scale_value = (self.beta * m_abs / ei_star if ei_star > 1e-300
                             else 1.0)
        return self._scale_value

    def _scale(self):
        return 1.0 if self._scale_value is None else self._scale_value

    def optimize(self, model, bounds, popsize_DE=300, popstd_DE=1.5,
                 iterations_DE=400, init_adam=None, iterations_adam=1000,
                 method="DE", num_samples=500, key=None, analytic=True):
        key, k_scale = split_key(0 if key is None else key)
        self.resolve_scale(model, bounds, key=k_scale)
        return WB2.optimize(self, model, bounds, popsize_DE, popstd_DE,
                            iterations_DE, init_adam, iterations_adam,
                            method, num_samples, key)


class EV_one_constraint(InfillCriteria):
    """Expected violation of one constraint g(x) <= zero_c."""

    name = "Expected Violation"

    def __init__(self, zero_c, d):
        super().__init__(d)
        self.zero_c = _y_min(zero_c)

    def run(self, model, x, analytic=True, num_samples=100, key=None):
        kind, state = _model_state(model)
        return _ev_one_pure(kind, state, _as_input(model, x),
                            0 if key is None else key, self.zero_c, analytic,
                            num_samples)


class EV(InfillCriteria):
    """Stacked expected violations and the feasibility-thresholded
    acquisition."""

    name = "Expected Violation"

    def __init__(self, zero_c, d):
        super().__init__(d)
        self.zero_c = np.asarray(zero_c, dtype=float).reshape(-1)

    def run(self, model_C, x, analytic=True, num_samples=100, key=None):
        key = 0 if key is None else key
        return torch.cat([
            EV_one_constraint(self.zero_c[i], self.d).run(
                m, x, analytic=analytic, num_samples=num_samples,
                key=fold_in(key, i))
            for i, m in enumerate(model_C)], dim=1)  # [n, n_c]

    def run_with_IC(self, IC, model_Y, model_C, x, threshold=0.1,
                    analytic=True, num_samples=100, key=None):
        """EI where predicted feasible, sum(EV) + 1e4 elsewhere."""
        k_ev, k_ei = split_key(0 if key is None else key)
        ev = self.run(model_C, x, analytic=analytic, num_samples=num_samples,
                      key=k_ev)
        ev_max = torch.amax(ev, dim=1, keepdim=True)
        ei = IC.run(model_Y, x, key=k_ei)
        penalty = torch.sum(ev, dim=1, keepdim=True) + 10000.0
        return torch.where(ev_max > threshold, penalty, ei)

    def optimize_with_IC(self, IC, model_Y, model_C, bounds, threshold=0.1,
                         analytic=True, num_samples=100, popsize_DE=300,
                         popstd_DE=1.5, iterations_DE=400, init_adam=None,
                         iterations_adam=1000, method="DE", key=None):
        key, sub = split_key(0 if key is None else key)
        k_ev, k_ei = split_key(sub)
        ic_loss, ic_args = IC._default_loss_spec(model_Y, k_ei)
        kinds, states = zip(*(_model_state(m) for m in model_C))
        loss_fn = _ev_ic_loss(ic_loss, kinds, analytic, num_samples)
        args = (ic_args, states, [float(z) for z in self.zero_c],
                float(threshold), k_ev)
        return self._optimize_box(model_Y, loss_fn, args, bounds, popsize_DE,
                                  popstd_DE, iterations_DE, init_adam,
                                  iterations_adam, method, key)


class PoF(InfillCriteria):
    """Probability of feasibility P(g(x) <= zero_c), and the EI * PoF
    acquisition (minimize -(EI * PoF))."""

    name = "Probability of feasibility"

    def __init__(self, zero_c, d):
        super().__init__(d)
        self.zero_c = np.asarray(zero_c, dtype=float).reshape(-1)

    def run(self, model_C, x, num_samples=500, key=None):
        key = 0 if key is None else key
        models = model_C if isinstance(model_C, (list, tuple)) else [model_C]
        pof = 1.0
        for i, m in enumerate(models):
            mean, var = self._predict_y_moments(m, x, fold_in(key, i),
                                                num_samples)
            pof = pof * torch.special.ndtr(
                (float(self.zero_c[i]) - mean) / _floored_sigma(var))
        return pof  # [n, 1]

    def run_with_IC(self, IC, model_Y, model_C, x, key=None):
        """Clamped to <= 0 before weighting, as :func:`_pof_ic_loss`."""
        k_pof, k_ei = split_key(0 if key is None else key)
        pof = self.run(model_C, x, key=k_pof)
        return torch.clamp_max(IC.run(model_Y, x, key=k_ei), 0.0) * pof

    def optimize_with_IC(self, IC, model_Y, model_C, bounds, popsize_DE=300,
                         popstd_DE=1.5, iterations_DE=400, init_adam=None,
                         iterations_adam=1000, method="DE", key=None):
        key, sub = split_key(0 if key is None else key)
        k_pof, k_ei = split_key(sub)
        models = model_C if isinstance(model_C, (list, tuple)) else [model_C]
        ic_loss, ic_args = IC._default_loss_spec(model_Y, k_ei)
        kinds, states = zip(*(_model_state(m) for m in models))
        loss_fn = _pof_ic_loss(ic_loss, kinds, 500)
        args = (ic_args, states, [float(z) for z in self.zero_c], k_pof)
        return self._optimize_box(model_Y, loss_fn, args, bounds, popsize_DE,
                                  popstd_DE, iterations_DE, init_adam,
                                  iterations_adam, method, key)
