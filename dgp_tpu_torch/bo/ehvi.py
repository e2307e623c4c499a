"""Expected hypervolume improvement (EHVI) and the Pareto utilities
(counterpart of ``dgp_tpu/bo/ehvi.py``): the 2-D staircase hypervolume
(HV_calcul), the feasibility-filtered non-dominated sort (NDC), front
padding (Y_ND, pad_front), the psi helper, EHVI in three estimators (exact
2-D, a Gaussian cell approximation with or without the sample covariance,
KDE over samples), the constrained EHVI x PoF acquisition and its DE/Adam
optimizer, and the m-objective utilities (pareto_mask, the WFG hypervolume,
the host Monte-Carlo EHVI).

The Pareto utilities are numpy on the host, the same code as the JAX
package's. The estimators take the surrogates' moments on their device
(two exact GPRs, two DGPs, or the coupled MultiObjDeepGP), where every
evaluation inside one ``optimize_EHVI`` draws its normals from one seed
(common random numbers: the sampled estimators are deterministic in x).

Two deliberate differences from the JAX package, both in how the sums run
on the card, not in what they compute:

- the staircase sums over the front's segments are one [P, n_seg]
  broadcast reduced once (the JAX package loops over segments in Python,
  which XLA traces once; eager PyTorch would launch some 20 small kernels
  per segment per evaluation), so the summation order differs;
- the Gaussian estimator inverts each segment's 2x2 covariance in closed
  form over [P, n_seg], with no batched library solve.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import dgp as dgp_mod
from ..models import gpr as gpr_mod
from ..models import mo_dgp as mo_mod
from ..models.dgp import moment_matched
from .acquisition import _noise, _unit_normals, optimize_box, split_key

_SQRT_2PI = math.sqrt(2.0 * math.pi)


# -- Pareto utilities (numpy, small-n host code) --------------------------------


def HV_calcul(ND, Y, bounds):
    """2-D staircase dominated hypervolume w.r.t. the upper corner (U1, U2).
    ``ND`` is an obj1-ascending index list into Y[0]/Y[1]."""
    L1, L2, U1, U2 = bounds
    y1 = np.asarray(Y[0]).reshape(-1)
    y2 = np.asarray(Y[1]).reshape(-1)
    if len(ND) == 0:
        return 0.0
    if any((y1[i] > U1) and (y2[i] > U2) for i in ND):
        return 0.0
    hv = max((U1 - y1[ND[0]]) * (U2 - y2[ND[0]]), 0.0)
    for i in range(len(ND) - 1):
        cur, nxt = ND[i], ND[i + 1]
        if (y1[nxt] > U1) or (y2[nxt] > U2):
            a = 0.0
        elif (y2[nxt] <= U2) and (y2[cur] > U2):
            a = (U2 - y2[nxt]) * (U1 - y1[nxt])
        else:
            a = (y2[cur] - y2[nxt]) * (U1 - y1[nxt])
        hv += a
    return float(hv)


def NDC(Y, C, obj1_ascending=True):
    """Feasibility-filtered non-dominated indices, sorted by objective 1.
    Minimization; a point is dominated if another feasible point is <= in
    both objectives and < in one.

    Archives of 512 rows or more go to the O(n log n) C++ sweep in
    :mod:`dgp_tpu_torch.native` where it builds."""
    if len(np.asarray(Y[0])) >= 512:
        from .. import native

        if native.available():
            return native.nd_sort_2d(Y, C, obj1_ascending=obj1_ascending)
    return _ndc_numpy(Y, C, obj1_ascending=obj1_ascending)


def _ndc_numpy(Y, C, obj1_ascending=True):
    """Pure-numpy O(n^2) version (also the native sweep's fallback)."""
    y = np.concatenate((np.asarray(Y[0]), np.asarray(Y[1])), axis=1)
    C = np.asarray(C)
    feasible = [i for i in range(len(y)) if C[i].max() <= 0]
    if not feasible:
        return []
    nd = []
    for i in feasible:
        dominated = any(
            (y[j, 0] < y[i, 0] and y[j, 1] <= y[i, 1])
            or (y[j, 0] <= y[i, 0] and y[j, 1] < y[i, 1])
            for j in feasible
        )
        if not dominated:
            nd.append(i)
    nd.sort(key=lambda i: y[i, 0])
    return nd if obj1_ascending else nd[::-1]


def Y_ND(Y, ND, nadir, ideal=(0.0, 0.0)):
    """Pad the (obj1-descending) front with nadir/ideal corners."""
    y0 = np.asarray(Y[0])[ND]
    y1 = np.asarray(Y[1])[ND]
    out0 = np.zeros((len(ND) + 2, 1))
    out1 = np.zeros((len(ND) + 2, 1))
    out0[1:-1] = y0.reshape(-1, 1)
    out1[1:-1] = y1.reshape(-1, 1)
    out0[0], out0[-1] = nadir[0], ideal[0]
    out1[0], out1[-1] = ideal[1], nadir[1]
    return [out0, out1]


def pad_front(YND, bucket):
    """Pad a padded front (Y_ND output) to a multiple of ``bucket`` rows by
    repeating the nadir corner row. Duplicate adjacent points make
    zero-width staircase segments: every estimator term of such a segment
    carries a factor psi(a, b0) - psi(a, b0) = 0 (or a zero width), so the
    value does not change. Keeps the estimators' [P, n_seg] shapes, and so
    their launches, stable while the front grows."""
    if not bucket:
        return YND
    k = (-len(np.asarray(YND[0]))) % int(bucket)
    if not k:
        return YND
    return [np.vstack([np.repeat(np.asarray(y)[:1], k, axis=0),
                       np.asarray(y)]) for y in YND]


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / _SQRT_2PI


def psi(a, b, mu, sigma):
    """sigma*phi((b-mu)/sigma) + (a-mu)*Phi((b-mu)/sigma)."""
    z = torch.as_tensor((b - mu) / sigma)
    return sigma * _norm_pdf(z) + (a - mu) * torch.special.ndtr(z)


# -- model moments/samples -------------------------------------------------------


def _mo_model_state(model_Y):
    """(kind, loop, state) of the supported multi-objective model forms:
    two exact GPRs (their parameters and padded train_data triples), two
    DGPs (their parameters) or a MultiObjDeepGP (its loop and
    parameters)."""
    if isinstance(model_Y, (list, tuple)):
        names = [getattr(m, "name", None) for m in model_Y]
        if names == ["gpr", "gpr"]:
            return "two_gpr", None, (model_Y[0].params, model_Y[0].train_data,
                                     model_Y[1].params, model_Y[1].train_data)
        if names == ["dgp", "dgp"]:
            return "two_dgp", None, (model_Y[0].params, model_Y[1].params)
        raise ValueError(
            f"a model list must be two DGPs or two GPRs, got {names}")
    if getattr(model_Y, "name", None) == "mo_dgp":
        return "mo_dgp", model_Y.loop, model_Y.params
    raise ValueError(
        "model_Y must be a list of two DGPs/GPRs or a MultiObjDeepGP (the "
        "reference's TF1 'coreg' branch is not supported)"
    )


def _device_dtype(model):
    """Where a multi-objective model (list or MultiObjDeepGP) lives."""
    first = model[0] if isinstance(model, (list, tuple)) else model
    return first.device, first.dtype


def _mo_moments_and_samples_pure(kind, loop, state, Xcand, S, key,
                                 need_samples):
    """(mean0, var0, mean1, var1 [n, 1], samples [S, n, 2] or None).

    ``key`` is an int seed (split in two for the two-model forms) or the
    fixed unit normals: for ``two_gpr`` two [S, n] arrays, for ``two_dgp``
    each DGP's per-layer ``zs``, for ``mo_dgp`` the MultiObjDeepGP's
    ``noise`` list."""
    fixed = isinstance(key, (list, tuple))
    device = Xcand.device
    if kind == "two_gpr":
        p0, d0, p1, d1 = state
        m0, v0 = gpr_mod.predict_f(p0, d0, Xcand)
        m1, v1 = gpr_mod.predict_f(p1, d1, Xcand)
        samples = None
        if need_samples:
            # independent exact-GP posteriors: draws are independent
            # Gaussians at the analytic moments
            k0, k1 = key if fixed else split_key(key)
            shape = (S, Xcand.shape[0])
            s0 = m0[None, :, 0] + torch.sqrt(torch.clamp_min(
                v0[None, :, 0], 0.0)) * _unit_normals(k0, shape, m0)
            s1 = m1[None, :, 0] + torch.sqrt(torch.clamp_min(
                v1[None, :, 0], 0.0)) * _unit_normals(k1, shape, m1)
            samples = torch.stack([s0, s1], dim=2)
        return m0, v0, m1, v1, samples
    if kind == "two_dgp":
        p0, p1 = state
        k0, k1 = key if fixed else split_key(key)
        Fs0, Fm0, Fv0 = dgp_mod.propagate(p0, Xcand, S, **_noise(k0, device))
        Fs1, Fm1, Fv1 = dgp_mod.propagate(p1, Xcand, S, **_noise(k1, device))
        m0, v0 = moment_matched(Fm0[-1], Fv0[-1])
        m1, v1 = moment_matched(Fm1[-1], Fv1[-1])
        samples = (torch.cat([Fs0[-1], Fs1[-1]], dim=2) if need_samples
                   else None)
        return m0, v0, m1, v1, samples
    Fs, Fms, Fvs = mo_mod.propagate(state, Xcand, S, loop=loop,
                                    **_noise(key, device, "mo_dgp"))
    m0, v0 = moment_matched(Fms[-2], Fvs[-2])
    m1, v1 = moment_matched(Fms[-1], Fvs[-1])
    samples = torch.cat([Fs[-2], Fs[-1]], dim=2) if need_samples else None
    return m0, v0, m1, v1, samples


# -- EHVI estimators ---------------------------------------------------------------


def _front(YND, dtype, device):
    """The padded front's two columns as 1-D tensors."""
    return [torch.as_tensor(np.asarray(y, dtype=float).reshape(-1),
                            dtype=dtype, device=device) for y in YND[:2]]


@torch.no_grad()
def EHVI(model_Y, Xcand, YND, corr=False, approximation="None", S=1000,
         key=None):
    """Expected hypervolume improvement at candidate points.

    :param YND: padded front [Y0 [n,1], Y1 [n,1]] from :func:`Y_ND`
        (obj1-descending, corners included).
    :param Xcand: [n_cand, d]; a tensor is taken as it is, an array goes to
        the model's device and dtype.
    :param key: an int seed, or fixed unit normals
        (:func:`_mo_moments_and_samples_pure`).
    :return: [n_cand, 1]
    """
    key = 0 if key is None else key
    kind, loop, state = _mo_model_state(model_Y)
    if not torch.is_tensor(Xcand):
        device, dtype = _device_dtype(model_Y)
        Xcand = torch.as_tensor(np.asarray(Xcand), dtype=dtype, device=device)
    Y0, Y1 = _front(YND, Xcand.dtype, Xcand.device)
    return _ehvi_pure(kind, loop, corr, approximation, S, state, Xcand, Y0,
                      Y1, key)


def _ehvi_pure(kind, loop, corr, approximation, S, state, Xcand, Y0, Y1, key):
    """EHVI [P, 1] at the candidates Xcand [P, d] against the padded front
    (Y0, Y1) [n]. The front's n - 1 staircase segments i = 1..n-1 (upper
    corner Y0[i-1], lower Y0[i]; objective 1 from Y1[0] to Y1[i]) are the
    last axis of one broadcast, reduced once."""
    need_samples = (approximation == "KDE") or (
        approximation == "Gaussian" and corr
    )
    m0, v0, m1, v1, samples = _mo_moments_and_samples_pure(
        kind, loop, state, Xcand, S, key, need_samples
    )
    m0, v0, m1, v1 = m0[:, 0], v0[:, 0], m1[:, 0], v1[:, 0]
    # variance floor: psi() divides by sigma, and moment-matched variances can
    # hit 0 at observed points (cf. acquisition._floored_sigma)
    s0 = torch.sqrt(torch.clamp_min(v0, 1e-12))
    s1 = torch.sqrt(torch.clamp_min(v1, 1e-12))
    up0, lo0, lo1 = Y0[:-1], Y0[1:], Y1[1:]   # Y0[i-1], Y0[i], Y1[i]

    if approximation == "None":
        if corr:
            raise NotImplementedError(
                "exact EHVI under output correlation is not available "
                "(the reference only prints a message there)"
            )
        mu0, sg0, mu1, sg1 = (t[:, None] for t in (m0, s0, m1, s1))
        f1 = psi(lo1, lo1, mu1, sg1) - psi(lo1, Y1[0], mu1, sg1)
        cdf = (torch.special.ndtr((lo0 - mu0) / sg0)
               - torch.special.ndtr((Y0[-1] - mu0) / sg0))
        # the first sum runs over segments 1..n-2, the second over 1..n-1
        term1 = ((up0 - lo0) * cdf * f1)[:, :-1].sum(dim=1)
        term2 = ((psi(up0, up0, mu0, sg0) - psi(up0, lo0, mu0, sg0))
                 * f1).sum(dim=1)
        return (term1 + term2)[:, None]

    if approximation == "Gaussian":
        # Gaussian cell-integral approximation: per cell a weight times the
        # normal density at its centroid lam under Sigma + diag(tau2)
        if corr:
            diff = samples - samples.mean(dim=0)[None]        # [S, P, 2]
            cov = torch.einsum("spi,spj->pij", diff, diff) / S
            c00, c01, c10, c11 = (cov[:, i, j] for i, j in
                                  ((0, 0), (0, 1), (1, 0), (1, 1)))
        else:
            c00, c11 = v0, v1
            c01 = c10 = torch.zeros_like(v0)
        d1 = 0.5 * (lo1 - Y1[0]) ** 2          # the objective-1 factor of z
        lam1 = (lo1 + 2 * Y1[0]) / 3.0
        t1 = (lo1 - Y1[0]) ** 2 / 18.0
        w0 = lo0 - Y0[-1]
        # the cells of the first sum (segments 1..n-2), then the second's
        lam = [torch.cat([(0.5 * (lo0 + Y0[-1]))[:-1],
                          (up0 + 2 * lo0) / 3.0]),
               torch.cat([lam1[:-1], lam1])]
        tau2 = [torch.cat([(w0 ** 2 / 12.0)[:-1], (up0 - lo0) ** 2 / 18.0]),
                torch.cat([t1[:-1], t1])]
        weight = torch.cat([((up0 - lo0) * (w0 * d1))[:-1],
                            (0.5 * (up0 - lo0) ** 2) * d1])
        a = c00[:, None] + tau2[0]
        b = c01[:, None]
        c = c10[:, None]
        e = c11[:, None] + tau2[1]
        det = a * e - b * c
        x0 = lam[0] - m0[:, None]
        x1 = lam[1] - m1[:, None]
        # d' inv(C) d of the 2x2 C = [[a, b], [c, e]], in closed form
        quad = (e * x0 * x0 - (b + c) * x0 * x1 + a * x1 * x1) / det
        pdf = torch.exp(-0.5 * quad) / (2 * math.pi * torch.sqrt(det))
        return (weight * pdf).sum(dim=1)[:, None]

    if approximation == "KDE":
        # Silverman-bandwidth KDE over the joint samples
        h0 = ((4.0 / 4.0) ** (1.0 / 6.0) * S ** (-1.0 / 6.0) * s0) ** 2
        h1 = ((4.0 / 4.0) ** (1.0 / 6.0) * S ** (-1.0 / 6.0) * s1) ** 2
        b0 = torch.sqrt(h0)[None, :, None]    # [1, P, 1]
        b1 = torch.sqrt(h1)[None, :, None]
        F0 = samples[:, :, 0:1]               # [S, P, 1]
        F1 = samples[:, :, 1:2]
        f1 = psi(lo1, lo1, F1, b1) - psi(lo1, Y1[0], F1, b1)
        cdf = (torch.special.ndtr((lo0 - F0) / b0)
               - torch.special.ndtr((Y0[-1] - F0) / b0))
        term1 = ((up0 - lo0) * torch.mean(cdf * f1, dim=0))[:, :-1].sum(dim=1)
        term2 = torch.mean(
            (psi(up0, up0, F0, b0) - psi(up0, lo0, F0, b0)) * f1,
            dim=0).sum(dim=1)
        return (term1 + term2)[:, None]

    raise ValueError(f"unknown approximation {approximation!r}")


def _pof_pure(con_states, zero_n, Xcand):
    """Product of per-constraint probabilities of feasibility at Xcand.

    :param con_states: (GPRParams, train_data) per constraint, one exact-GPR
        surrogate each (predict_y moments).
    :param zero_n: [n_con] feasibility thresholds in each surrogate's
        normalized output space: the image of 0 under that constraint
        column's normalization (feasible = g(x) <= 0, the NDC sign
        convention).
    :return: [n] prod_i P(g_i(x) <= 0).
    """
    pof = 1.0
    for i, (p, dta) in enumerate(con_states):
        m, v = gpr_mod.predict_y(p, dta, Xcand)
        s = torch.sqrt(torch.clamp_min(v[:, 0], 1e-12))
        pof = pof * torch.special.ndtr((zero_n[i] - m[:, 0]) / s)
    return pof


def _neg_ehvi_pof_loss(kind, loop, corr, approximation, S):
    """-(EHVI * prod PoF): the constrained-EHVI acquisition (the
    multi-objective analogue of acquisition.PoF's EI*PoF). EHVI >= 0 by
    construction, so the product needs no clamping. args = (state, Y0, Y1,
    constraint states, zero_n, key). Box-domain: acquisition.optimize_box
    lifts it onto the sigmoid map."""

    def loss(x, args):
        state, Y0, Y1, cstates, zero_n, key = args
        ehvi = _ehvi_pure(kind, loop, corr, approximation, S,
                          state, x, Y0, Y1, key).reshape(-1)
        return -(ehvi * _pof_pure(cstates, zero_n, x))

    return loss


def _neg_pof_loss():
    """-prod PoF alone: the acquisition while the archive has no feasible
    point yet (EHVI is undefined without a front; maximizing the probability
    of feasibility is the standard bootstrap). args = (constraint states,
    zero_n)."""

    def loss(x, args):
        cstates, zero_n = args
        return -_pof_pure(cstates, zero_n, x)

    return loss


def _neg_ehvi_loss(kind, loop, corr, approximation, S):
    """-EHVI; args = (model state, Y0, Y1, key). Box-domain:
    acquisition.optimize_box lifts it onto the sigmoid map."""

    def loss(x, args):
        state, Y0, Y1, key = args
        return -_ehvi_pure(kind, loop, corr, approximation, S,
                           state, x, Y0, Y1, key).reshape(-1)

    return loss


def optimize_EHVI(model, YND, popsize_DE=300, popstd_DE=1.5, iterations_DE=400,
                  init_adam=None, lr_adam=0.01, iterations_adam=1000,
                  method="DE", corr=False, approximation="None", S=1000,
                  bounds=(0.0, 1.0), key=None, model_C=None, zero_c=None):
    """Maximize EHVI over the box by DE and/or Adam on the sigmoid map, on
    the model's device and in its dtype. ``key`` (an int seed) splits into
    (key, k_mc, k_de): every evaluation draws its normals from ``k_mc``
    (common random numbers), DE its population from ``k_de``.

    :param model_C: optional list of trained exact-GPR constraint
        surrogates; the acquisition becomes the constrained
        EHVI(x) * prod_i PoF_i(x).
    :param zero_c: [n_con] feasibility thresholds in each constraint
        surrogate's (normalized) output space; required with ``model_C``.
    :param YND: padded descending front, or ``None`` (only with
        ``model_C``) to maximize the probability of feasibility alone:
        the bootstrap acquisition while the archive has no feasible point.
    :return: x_opt [1, d]
    """
    key = 0 if key is None else key
    device, dtype = _device_dtype(model)
    d = (model._X[0].shape[1] if not isinstance(model, (list, tuple))
         else model[0].data[0].shape[1])
    key, k_mc, k_de = split_key(key, 3)

    if model_C is not None:
        names = [getattr(m, "name", None) for m in model_C]
        if any(n != "gpr" for n in names):
            raise ValueError(
                f"constraint surrogates must be exact GPRs, got {names}")
        if zero_c is None:
            raise ValueError("zero_c is required with model_C")
        cstates = tuple((m.params, m.train_data) for m in model_C)
        zn = torch.as_tensor(np.asarray(zero_c, dtype=float).reshape(-1),
                             dtype=dtype, device=device)
        if YND is None:
            fct = _neg_pof_loss()
            fct_args = (cstates, zn)
        else:
            kind, loop, state = _mo_model_state(model)
            fct = _neg_ehvi_pof_loss(kind, loop, corr, approximation, S)
            Y0, Y1 = _front(YND, dtype, device)
            fct_args = (state, Y0, Y1, cstates, zn, k_mc)
    else:
        if YND is None:
            raise ValueError("YND=None requires constraint surrogates")
        kind, loop, state = _mo_model_state(model)
        fct = _neg_ehvi_loss(kind, loop, corr, approximation, S)
        Y0, Y1 = _front(YND, dtype, device)
        fct_args = (state, Y0, Y1, k_mc)

    x_opt, _ = optimize_box(
        fct, fct_args, bounds, d, popsize_DE=popsize_DE, popstd_DE=popstd_DE,
        iterations_DE=iterations_DE, init_adam=init_adam,
        iterations_adam=iterations_adam, lr_adam=lr_adam, method=method,
        key=k_de, device=device, dtype=dtype)
    return x_opt


# -- m-objective utilities (beyond the bi-objective stack) ------------------------
#
# The bi-objective EHVI machinery above walks a 2-D staircase. The utilities
# below lift the analysis side to any m >= 2: generic non-dominated
# filtering, the WFG hypervolume, and a Monte-Carlo EHVI evaluator for
# scoring candidates under independent per-objective surrogates.


def pareto_mask(F):
    """Boolean non-dominated mask for minimization.

    :param F: [n, m] objective rows.
    :return: [n] bool — True where no other row weakly dominates with at
        least one strict improvement. O(n^2 m), n is front-archive scale.
    """
    F = np.asarray(F, dtype=float)
    n = len(F)
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominates_i = np.all(F <= F[i], axis=1) & np.any(F < F[i], axis=1)
        if dominates_i.any():
            mask[i] = False
    return mask


def hypervolume(F, ref):
    """Exact hypervolume (minimization) of the region dominated by ``F``
    and bounded above by ``ref``: the WFG exclusive-volume recursion
    (While et al. 2012), any m >= 1. Points not strictly below ``ref``
    contribute nothing.

    :param F: [n, m] objective rows (need not be mutually non-dominated).
    :param ref: [m] reference (upper) corner.
    """
    F = np.asarray(F, dtype=float).reshape(-1, len(np.ravel(ref)))
    ref = np.asarray(ref, dtype=float).ravel()
    F = F[np.all(F < ref, axis=1)]
    if not len(F):
        return 0.0
    F = F[pareto_mask(F)]
    # sort by first objective: limits the exclusive sets in the recursion
    F = F[np.argsort(F[:, 0])]

    def _wfg(front):
        total = 0.0
        for i in range(len(front)):
            p = front[i]
            box = float(np.prod(ref - p))
            if i + 1 < len(front):
                # points that could overlap p's box, clipped to it
                clipped = np.maximum(front[i + 1:], p)
                clipped = clipped[np.all(clipped < ref, axis=1)]
                if len(clipped):
                    clipped = clipped[pareto_mask(clipped)]
                    box -= _wfg(clipped)
            total += box
        return total

    return float(_wfg(F))


def ehvi_mc(model, F_nd, ref, Xcand, key=None, S=200):
    """Monte-Carlo EHVI for any number of objectives m >= 2 (minimization):
    E[ HV(F_nd ∪ {Y(x)}) - HV(F_nd) ] with Y(x) sampled from the
    surrogates' posteriors. Host-side evaluator (numpy WFG per sample) for
    scoring candidate sets and checking the bi-objective estimators; not
    wired into the DE engine. Its numpy generator is seeded with the int
    ``key`` itself.

    :param model: list of m independent per-objective surrogates (each with
        the ``predict_f`` contract of so_bo.make_single_model).
    :param F_nd: [k, m] current non-dominated front (objective units of the
        surrogates' training targets).
    :param ref: [m] reference corner (e.g. the nadir of the HV box).
    :param Xcand: [n, d] candidate inputs.
    :return: [n] MC-estimated EHVI values.
    """
    key = 0 if key is None else key
    F_nd = np.asarray(F_nd, dtype=float)
    ref = np.asarray(ref, dtype=float).ravel()
    m = len(ref)
    if len(model) != m:
        raise ValueError("one surrogate per objective")
    Xcand = np.asarray(Xcand, dtype=float)
    n = len(Xcand)

    # per-objective posterior moments -> independent Gaussian samples
    means, sds = [], []
    for mj in model:
        if mj.name == "gpr":
            mu, var = mj.predict_f(Xcand)
        else:
            mu, var = moment_matched(*mj.predict_f(Xcand, S=max(S, 64)))
        mu, var = (t.double().cpu().numpy() for t in (mu, var))
        means.append(mu.reshape(n))
        sds.append(np.sqrt(np.maximum(var.reshape(n), 1e-12)))
    means = np.stack(means, axis=1)  # [n, m]
    sds = np.stack(sds, axis=1)

    rng = np.random.default_rng(int(key))
    z = rng.standard_normal((S, n, m))
    samples = means[None] + sds[None] * z  # [S, n, m]

    hv_base = hypervolume(F_nd, ref)
    out = np.zeros(n)
    for i in range(n):
        gain = 0.0
        for s in range(S):
            y = samples[s, i]
            if np.all(y < ref):
                gain += hypervolume(np.vstack([F_nd, y[None]]),
                                    ref) - hv_base
        out[i] = gain / S
    return out
