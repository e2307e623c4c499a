"""Port parity: EHVI and the Pareto utilities (``dgp_tpu_torch/bo/ehvi.py``,
``dgp_tpu_torch/native``) against ``dgp_tpu``'s, in float64 on CPU, on
numpy inputs made from a seed.

The Pareto utilities are numpy in both packages and must agree bit for bit,
the native sweep too. The three estimators are held on the same moments
and samples (both packages' ``_mo_moments_and_samples_pure`` replaced by the
same numbers) to 1e-12 relative: the port sums the staircase segments in
one broadcast and inverts the Gaussian estimator's 2x2 covariances in
closed form, so only the rounding differs. The moments of each model form,
the probability of feasibility and the three acquisition losses are held to
1e-10 on two small exact GPRs at the same parameters; the DGP forms'
propagations are replaced by fixed arrays in both packages (they are held
by test_torch_dgp.py and test_torch_mo_dgp.py). The reference's estimators run
op by op with the front as numpy (its segment loop then indexes numpy, and
XLA compiles each operation once for all segments): a jitted program of
the unrolled loop takes XLA several times longer to compile. Its model
moments and PoF come from one program at XLA's lowest backend optimization
level.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgp_tpu import native as jnative
from dgp_tpu.bo import ehvi as jehvi
from dgp_tpu.bo import so_bo as jso
from dgp_tpu.models import dgp as jdgp
from dgp_tpu.models import mo_dgp as jmo
from dgp_tpu_torch import convert
from dgp_tpu_torch import native as tnative
from dgp_tpu_torch.bo import ehvi as tehvi
from dgp_tpu_torch.bo import so_bo as tso
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.models import mo_dgp as tmo

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL, ATOL = 1e-12, 1e-15     # the estimators on the same moments
TOL = 1e-10                   # the model forms, PoF and the losses
FAST_COMPILE = {"xla_backend_optimization_level": 0}
P, S = 12, 40                 # candidates, samples
ESTIMATORS = [("None", False), ("Gaussian", False), ("Gaussian", True),
              ("KDE", False)]
SAMPLED = [("Gaussian", True), ("KDE", False)]   # the ones that read samples


def t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def npy(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# -- the Pareto utilities ----------------------------------------------------------


def archive(n, seed, frac_infeasible=0.2, ties=False):
    """Two objective columns and a feasibility column from ``seed``; with
    ``ties`` the objectives take few distinct values (duplicates and equal
    coordinates)."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(n, 2))
    if ties:
        Y = np.round(Y * 2) / 2
    C = np.where(rng.uniform(size=(n, 1)) < frac_infeasible, 1.0, -1.0)
    return [Y[:, :1], Y[:, 1:]], C


CASES = {
    "random": dict(n=40, seed=0),
    "ties": dict(n=40, seed=1, ties=True),
    "all infeasible": dict(n=12, seed=2, frac_infeasible=1.1),
    "one row": dict(n=1, seed=3, frac_infeasible=0.0),
    "native dispatch": dict(n=600, seed=4),
    "native dispatch, ties": dict(n=700, seed=5, ties=True),
}
BOXES = {"in the box": (-5.0, -5.0, 4.0, 4.0),
         "partly out": (-5.0, -5.0, 0.3, 0.5),
         "out of the box": (-5.0, -5.0, -3.0, -3.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ndc_and_hv_bit_equal(case):
    Y, C = archive(**CASES[case])
    for ascending in (True, False):
        nd = tehvi.NDC(Y, C, obj1_ascending=ascending)
        assert nd == jehvi.NDC(Y, C, obj1_ascending=ascending)
        # the native sweep orders equal objective-1 values by objective 2,
        # the numpy loop by index: the same set
        assert sorted(nd) == sorted(tehvi._ndc_numpy(Y, C))
    nd = tehvi.NDC(Y, C)
    for bounds in BOXES.values():
        assert tehvi.HV_calcul(nd, Y, bounds) == jehvi.HV_calcul(nd, Y, bounds)
    assert tehvi.HV_calcul([], Y, BOXES["in the box"]) == 0.0


@pytest.mark.parametrize("bucket", [None, 4, 8, 16])
def test_front_padding_bit_equal(bucket):
    Y, C = archive(30, 6)
    nd = tehvi.NDC(Y, C, obj1_ascending=False)
    kw = dict(nadir=(3.0, 2.5), ideal=(-4.0, -3.5))
    got = tehvi.pad_front(tehvi.Y_ND(Y, nd, **kw), bucket)
    want = jehvi.pad_front(jehvi.Y_ND(Y, nd, **kw), bucket)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # an empty front pads its two corners alone
    for g, w in zip(tehvi.Y_ND(Y, [], **kw), jehvi.Y_ND(Y, [], **kw)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_pareto_mask_and_hypervolume_bit_equal(m):
    rng = np.random.default_rng(10 + m)
    F = rng.uniform(size=(9, m))
    F = np.vstack([F, F[:2]])              # duplicated rows
    ref = np.full(m, 1.1)
    np.testing.assert_array_equal(tehvi.pareto_mask(F),
                                  jehvi.pareto_mask(F))
    assert tehvi.hypervolume(F, ref) == jehvi.hypervolume(F, ref)
    outside = F + 2.0                       # no row below the corner
    assert tehvi.hypervolume(outside, ref) == 0.0 == jehvi.hypervolume(
        outside, ref)
    assert tehvi.hypervolume(np.zeros((0, m)), ref) == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_native_sweep_matches_numpy(seed):
    assert tnative.available()
    Y, C = archive(200, seed)
    expected = tehvi._ndc_numpy(Y, C)
    assert tnative.nd_sort_2d(Y, C) == expected
    assert tnative.nd_sort_2d(Y, C, obj1_ascending=False) == expected[::-1]
    assert tnative.nd_sort_2d(Y, C) == jnative.nd_sort_2d(Y, C)
    Yf, Cf = archive(100, seed, frac_infeasible=0.0)
    nd = tehvi.NDC(Yf, Cf)
    bounds = (-5.0, -5.0, 2.5, 2.5)
    assert tnative.hv_2d(nd, Yf, bounds) == pytest.approx(
        tehvi.HV_calcul(nd, Yf, bounds), rel=1e-12)


def test_native_edge_cases():
    Y, _ = archive(10, 0)
    assert tnative.nd_sort_2d(Y, np.ones((10, 1))) == []
    Yd = [np.array([[0.0], [0.0], [1.0]]), np.array([[1.0], [1.0], [0.0]])]
    C = -np.ones((3, 1))
    assert sorted(tnative.nd_sort_2d(Yd, C)) == sorted(tehvi.NDC(Yd, C))
    assert tnative.hv_2d([], Yd, (0.0, 0.0, 2.0, 2.0)) == 0.0
    # built under the repository's build/, named by the source's hash
    assert tnative.library_path().endswith(".so")
    assert tnative.available() and tnative.build() == tnative.library_path()


def test_psi_matches_reference():
    # P values: the estimators' shapes, whose operations XLA then compiles
    # once for both tests
    rng = np.random.default_rng(7)
    a, b, mu = (rng.normal(size=P) for _ in range(3))
    sigma = rng.uniform(0.1, 2.0, size=P)
    np.testing.assert_allclose(
        npy(tehvi.psi(t(a), t(b), t(mu), t(sigma))),
        np.asarray(jehvi.psi(a, b, mu, sigma)), rtol=RTOL, atol=ATOL)


# -- the estimators on the same moments and samples -------------------------------


def front(n_front=6, seed=20, bucket=None):
    """A non-dominated front of ``n_front`` points, padded by Y_ND (and
    pad_front to ``bucket``)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2.0, 2.0, n_front))[::-1]
    y = np.sort(rng.uniform(-2.0, 2.0, n_front))
    Y = [x[:, None], y[:, None]]
    YND = tehvi.Y_ND(Y, list(range(n_front)), nadir=(3.0, 3.0),
                     ideal=(-3.0, -3.0))
    return tehvi.pad_front(YND, bucket)


def moments(seed=30, rho=None):
    """(m0, v0, m1, v1 [P, 1], samples [S, P, 2]) as numpy: candidates
    inside the hypervolume box, samples at those moments (with ``rho``
    correlated)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.5, 2.5, size=(P, 2))
    varis = rng.uniform(0.05, 1.0, size=(P, 2))
    z = rng.normal(size=(S, P, 2))
    if rho is not None:
        z[:, :, 1] = rho * z[:, :, 0] + np.sqrt(1 - rho ** 2) * z[:, :, 1]
    samples = means[None] + np.sqrt(varis)[None] * z
    return (means[:, :1], varis[:, :1], means[:, 1:], varis[:, 1:], samples)


def reference_ehvi(YND, mom, estimators):
    """dgp_tpu's ``estimators`` on the moments ``mom``."""
    Y0, Y1 = (np.asarray(y).reshape(-1) for y in YND)
    state = tuple(jnp.asarray(a) for a in mom)

    def fake(kind, loop, st, Xcand, S_, key, need_samples):
        return (*st[:4], st[4] if need_samples else None)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jehvi, "_mo_moments_and_samples_pure", fake)
        return [np.asarray(jehvi._ehvi_pure(
            "two_dgp", None, corr, approx, S, state, jnp.zeros((P, 1)), Y0,
            Y1, None)) for approx, corr in estimators]


def port_ehvi(YND, mom, monkeypatch, approx, corr):
    tm = tuple(t(a) for a in mom)
    monkeypatch.setattr(
        tehvi, "_mo_moments_and_samples_pure",
        lambda kind, loop, st, Xcand, S_, key, need: (
            *tm[:4], tm[4] if need else None))
    Y0, Y1 = tehvi._front(YND, F64, "cpu")
    return npy(tehvi._ehvi_pure("two_dgp", None, corr, approx, S, None,
                                torch.zeros(P, 1, dtype=F64), Y0, Y1, 0))


@pytest.mark.parametrize("bucket", [None, 16])
@pytest.mark.parametrize("rho", [None, 0.7])
def test_estimators_match_reference(monkeypatch, bucket, rho):
    """Every estimator on independent samples; with correlated ones (rho:
    the same moments, other samples) those that read the samples."""
    YND, mom = front(bucket=bucket), moments(rho=rho)
    estimators = ESTIMATORS if rho is None else SAMPLED
    want = reference_ehvi(YND, mom, estimators)
    for (approx, corr), w in zip(estimators, want):
        got = port_ehvi(YND, mom, monkeypatch, approx, corr)
        assert got.shape == (P, 1) and np.all(got > 0)
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{approx} corr={corr}")


def test_pad_front_leaves_every_estimator_unchanged(monkeypatch):
    """Zero-width segments of the repeated nadir corner add nothing (the
    reference's tolerance, tests/test_ehvi.py)."""
    mom = moments(seed=31)
    for approx, corr in ESTIMATORS:
        plain, padded = (port_ehvi(front(bucket=b), mom, monkeypatch, approx,
                                   corr) for b in (None, 16))
        np.testing.assert_allclose(padded, plain, rtol=1e-6, atol=1e-9,
                                   err_msg=approx)


def test_exact_estimator_refuses_corr_and_unknown(monkeypatch):
    with pytest.raises(NotImplementedError):
        port_ehvi(front(), moments(), monkeypatch, "None", True)
    with pytest.raises(ValueError, match="unknown approximation"):
        port_ehvi(front(), moments(), monkeypatch, "nope", False)


# -- the model forms, PoF and the losses ------------------------------------------


def off_init(params):
    leaves, treedef = jax.tree.flatten(params)
    return jax.tree.unflatten(
        treedef, [x + 0.1 * (i + 1) * (-1) ** i for i, x in enumerate(leaves)])


@functools.lru_cache(maxsize=None)
def gprs():
    """Three small exact GPRs in both packages at the same off-init
    parameters (two objectives and one constraint on 11 rows, bucket 8):
    (reference models, port models, zero_n)."""
    rng = np.random.default_rng(40)
    X = rng.uniform(-1.5, 1.5, size=(11, 1))
    ys = [np.sin(3 * X), np.cos(2 * X) + 0.3 * X, X ** 2 - 0.5]
    ref, port = [], []
    for y in ys:
        spec = {"num_layers": 0, "kernels": "rbf"}
        r = jso.make_single_model(spec, X, jso.normalize(y), n_bucket=8,
                                  seed=0)
        r.params = off_init(r.params)
        p = tso.make_single_model(spec, X, tso.normalize(y), n_bucket=8,
                                  device="cpu", dtype=F64)
        p.params = convert.gpr_from_numpy(
            convert.numpy_tree_from_reference(r.params), "cpu", F64)
        ref.append(r)
        port.append(p)
    c = ys[2]
    return ref, port, np.asarray([(0.0 - c.mean()) / c.std()])


XC = np.linspace(-2.0, 2.0, P)[:, None]
FIXED = dict(
    two_dgp=[[np.full((S, P, 1), 0.1 * k + 0.05 * layer)
              + np.linspace(0, 1, S * P).reshape(S, P, 1) * (k + 1)
              for layer in range(2)] for k in range(3)],
    mo_dgp=[np.linspace(-1, 1, S * P).reshape(S, P, 1) * (k + 1) + 0.2 * k
            for k in range(3)])


def fake_propagations(kind):
    """(Fs, Fmeans, Fvars) per model of ``kind``: fixed arrays, the
    variances positive; two_dgp's two DGPs of two layers each, mo_dgp's
    three entries (the estimators read the last two)."""
    if kind == "two_dgp":
        return [([a + m for a in FIXED[kind][0]],
                 [a * (m + 1) for a in FIXED[kind][1]],
                 [0.1 + a ** 2 for a in FIXED[kind][2]]) for m in (0, 1)]
    Fs, Fm, Fv = FIXED[kind]
    return [([Fs + k for k in range(3)], [Fm * (k + 1) for k in range(3)],
             [0.2 + Fv ** 2 * (k + 1) for k in range(3)])]


@functools.lru_cache(maxsize=None)
def reference_outputs():
    """dgp_tpu's moments of each form, its PoF and its three losses at XC.
    The moments (the GPR pair's draws recorded, the DGP forms'
    propagations replaced by fake_propagations) and the PoF come from one
    program compiled at XLA's lowest backend optimization level; the losses
    run op by op on them (the reference's GPR prediction op by op would
    cost XLA one compile per operation)."""
    ref, _, zero_n = gprs()
    state = (ref[0].params, ref[0].train_data, ref[1].params,
             ref[1].train_data)
    cstates = ((ref[2].params, ref[2].train_data),)
    fakes = {kind: [tuple(tuple(jnp.asarray(a) for a in part) for part in m)
                    for m in fake_propagations(kind)]
             for kind in ("two_dgp", "mo_dgp")}
    zn = jnp.asarray(zero_n)

    def run(state, cstates, x, key):
        draws = []
        normal = jax.random.normal

        def recording(key, shape=(), dtype=float):
            z = normal(key, shape, dtype)
            draws.append(z)
            return z

        calls = iter([0, 1])
        out = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", recording)
            out["two_gpr"] = jehvi._mo_moments_and_samples_pure(
                "two_gpr", None, state, x, S, key, True)
            mp.setattr(jdgp, "propagate",
                       lambda p, X, k, S_: fakes["two_dgp"][next(calls)])
            out["two_dgp"] = jehvi._mo_moments_and_samples_pure(
                "two_dgp", None, (None, None), x, S, key, True)
            mp.setattr(jmo, "propagate",
                       lambda p, X, k, S_, loop: fakes["mo_dgp"][0])
            out["mo_dgp"] = jehvi._mo_moments_and_samples_pure(
                "mo_dgp", 2, None, x, S, key, True)
        out["pof"] = jehvi._pof_pure(cstates, zn, x)
        return out, draws

    args = (state, cstates, jnp.asarray(XC), jax.random.PRNGKey(3))
    out, draws = jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args)

    Y0, Y1 = (np.asarray(y).reshape(-1) for y in front(bucket=8))
    x, key = args[2:]
    with pytest.MonkeyPatch.context() as mp:
        moments = out["two_gpr"]
        mp.setattr(jehvi, "_mo_moments_and_samples_pure",
                   lambda kind, loop, st, X, S_, k, need: moments)
        mp.setattr(jehvi, "_pof_pure", lambda cs, z, X: out["pof"])
        for approx in ("None", "Gaussian"):
            out[f"ehvi {approx}"] = jehvi._neg_ehvi_loss(
                "two_gpr", None, False, approx, S)(x, (state, Y0, Y1, key))
            out[f"ehvi pof {approx}"] = jehvi._neg_ehvi_pof_loss(
                "two_gpr", None, False, approx, S, 1)(
                    x, (state, Y0, Y1, cstates, zn, key))
        out["pof loss"] = jehvi._neg_pof_loss(1)(x, (cstates, zn))
    return (jax.tree.map(np.asarray, out), [np.asarray(z) for z in draws])


def port_state():
    _, port, zero_n = gprs()
    state = (port[0].params, port[0].train_data, port[1].params,
             port[1].train_data)
    return state, ((port[2].params, port[2].train_data),), t(zero_n)


def assert_moments(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(npy(g), w, rtol=TOL, atol=TOL)


def test_two_gpr_moments_and_samples_match_reference():
    (want, draws), (state, _, _) = reference_outputs(), port_state()
    got = tehvi._mo_moments_and_samples_pure(
        "two_gpr", None, state, t(XC), S, [t(z) for z in draws], True)
    assert got[4].shape == (S, P, 2)
    assert_moments(got, want["two_gpr"])
    # without samples: the moments alone, the same numbers
    got = tehvi._mo_moments_and_samples_pure("two_gpr", None, state, t(XC),
                                             S, 0, False)
    assert got[4] is None
    assert_moments(got[:4], want["two_gpr"][:4])


@pytest.mark.parametrize("kind", ["two_dgp", "mo_dgp"])
def test_deep_forms_moment_match_the_last_layers(monkeypatch, kind):
    want = reference_outputs()[0][kind]
    fakes = [tuple(tuple(t(a) for a in part) for part in m)
             for m in fake_propagations(kind)]
    calls = iter(range(2))
    seen = []

    def fake(p, X, S_, **kw):
        seen.append(sorted(k for k in kw if k != "loop"))
        return fakes[next(calls) if kind == "two_dgp" else 0]

    monkeypatch.setattr(tdgp if kind == "two_dgp" else tmo, "propagate", fake)
    got = tehvi._mo_moments_and_samples_pure(
        kind, 2, (None, None) if kind == "two_dgp" else None, t(XC), S, 5,
        True)
    assert_moments(got, want)
    # a seed reaches each propagation as a generator, fixed normals as zs
    # (each DGP's) or noise (the MultiObjDeepGP's)
    fixed = ([["z0"], ["z1"]] if kind == "two_dgp" else ["z"])
    calls = iter(range(2))
    tehvi._mo_moments_and_samples_pure(
        kind, 2, (None, None) if kind == "two_dgp" else None, t(XC), S,
        fixed, False)
    name = "zs" if kind == "two_dgp" else "noise"
    n = 2 if kind == "two_dgp" else 1
    assert seen == [["generator"]] * n + [[name]] * n


def test_pof_and_losses_match_reference():
    want, draws = reference_outputs()
    state, cstates, zn = port_state()
    x = t(XC)
    YND = front(bucket=8)
    Y0, Y1 = tehvi._front(YND, F64, "cpu")
    got = {"pof": tehvi._pof_pure(cstates, zn, x),
           "pof loss": tehvi._neg_pof_loss()(x, (cstates, zn))}
    for approx in ("None", "Gaussian"):
        got[f"ehvi {approx}"] = tehvi._neg_ehvi_loss(
            "two_gpr", None, False, approx, S)(x, (state, Y0, Y1, 0))
        got[f"ehvi pof {approx}"] = tehvi._neg_ehvi_pof_loss(
            "two_gpr", None, False, approx, S)(
                x, (state, Y0, Y1, cstates, zn, 0))
    assert npy(got["pof"]).min() >= 0 and npy(got["ehvi None"]).max() <= 0
    for name, g in got.items():
        np.testing.assert_allclose(npy(g), want[name], rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_optimize_ehvi_errors_and_search():
    _, port, zero_n = gprs()
    YND = front(bucket=8)
    with pytest.raises(ValueError, match="two DGPs or two GPRs"):
        tehvi.optimize_EHVI([port[0]], YND)
    with pytest.raises(ValueError, match="zero_c is required"):
        tehvi.optimize_EHVI(port[:2], YND, model_C=[port[2]])
    with pytest.raises(ValueError, match="exact GPRs"):
        tehvi.optimize_EHVI(port[:2], YND, model_C=[object()], zero_c=zero_n)
    with pytest.raises(ValueError, match="requires constraint"):
        tehvi.optimize_EHVI(port[:2], None)
    kw = dict(popsize_DE=10, iterations_DE=5, bounds=(-1.5, 1.5), key=4)
    x = tehvi.optimize_EHVI(port[:2], YND, **kw)
    assert x.shape == (1, 1) and -1.5 <= x[0, 0] <= 1.5
    # common random numbers: the same key picks the same point
    np.testing.assert_array_equal(tehvi.optimize_EHVI(port[:2], YND, **kw), x)
    # the PoF-only bootstrap, and EHVI x PoF
    for front_ in (None, YND):
        x = tehvi.optimize_EHVI(port[:2], front_, model_C=[port[2]],
                                zero_c=zero_n, **kw)
        assert x.shape == (1, 1) and np.isfinite(x).all()
    ehvi = tehvi.EHVI(port[:2], XC, YND)
    assert ehvi.shape == (P, 1) and bool((ehvi >= 0).all())
