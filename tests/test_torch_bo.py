"""Port parity: the pieces of single-objective BO (``dgp_tpu_torch/bo``)
against ``dgp_tpu.bo`` in float64 on CPU: the Latin hypercube and the DoE
bit for bit; EI, EV, PoF, WB2 and WB2S and their gradients in x at one GPR
state, through the same pure loss functions; the non-whitened DGP
surrogate's moments and their gradients in x on fixed unit normals; and
the optimizers held by what they find, never to JAX's random draws."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgp_tpu.bo import acquisition as jacq
from dgp_tpu.bo import doe as jdoe
from dgp_tpu.bo.so_bo import make_single_model as jmake
from dgp_tpu.models import dgp as jdgp
from dgp_tpu.models import gpr as jgpr
from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch import convert
from dgp_tpu_torch.bo import acquisition as tacq
from dgp_tpu_torch.bo import de as tde
from dgp_tpu_torch.bo import doe as tdoe
from dgp_tpu_torch.models import gpr as tgpr

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64


class _Constrained:
    """min (x-0.5)^2 s.t. step(x-0.25) <= 0 (the nb_dgp_BO problem)."""

    constraint = True
    dim = 1

    def fun(self, x):
        return [(x - 0.5) ** 2, np.where(x > 0.25, 1.0, 0.0)]


class _Quadratic:
    constraint = False
    dim = 3

    def fun(self, x):
        return [np.sum((x - 0.3) ** 2, axis=1, keepdims=True)]


@pytest.mark.parametrize("seed", [0, 7, None])
def test_lhs_and_doe_match_reference(seed):
    if seed is None:  # unseeded draws differ; the strata do not
        X = tdoe.lhs(3, 20)
        for j in range(3):
            assert np.all(np.histogram(X[:, j], bins=20, range=(0, 1))[0] == 1)
        return
    np.testing.assert_array_equal(tdoe.lhs(4, 9, seed=seed),
                                  jdoe.lhs(4, 9, seed=seed))
    for problem in (_Constrained(), _Quadratic()):
        for a, b in zip(tdoe.doe(problem, 6, seed=seed),
                        jdoe.doe(problem, 6, seed=seed)):
            np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def gpr_pair():
    """A GPR of (x-0.5)^2 in both packages, on the same parameters."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (13, 1))
    Y = (X - 0.5) ** 2 + 0.001 * rng.normal(size=X.shape)
    ref = jgpr.GPR((X, Y), JK.RBF.create(lengthscales=[0.3], variance=0.1),
                   noise_variance=1e-4, n_bucket=8)
    port = tgpr.GPR((X, Y), tacq_kernel(), noise_variance=1e-4, n_bucket=8,
                    device="cpu", dtype=F64)
    port.params = convert.gpr_from_numpy(
        convert.numpy_tree_from_reference(ref.params), "cpu", F64)
    return ref, port


def tacq_kernel():
    from dgp_tpu_torch.ops import kernels as TK

    return TK.RBF.create(lengthscales=[0.3], variance=0.1, dtype=F64)


X_EVAL = np.array([[0.05], [0.3], [0.5], [0.71], [0.95]])
Y_MIN, ZERO_C, SCALE = 0.02, 0.01, 2.0


def acquisitions(lib, kind, state, key):
    """name -> loss(x) [n, 1] of each criterion at this GPR state, through
    the package's own pure loss functions (``lib`` is either package's
    acquisition module; the key draws nothing on the GPR's analytic
    path)."""
    ei = lib._ei_loss(kind, True, 1000)
    wb2 = lib._wb2_loss(kind, 500)
    return {
        "EI": lambda x: ei(x, (state, Y_MIN, key)),
        "WB2": lambda x: wb2(x, (state, Y_MIN, 1.0, key)),
        "WB2S": lambda x: wb2(x, (state, Y_MIN, SCALE, key)),
        "EV": lambda x: lib._ev_one_pure(kind, state, x, key, ZERO_C, True, 100),
        "PoF": lambda x: lib._pof_ic_loss(ei, (kind,), 500)(
            x, ((state, Y_MIN, key), (state,), [ZERO_C], key)),
        "EV+EI": lambda x: lib._ev_ic_loss(ei, (kind,), True, 100)(
            x, ((state, Y_MIN, key), (state,), [ZERO_C], 0.002, key)),
    }


@functools.lru_cache(maxsize=None)
def reference_acquisitions():
    """dgp_tpu's values and d(sum)/dx of every criterion, jitted at once."""
    ref, _ = gpr_pair()
    fns = acquisitions(jacq, "gpr", (ref.params, ref.train_data),
                       jax.random.PRNGKey(0))

    @jax.jit
    def run(x):
        return {k: (f(x), jax.grad(lambda x: jnp.sum(f(x)))(x))
                for k, f in fns.items()}

    return {k: tuple(np.asarray(a) for a in v)
            for k, v in run(jnp.asarray(X_EVAL)).items()}


@pytest.mark.parametrize("name", ["EI", "WB2", "WB2S", "EV", "PoF", "EV+EI"])
def test_acquisition_and_its_gradient_match_reference(name):
    _, port = gpr_pair()
    f = acquisitions(tacq, "gpr", (port.params, port.train_data), 0)[name]
    x = torch.tensor(X_EVAL, dtype=F64, requires_grad=True)
    value = f(x)
    (grad,) = torch.autograd.grad(value.sum(), x)
    want_value, want_grad = reference_acquisitions()[name]
    assert tuple(value.shape) == want_value.shape == (5, 1)
    for got, want in ((value, want_value), (grad, want_grad)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_criteria_classes_give_the_pure_losses():
    """The classes' run() at a GPR equals the pure losses (the constrained
    combiners evaluate EI at its defaults, as in dgp_tpu)."""
    _, port = gpr_pair()
    fns = acquisitions(tacq, "gpr", (port.params, port.train_data), 0)
    x = torch.tensor(X_EVAL, dtype=F64)
    cases = {
        "EI": tacq.EI(Y_MIN, 1).run(port, X_EVAL),
        "WB2": tacq.WB2(Y_MIN, 1).run(port, X_EVAL),
        "WB2S": tacq.WB2S(Y_MIN, 1, scale=SCALE).run(port, X_EVAL),
        "EV": tacq.EV([ZERO_C], 1).run([port], X_EVAL),
        "PoF": tacq.PoF([ZERO_C], 1).run_with_IC(tacq.EI(Y_MIN, 1), port,
                                                 [port], X_EVAL),
        "EV+EI": tacq.EV([ZERO_C], 1).run_with_IC(
            tacq.EI(Y_MIN, 1), port, [port], X_EVAL, threshold=0.002),
    }
    for name, got in cases.items():
        torch.testing.assert_close(got, fns[name](x), rtol=1e-13, atol=0)


@functools.lru_cache(maxsize=None)
def dgp_pair():
    """The BO constraint surrogate (num_layers=2: three non-whitened SVGP
    layers, num_units=1, RBF, bucketed inducing inputs) built by dgp_tpu's
    own factory, and the port's on the same parameters."""
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (6, 1))
    C = np.where(X > 0.25, 1.0, 0.0) + 0.05 * rng.normal(size=X.shape)
    spec = {"num_layers": 2, "num_units": 1, "kernels": "rbf",
            "num_samples": 10}
    ref = jmake(spec, X, C, n_bucket=8, seed=1)
    # move q off the prior, where the moments hold only rounding, but keep
    # it in the prior's range, as a trained posterior is: q_mu = Lu v and
    # q_sqrt = Lu (I + 0.1 N), Lu = chol(Kuu) being the factory's q_sqrt.
    # (A unit-size q_mu would reach the mean through Kuu^{-1}, of condition
    # ~1e8 at 8 inducing points on a line: both packages' f64 then agree
    # only to ~1e-8.)
    tree = convert.numpy_tree_from_reference(ref.params)
    for layer in tree["layers"]:
        Lu = layer["q_sqrt"][0]
        M = Lu.shape[0]
        layer["q_mu"] = Lu @ rng.normal(size=layer["q_mu"].shape)
        layer["q_sqrt"] = (Lu @ (np.eye(M) + 0.1 * np.tril(rng.normal(
            size=(M, M)))))[None]
    port = convert.dgp_from_numpy(tree, "cpu", F64)
    ref_params = ref.params.replace(layers=tuple(
        l.replace(q_mu=jnp.asarray(t["q_mu"]), q_sqrt=jnp.asarray(t["q_sqrt"]))
        for l, t in zip(ref.params.layers, tree["layers"])))
    return ref_params, port


@pytest.mark.parametrize("which", ["y", "f"])
def test_dgp_surrogate_moments_match_reference(which):
    """Moment-matched y (and f) moments of the DGP surrogate on fixed unit
    normals, and the gradient in x of their sum, against dgp_tpu's
    propagate with the same normals (rtol 1e-10)."""
    ref_params, port = dgp_pair()
    S = 7
    rng = np.random.default_rng(3)
    zs = [rng.normal(size=(S, len(X_EVAL), 1)) for _ in range(3)]

    def ref_moments(x):
        _, Fm, Fv = jdgp.propagate(ref_params, x, jax.random.PRNGKey(0), S,
                                   zs=[jnp.asarray(z) for z in zs])
        m, v = Fm[-1], Fv[-1]
        if which == "y":
            m, v = ref_params.likelihood.predict_mean_and_var(m, v)
        return jacq._moment_matched(m, v)

    want = jax.jit(ref_moments)(jnp.asarray(X_EVAL))
    want_grad = jax.jit(jax.grad(lambda x: sum(jnp.sum(a) for a in ref_moments(x))))(
        jnp.asarray(X_EVAL))
    moments = tacq._y_moments_pure if which == "y" else tacq._f_moments_pure
    x = torch.tensor(X_EVAL, dtype=F64, requires_grad=True)
    got = moments("dgp", port, x, [torch.tensor(z) for z in zs], S)
    (grad,) = torch.autograd.grad(sum(a.sum() for a in got), x)
    for g, w in [*zip(got, want), (grad, want_grad)]:
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())


def test_de_minimizes_shifted_sphere():
    target = torch.tensor([1.3, -0.7, 0.4], dtype=F64)

    def fn(x):  # [P, 3] -> [P]
        return torch.sum((x - target) ** 2, dim=1)

    res = tde.minimize(fn, torch.zeros(3, dtype=F64),
                       torch.Generator().manual_seed(0),
                       population_size=60, max_iterations=150)
    torch.testing.assert_close(res.position, target, atol=1e-3, rtol=0)
    assert float(res.objective) == float(res.final_fitness.min())


def test_adam_refine_polishes_and_reports_the_final_objective():
    target = torch.tensor([0.5, -0.25], dtype=F64)

    def fn(x, args):
        return torch.sum((x - args) ** 2, dim=1)

    v, obj = tde.adam_refine(fn, torch.zeros(2, dtype=F64), iterations=800,
                             lr=0.05, fn_args=target)
    torch.testing.assert_close(v, target, atol=1e-3, rtol=0)
    assert float(obj) == float(fn(v[None], target)[0])


def test_ei_optimize_finds_the_minimum_region():
    """The GPR models (x-0.5)^2; EI with a mediocre y_min picks a point
    near x = 0.5, by DE and by DE + Adam, and the reported objective is
    -EI at that point."""
    _, port = gpr_pair()
    for method in ("DE", "DE+Adam"):
        ei = tacq.EI(Y_MIN, 1)
        x_opt = ei.optimize(port, (np.zeros(1), np.ones(1)), popsize_DE=30,
                            iterations_DE=30, iterations_adam=60,
                            method=method, key=1)
        assert x_opt.shape == (1, 1) and abs(float(x_opt[0, 0]) - 0.5) < 0.15
        with torch.no_grad():
            at_x = float(ei.run(port, x_opt)[0, 0])
        assert ei.IC_optimized == pytest.approx(at_x, rel=1e-9)


def test_wb2s_auto_scale_and_unported_kinds():
    _, port = gpr_pair()
    w = tacq.WB2S(Y_MIN, 1)
    s = w.resolve_scale(port, (np.zeros(1), np.ones(1)), key=3,
                        popsize_DE=20, iterations_DE=20)
    assert np.isfinite(s) and s > 0 and w.resolve_scale(port, None) == s

    # every surrogate kind of dgp_tpu is ported now; an unknown one still
    # raises at the dispatch boundary
    class Fake:
        name = "nope"

    with pytest.raises(ValueError, match="unsupported surrogate kind"):
        tacq.EI(0.0, 1).run(Fake(), X_EVAL)


def test_keys_are_deterministic_and_distinct():
    a, b = tacq.split_key(5)
    assert (a, b) == tuple(tacq.split_key(5)) and a != b
    assert tacq.fold_in(5, 0) != tacq.fold_in(5, 1)
    assert all(0 <= k < 2 ** 63 for k in (a, b, tacq.fold_in(a, 3)))
