"""Port parity: the non-conjugate likelihoods of dgp_tpu_torch (the
Gauss-Hermite ``QuadratureLikelihood`` base, the probit ``Bernoulli`` and
``StudentT``) against dgp_tpu, in float64 on CPU, on the same numpy inputs;
a 2-layer non-whitened DGP with each head on the reference's own unit
normals (ELBO and gradients, predict_y, predict_density and the
moment-matched predict); the convert round trip and checkpoints of both
heads; and short port-only training runs.

The reference runs as compiled programs, one per likelihood and one per
DGP head, each lowered in turn and compiled in a thread at XLA's lowest
backend optimization level (these tiny programs run in microseconds).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch._dynamo  # noqa: F401  (the first torch.optim.Adam imports it)

from dgp_tpu.layers.svgp import layer_kl as jlayer_kl
from dgp_tpu.models import dgp as jdgp
from dgp_tpu.ops import likelihoods as jlik
from dgp_tpu_torch import convert
from dgp_tpu_torch.layers.initializations import init_layers_linear
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import kernels as TK
from dgp_tpu_torch.ops import likelihoods as tlik
from dgp_tpu_torch.utils import checkpoint

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_dgp import assert_same_tree
from test_torch_monitor import reference_params
from test_torch_training import path_name

F64 = torch.float64
RTOL, GRAD_RTOL = 1e-10, 1e-8
LIK_RTOL = 1e-12
FAST_COMPILE = {"xla_backend_optimization_level": 0}
METHODS = ("variational_expectations", "predict_density",
           "predict_mean_and_var")


class JaxLaplace(jlik.QuadratureLikelihood):
    """A head of the reference's quadrature base alone: Laplace noise of
    unit scale."""

    def log_prob(self, F, Y):
        return -jnp.abs(Y - F) - jnp.log(2.0)

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return jnp.full_like(F, 2.0)


class TorchLaplace(tlik.QuadratureLikelihood):
    """The port's counterpart of :class:`JaxLaplace`."""

    def log_prob(self, F, Y):
        return -torch.abs(Y - F) - np.log(2.0)

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return torch.full_like(F, 2.0)


def heads():
    """{name: (reference head, port head)}."""
    return {
        "Bernoulli": (jlik.Bernoulli(num_gh=20), tlik.Bernoulli(20)),
        "StudentT": (jlik.StudentT.create(scale=0.4, df=4.0, num_gh=15),
                     tlik.StudentT.create(scale=0.4, df=4.0, num_gh=15,
                                          dtype=F64)),
        "Quadrature": (JaxLaplace(num_gh=12), TorchLaplace(12)),
    }


def moments():
    """Seeded [S, N, D] moments (one variance exactly 0, one negative: the
    quadrature clamps them) and targets for each head (0/1 for
    Bernoulli)."""
    rng = np.random.default_rng(0)
    Fmu = 2.0 * rng.normal(size=(3, 5, 2))
    Fvar = rng.uniform(0.01, 2.0, size=(3, 5, 2))
    Fvar[0, 0, 0], Fvar[1, 2, 1] = 0.0, -1e-3
    Y = rng.normal(size=(5, 2))
    return Fmu, Fvar, {"Bernoulli": (Y > 0).astype(float), "StudentT": Y,
                       "Quadrature": Y}


def classification_targets(Y):
    return (Y > np.median(Y)).astype(float)


@functools.lru_cache(maxsize=None)
def dgp_reference():
    """A 2-layer non-whitened DGP built by the port (Din 3 -> 2 -> 1: RBF,
    then Matern-5/2; a PCA mean on layer 0; N = 12, M = 6, S = 3), q moved
    off the prior, with each head, as the reference's parameters holding
    the same arrays (test_torch_monitor.reference_params), and fixed unit
    normals: (X, zs, {head: (params, Y)})."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(12, 3))
    Y = np.sin(3 * X[:, :1]) + 0.1 * rng.normal(size=(12, 1))
    Z = X[rng.choice(12, 6, replace=False)].copy()
    kernels = [TK.RBF.create(variance=1.2, lengthscales=[0.7] * 3, dtype=F64),
               TK.Matern52.create(variance=0.9, lengthscales=[0.8, 1.1],
                                  dtype=F64)]
    model = tdgp.DGP(X, Y, Z, kernels, [2], num_samples=3, device="cpu",
                     dtype=F64)
    with torch.no_grad():
        for layer in model.params.layers:
            D, M, _ = layer.q_sqrt.shape
            layer.q_mu.copy_(torch.as_tensor(rng.normal(size=(M, D))))
            layer.q_sqrt.add_(torch.as_tensor(
                np.tril(0.1 * rng.normal(size=(D, M, M)))))
    zs = [rng.normal(size=(3, 12, l.num_outputs)) for l in model.params.layers]
    params = reference_params(model.params)
    return X, zs, {
        "Bernoulli": (params.replace(likelihood=jlik.Bernoulli(num_gh=20)),
                      classification_targets(Y)),
        "StudentT": (params.replace(likelihood=jlik.StudentT.create(
            scale=0.4, df=4.0, num_gh=20)), Y)}


def dgp_program(X, Y, zs):
    """The reference's -ELBO on the fixed normals with its gradient, and
    its predict_y, predict_density and moment-matched predict on the same
    normals (dgp_tpu's predict_* are these compositions of propagate)."""
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    zj = [jnp.asarray(z) for z in zs]
    S = zs[0].shape[0]

    def loss(params):
        _, Fm, Fv = jdgp.propagate(params, Xj, jax.random.PRNGKey(0), S,
                                   False, zj)
        ve = params.likelihood.variational_expectations(Fm[-1], Fv[-1], Yj)
        kl = sum(jlayer_kl(l, l.z) for l in params.layers)
        return -(jnp.sum(jnp.mean(ve, axis=0)) - kl), (Fm[-1], Fv[-1])

    def program(params):
        (value, (m, v)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        lik = params.likelihood
        y = lik.predict_mean_and_var(m, v)
        density = jax.scipy.special.logsumexp(
            lik.predict_density(m, v, Yj) - jnp.log(float(S)), axis=0)
        return value, grads, y, density, jdgp.moment_matched(*y)

    return program


@functools.lru_cache(maxsize=None)
def programs():
    """The reference's outputs: {("dgp", head): dgp_program's outputs} of
    the DGP and {("lik", head): the three methods' outputs} of each
    likelihood on moments(), each program traced in turn (the costliest to
    compile first) and compiled in a thread while the next is traced."""
    Fmu, Fvar, Ys = moments()
    X, zs, models = dgp_reference()
    compiled = {}
    with ThreadPoolExecutor(4) as pool:
        for name, (params, Y) in models.items():
            traced = jax.jit(dgp_program(X, Y, zs)).trace(params)
            compiled[("dgp", name)] = (pool.submit(
                traced.lower().compile, FAST_COMPILE), (params,))
        for name, (jl, _) in heads().items():
            def methods(lik, Y):
                return (lik.variational_expectations(Fmu, Fvar, Y),
                        lik.predict_density(Fmu, Fvar, Y),
                        lik.predict_mean_and_var(Fmu, Fvar))
            traced = jax.jit(methods).trace(jl, jnp.asarray(Ys[name]))
            compiled[("lik", name)] = (pool.submit(
                traced.lower().compile, FAST_COMPILE), (jl, Ys[name]))
        return {key: c.result()(*args) for key, (c, args) in compiled.items()}


def npy(x):
    return x.detach().numpy()


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("head", ["Bernoulli", "StudentT", "Quadrature"])
def test_quadrature_likelihoods_match_reference(head, method):
    Fmu, Fvar, Ys = moments()
    want = programs()[("lik", head)][METHODS.index(method)]
    lik = heads()[head][1]
    args = (torch.as_tensor(Fmu), torch.as_tensor(Fvar))
    if method != "predict_mean_and_var":
        args += (torch.as_tensor(Ys[head]),)
    got = getattr(lik, method)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == F64 and g.shape == w.shape
        close(npy(g), w, LIK_RTOL)


def test_gauss_hermite_nodes_built_once_per_dtype_and_device():
    """The nodes are built once per size, dtype and device and held by no
    module (no buffer, so a checkpoint's keys stay the model's)."""
    lik = tlik.Bernoulli(7)
    x = torch.zeros(2, 1, dtype=torch.float32)
    nodes = lik._nodes(x, x + 1.0)[1]
    assert lik._nodes(x, x)[1] is nodes and nodes.dtype == torch.float32
    assert lik._nodes(x.double(), x.double())[1].dtype == F64
    assert nodes.shape == (7,) and abs(float(nodes.sum()) - 1.0) < 1e-6
    assert not list(lik.buffers()) and not list(lik.parameters())
    assert [n for n, _ in tlik.StudentT.create(dtype=F64).named_parameters()
            ] == ["scale_raw"]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_bernoulli_log_prob_finite_at_saturating_logits(dtype):
    """tests/test_likelihoods.py::test_bernoulli_log_prob_finite_in_float32
    through the port: the log_ndtr probit stays finite, with finite
    gradients, at F = +-40 in both dtypes (the clipped-cdf form gives
    0 * -inf = NaN in float32), and so do the variational expectations of
    saturating means."""
    lik = tlik.Bernoulli()
    for y in (0.0, 1.0):
        F = torch.tensor([-40.0, -8.0, 0.0, 8.0, 40.0], dtype=dtype,
                         requires_grad=True)
        lp = lik.log_prob(F, torch.full_like(F, y))
        (g,) = torch.autograd.grad(lp.sum(), F)
        assert bool(torch.isfinite(lp).all()) and bool(torch.isfinite(g).all())
    F = torch.tensor([-40.0, -8.0, 0.0, 8.0, 40.0], dtype=dtype)
    ve = lik.variational_expectations(F, torch.ones_like(F), torch.ones_like(F))
    assert bool(torch.isfinite(ve).all())
    p, v = lik.predict_mean_and_var(F, torch.ones_like(F))
    assert bool(((p >= 0) & (p <= 1) & (v >= 0)).all())


def port_with_head(head):
    X, zs, models = dgp_reference()
    params, Y = models[head]
    port = convert.dgp_from_numpy(convert.numpy_tree_from_reference(params),
                                  "cpu", F64)
    return port, params, X, Y, [torch.as_tensor(z) for z in zs]


@pytest.mark.parametrize("head", ["Bernoulli", "StudentT"])
def test_elbo_and_gradients_match_reference(head):
    port, _, X, Y, zt = port_with_head(head)
    loss = -tdgp.elbo(port, torch.as_tensor(X), torch.as_tensor(Y), 3, zs=zt)
    grads = torch.autograd.grad(loss, list(port.parameters()))
    value, want, *_ = programs()[("dgp", head)]
    close(float(loss.detach()), float(value), RTOL)
    want = {path_name(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(zip((n for n, _ in port.named_parameters()), grads))
    assert set(got) == set(want) - {"layers.0.mean_function.W"}
    assert ("likelihood.scale_raw" in got) == (head == "StudentT")
    for name, g in got.items():
        close(npy(g), want[name], GRAD_RTOL)


@pytest.mark.parametrize("head", ["Bernoulli", "StudentT"])
def test_predictions_match_reference(head):
    port, _, X, Y, zt = port_with_head(head)
    *_, y, density, mm = programs()[("dgp", head)]
    with torch.no_grad():
        Xt = torch.as_tensor(X)
        yt = tdgp.predict_y(port, Xt, 3, zs=zt)
        dt = tdgp.predict_density(port, Xt, torch.as_tensor(Y), 3, zs=zt)
    for got, want in zip((*yt, dt, *tdgp.moment_matched(*yt)),
                         (*y, density, *mm)):
        close(npy(got), want, RTOL)


@pytest.mark.parametrize("head", ["Bernoulli", "StudentT"])
def test_convert_round_trip_and_checkpoint(head, tmp_path):
    """Each head crosses convert to the port and back unchanged (the tree
    from the port rebuilds the reference's head), and a checkpoint of the
    port's model saves and restores it with the keys of its state_dict:
    the quadrature nodes are not among them."""
    port, params, *_ = port_with_head(head)
    tree = convert.numpy_tree_from_reference(params)
    back = convert.numpy_tree_from_port(port)
    assert_same_tree(back, tree)
    lik = back["likelihood"]
    assert lik["type"] == head and lik["num_gh"] == params.likelihood.num_gh
    if head == "StudentT":
        rebuilt = jlik.StudentT(scale_raw=jnp.asarray(lik["scale_raw"]),
                                df=lik["df"], num_gh=lik["num_gh"])
        assert rebuilt.df == params.likelihood.df == 4.0
        assert float(rebuilt.scale) == float(params.likelihood.scale)
    else:
        assert jlik.Bernoulli(num_gh=lik["num_gh"]) == params.likelihood

    path = str(tmp_path / f"{head}.npz")
    checkpoint.save(path, port)
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    assert set(np.load(path).files) == set(saved)
    assert ("likelihood.scale_raw" in saved) == (head == "StudentT")
    with torch.no_grad():
        for p in port.parameters():
            p.add_(0.5)
    assert checkpoint.load(path, port) is port
    for k, v in port.state_dict().items():
        assert torch.equal(v, saved[k]), k


def small_model(head, white=False):
    """A port-only 2-layer DGP (Din 2, hidden width 2, M = 8, S = 3) on 40
    rows: a band classifier with the Bernoulli head, a regression with
    outliers with the StudentT head."""
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 1, size=(40, 2))
    f = np.sin(6 * X[:, :1]) + 2 * (X[:, 1:] - 0.5)
    if head == "Bernoulli":
        Y, lik = (f > 0).astype(float), tlik.Bernoulli(10)
    else:
        Y = f + 0.05 * rng.normal(size=f.shape)
        Y[::8] += 3.0
        lik = tlik.StudentT.create(scale=0.1, dtype=F64)
    kernels = [TK.RBF.create(lengthscales=[0.5, 0.5], dtype=F64)
               for _ in range(2)]
    layers = init_layers_linear(X, Y, X[::5].copy(), kernels, [2],
                                white=white, dtype=F64, device="cpu")
    return tdgp.DGP.from_layers(X, Y, layers, likelihood=lik, num_samples=3,
                                seed=0, device="cpu", dtype=F64)


@pytest.mark.parametrize("head", ["Bernoulli", "StudentT"])
def test_adam_trains_each_head(head):
    model = small_model(head)
    losses = model.optimize_adam(iterations=30, lr=0.05, messages=0).numpy()
    assert losses.shape == (30,) and np.all(np.isfinite(losses))
    assert losses[-5:].mean() < losses[0]
    mean, var = model.predict(model.data[0].numpy(), 4)
    assert mean.shape == var.shape == (40, 1) and np.all(var >= 0)
    if head == "Bernoulli":
        assert np.all((mean >= 0) & (mean <= 1))


@pytest.mark.parametrize("white", [False, True])
def test_natural_gradients_under_a_non_conjugate_head(white):
    """optimize_nat_adam runs natural gradients on every layer's q under
    the quadrature head (tests/test_likelihoods.py::
    test_dgp_with_bernoulli_likelihood_trains for the reference): finite
    losses, and the natural-gradient phase moves every layer's q."""
    model = small_model("Bernoulli", white)
    model.optimize_adam(iterations=5, lr=0.05, messages=0)
    before = {k: v.clone() for k, v in model.params.state_dict().items()}
    losses = model.optimize_nat_adam(iterations1=0, iterations2=8,
                                     lr_adam=0.05, lr_gamma=0.1,
                                     messages=0, shrink_inner=False)
    assert losses.shape == (8,) and bool(torch.isfinite(losses).all())
    after = model.params.state_dict()
    for i in range(2):
        for name in ("q_mu", "q_sqrt"):
            key = f"layers.{i}.{name}"
            assert not torch.equal(after[key], before[key]), key
