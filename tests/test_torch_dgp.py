"""Port parity: the DGP model of dgp_tpu_torch against dgp_tpu, in float64
on CPU, with weights carried through dgp_tpu_torch.convert and the same
fixed unit normals (zs) in both packages."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.models import dgp as jdgp
from dgp_tpu.ops import conditionals as jcond
from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import conditional_fused as tcf
from dgp_tpu_torch.ops import conditionals as tcond
from dgp_tpu_torch.ops import kernels as TK

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_training import reference_model as training_reference_model


F64 = torch.float64
RTOL = 1e-10
# one compiled program per shape: much cheaper than JAX's op-by-op compiles
jax_propagate = jax.jit(jdgp.propagate, static_argnums=(3, 4))
jax_conditional_diag = jax.jit(functools.partial(jcond.conditional_diag,
                                                 white=False))


def perturbed(model, seed):
    """Perturb every layer's q_mu / q_sqrt so the conditionals are not at
    the prior (where mean = 0 and var = Kff hide errors in A and B)."""
    rng = np.random.default_rng(seed)
    layers = []
    for layer in model.params.layers:
        D, M, _ = layer.q_sqrt.shape
        layers.append(layer.replace(
            q_mu=jnp.asarray(rng.normal(size=(M, D))),
            q_sqrt=layer.q_sqrt + jnp.asarray(
                np.tril(0.1 * rng.normal(size=(D, M, M))))))
    return model.params.replace(layers=tuple(layers))


@functools.lru_cache(maxsize=None)
def reference_model(white, seed=0):
    """2-layer whitened (Din 2 -> 2 -> 1, Identity mean) or 3-layer
    non-whitened (Din 3 -> 2 -> 2 -> 1, PCA then Identity means)."""
    rng = np.random.default_rng(seed)
    Din, units = (2, [2]) if white else (3, [2, 2])
    N, M = 12, 6
    X = rng.uniform(0, 1, size=(N, Din))
    Y = np.sin(3 * X[:, :1]) + 0.1 * rng.normal(size=(N, 1))
    Z = X[rng.choice(N, M, replace=False)].copy()
    dims = [Din] + units
    kernels = [JK.RBF.create(variance=1.2, lengthscales=[0.7] * d) for d in dims]
    if not white:
        kernels[1] = JK.Matern52.create(variance=0.9, lengthscales=[0.8, 1.1])
    model = jdgp.DGP(X, Y, Z, kernels, units, num_samples=3, white=white)
    return perturbed(model, seed + 1), X, Y


def port_of(params):
    return convert.dgp_from_numpy(convert.numpy_tree_from_reference(params),
                                  "cpu", F64)


def normals(params, S, N, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(S, N, layer.num_outputs)) for layer in params.layers]


def npy(x):
    return x.detach().numpy()


def test_weights_carried_through_convert():
    params, _, _ = reference_model(white=False)
    tree = convert.numpy_tree_from_reference(params)
    port = convert.dgp_from_numpy(tree, "cpu", F64)
    assert [type(l.mean_function).__name__ for l in port.layers] == [
        "LinearMean", "Identity", "Zero"]
    for lj, lt in zip(params.layers, port.layers):
        for name in ("z", "q_mu", "q_sqrt"):
            np.testing.assert_array_equal(npy(getattr(lt, name)),
                                          np.asarray(getattr(lj, name)))
        np.testing.assert_array_equal(npy(lt.kernel.lengthscales_raw),
                                      np.asarray(lj.kernel.lengthscales_raw))
        assert lt.white == lj.white and lt.num_outputs == lj.num_outputs
    np.testing.assert_array_equal(npy(port.layers[0].mean_function.W),
                                  np.asarray(params.layers[0].mean_function.W))
    np.testing.assert_array_equal(npy(port.likelihood.variance_raw),
                                  np.asarray(params.likelihood.variance_raw))


def assert_same_tree(got, want, path="params"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}.{i}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def test_nonwhite_convert_round_trip_and_conditional():
    """A non-whitened dgp_tpu model crosses convert and comes back
    unchanged, and each layer's conditional through the port (whose
    quadform dispatch takes the plain version on the CPU) is dgp_tpu's."""
    params, X, _ = reference_model(white=False)
    tree = convert.numpy_tree_from_reference(params)
    port = convert.dgp_from_numpy(tree, "cpu", F64)
    assert not any(l["white"] for l in tree["layers"])
    assert_same_tree(convert.numpy_tree_from_port(port), tree)
    rng = np.random.default_rng(4)
    for lj, lt in zip(params.layers, port.layers):
        Xl = X if lj.z.shape[1] == X.shape[1] else rng.normal(
            size=(7, lj.z.shape[1]))
        want = jax_conditional_diag(lj.kernel, lj.z, lj.q_mu, lj.q_sqrt,
                                    jnp.asarray(Xl))
        with torch.no_grad():
            got = tcond.conditional_diag(lt.kernel, lt.z, lt.q_mu, lt.q_sqrt,
                                         torch.as_tensor(Xl), white=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(npy(g), np.asarray(w), rtol=RTOL)


def test_composite_convert_round_trip_and_predictions(monkeypatch):
    """A whitened model of composite kernels (RBF + Linear on layer 0; a
    Product and active_dims on layer 1) crosses convert and comes back
    unchanged, and with the fused conditional's gate forced open its
    predict_y goes through FusedConditionalWhite (the plain version on CPU
    tensors, once per layer) and equals dgp_tpu's on fixed normals."""
    params, X, Y, zs = training_reference_model(white=True, composite=True)
    tree = convert.numpy_tree_from_reference(params)
    assert [l["kernel"]["type"] for l in tree["layers"]] == ["Sum", "Sum"]
    assert tree["layers"][1]["kernel"]["kernels"][0]["type"] == "Product"
    port = convert.dgp_from_numpy(tree, "cpu", F64)
    assert_same_tree(convert.numpy_tree_from_port(port), tree)

    calls = []
    plain = tcf.fused_conditional_white_plain
    monkeypatch.setattr(tcf, "applicable", lambda *args: True)
    monkeypatch.setattr(tcf, "fused_conditional_white_plain",
                        lambda *args: calls.append(1) or plain(*args))
    S = zs[0].shape[0]
    _, Mj, Vj = jax_propagate(params, jnp.asarray(X), jax.random.PRNGKey(0),
                              S, False, [jnp.asarray(z) for z in zs])
    with torch.no_grad():
        got = tdgp.predict_y(port, torch.as_tensor(X), S,
                             zs=[torch.as_tensor(z) for z in zs])
    assert len(calls) == 2
    want = params.likelihood.predict_mean_and_var(Mj[-1], Vj[-1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(npy(g), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("white", [True, False])
def test_predictions_match_reference(white):
    params, X, Y = reference_model(white)
    port = port_of(params)
    S, N = 3, X.shape[0]
    zs = normals(params, S, N)
    zj = [jnp.asarray(z) for z in zs]
    zt = [torch.as_tensor(z) for z in zs]
    key = jax.random.PRNGKey(0)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    Fj, Mj, Vj = jax_propagate(params, Xj, key, S, False, zj)
    with torch.no_grad():
        Ft, Mt, Vt = tdgp.propagate(port, torch.as_tensor(X), S, zs=zt)
        yt = tdgp.predict_y(port, torch.as_tensor(X), S, zs=zt)
        dt = tdgp.predict_density(port, torch.as_tensor(X), torch.as_tensor(Y),
                                  S, zs=zt)
        ft = tdgp.predict_f(port, torch.as_tensor(X), S, zs=zt)
    for want, got in zip(Fj + Mj + Vj, Ft + Mt + Vt):
        np.testing.assert_allclose(npy(got), np.asarray(want), rtol=RTOL)

    # dgp_tpu's predict_* draw from a key; with the same zs they are these
    # compositions of propagate (models/dgp.py:64-103)
    lik = params.likelihood
    np.testing.assert_allclose(npy(ft[0]), np.asarray(Mj[-1]), rtol=RTOL)
    np.testing.assert_allclose(npy(ft[1]), np.asarray(Vj[-1]), rtol=RTOL)
    yj = lik.predict_mean_and_var(Mj[-1], Vj[-1])
    for want, got in zip(yj, yt):
        np.testing.assert_allclose(npy(got), np.asarray(want), rtol=RTOL)
    log_p = lik.predict_density(Mj[-1], Vj[-1], Yj)
    dj = jax.scipy.special.logsumexp(log_p - jnp.log(float(S)), axis=0)
    np.testing.assert_allclose(npy(dt), np.asarray(dj), rtol=RTOL)
    for want, got in zip(jdgp.moment_matched(*yj), tdgp.moment_matched(*yt)):
        np.testing.assert_allclose(npy(got), np.asarray(want), rtol=RTOL)


def test_reference_initial_elbo_through_port():
    """nb_DGP_regression's initial ELBO (tests/test_dgp.py), with the model
    built entirely by the port: at the reference init every layer's
    marginal is its prior, so the value is deterministic."""
    np.random.seed(0)
    X = np.random.uniform(0, 1, 50)[:, None]
    Z = np.random.uniform(0, 1, 25)[:, None]
    f = lambda x: 0.0 if x < 0.5 else 1.0
    Y = np.reshape([f(x) for x in X], X.shape) + np.random.randn(*X.shape) * 1e-2
    kerns = [TK.RBF.create(lengthscales=[1.0], variance=1.0, dtype=F64)
             for _ in range(3)]
    model = tdgp.DGP(X, Y, Z, kerns, [1, 1], num_samples=10, device="cpu",
                     dtype=F64)
    np.testing.assert_allclose(float(model.ELBO()), -85.98812279560475,
                               atol=1e-7)
    mean, var = model.predict(X, 4)
    assert mean.shape == var.shape == (50, 1) and np.all(var > 0)


def test_elbo_matches_reference_with_fixed_normals():
    params, X, Y = reference_model(white=True)
    port = port_of(params)
    S = 3
    zs = normals(params, S, X.shape[0])
    # dgp_tpu's elbo, with propagate's draws replaced by the fixed zs
    Fj, Mj, Vj = jax_propagate(params, jnp.asarray(X), jax.random.PRNGKey(0),
                               S, False, [jnp.asarray(z) for z in zs])
    var_exp = params.likelihood.variational_expectations(
        Mj[-1], Vj[-1], jnp.asarray(Y))
    from dgp_tpu.layers.svgp import layer_kl
    want = jnp.sum(jnp.mean(var_exp, axis=0)) - sum(
        layer_kl(l, l.z) for l in params.layers)
    with torch.no_grad():
        got = tdgp.elbo(port, torch.as_tensor(X), torch.as_tensor(Y), S,
                        zs=[torch.as_tensor(z) for z in zs])
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def step_model(N=50, M=25, num_units=(1, 1), num_samples=10, **kw):
    """The nb_DGP_regression 1-D step function set-up of tests/test_dgp.py,
    built by the port."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(N, 1))
    Y = (X > 0.5).astype(float) + rng.normal(0, 1e-2, size=(N, 1))
    Z = np.linspace(X.min(), X.max(), M)[:, None]
    kernels = [TK.RBF.create(variance=1.0, lengthscales=[1.0], dtype=F64)
               for _ in range(len(num_units) + 1)]
    model = tdgp.DGP(X, Y, Z, kernels, list(num_units),
                     num_samples=num_samples, device="cpu", dtype=F64, **kw)
    return model, X, Y


def test_optimize_adam_improves_elbo():
    """tests/test_dgp.py::test_adam_improves_elbo through the port (Adam on
    a DGP is non-monotone early: finiteness and net progress)."""
    model, _, _ = step_model(N=30, M=10, num_samples=5)
    losses = model.optimize_adam(iterations=120, lr=0.01, messages=0).numpy()
    assert losses.shape == (120,) and np.all(np.isfinite(losses))
    assert np.min(losses[50:]) < losses[0]


def test_optimize_nat_adam_shapes_and_single_layer_optimum():
    model, X, Y = step_model(N=30, M=10)
    losses = model.optimize_nat_adam(iterations1=3, iterations2=3, messages=0)
    assert losses.shape == (6,) and bool(torch.isfinite(losses).all())
    mean, var = model.predict(X, num_samples=20)
    assert mean.shape == var.shape == (30, 1) and np.all(var > 0)
    # a 1-layer DGP with Z = X: one gamma=1 step reaches the exact GP log
    # marginal likelihood (tests/test_dgp.py)
    from scipy.stats import multivariate_normal
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, size=(20, 1))
    Y = np.sin(6 * X) + 0.05 * rng.normal(size=(20, 1))
    kern = TK.RBF.create(variance=1.0, lengthscales=[0.5], dtype=F64)
    model = tdgp.DGP(X, Y, X.copy(), [kern], [], num_samples=7, device="cpu",
                     dtype=F64)
    losses = model.optimize_nat_adam(iterations1=0, iterations2=1,
                                     lr_adam=0.0, lr_gamma=1.0, messages=0)
    assert losses.shape == (1,)
    with torch.no_grad():
        Kxx = kern.K(torch.as_tensor(X)).numpy()
    noise = float(model.params.likelihood.variance.detach())
    log_ml = multivariate_normal.logpdf(Y[:, 0], mean=np.zeros(20),
                                        cov=Kxx + noise * np.eye(20))
    np.testing.assert_allclose(float(model.ELBO()), log_ml, rtol=1e-5)


def test_optimize_shrink_inner_flag():
    """tests/test_dgp.py::test_optimize_shrink_inner_flag through the port:
    lr=0 Adam makes the update exactly zero, isolating the shrink."""
    model, _, _ = step_model(N=20, M=5, num_units=(1,), num_samples=3)
    norm = lambda: float(torch.linalg.norm(
        model.params.layers[0].q_sqrt.detach()))
    outer0 = model.params.layers[1].q_sqrt.detach().clone()
    norm0 = norm()
    model.optimize_nat_adam(iterations1=1, iterations2=0, lr_adam=0.0,
                            messages=0, shrink_inner=False)
    assert norm() == pytest.approx(norm0, rel=1e-12)
    model.optimize_nat_adam(iterations1=1, iterations2=0, lr_adam=0.0,
                            messages=0)
    n_cold = norm()
    assert n_cold == pytest.approx(1e-3 * norm0, rel=1e-6)
    model.optimize_adam(iterations=1, lr=0.0, messages=0, shrink_inner=False)
    assert norm() == pytest.approx(n_cold, rel=1e-12)
    assert torch.equal(model.params.layers[1].q_sqrt, outer0)  # never the last


def test_optimize_adam_checkpoints(tmp_path):
    from dgp_tpu_torch.utils import checkpoint
    model, _, _ = step_model(N=20, M=5, num_units=(1,), num_samples=2)
    path = str(tmp_path / "dgp.npz")
    model.optimize_adam(iterations=3, messages=0, checkpoint_path=path,
                        checkpoint_every=2)
    after3 = {k: v.clone() for k, v in model.params.state_dict().items()}
    restored = checkpoint.load(path, step_model(N=20, M=5, num_units=(1,))[0].params)
    # saved after step 2 of 3: differs from the final state, equals a 2-step run
    again, _, _ = step_model(N=20, M=5, num_units=(1,), num_samples=2)
    again.optimize_adam(iterations=2, messages=0)
    for k, v in restored.state_dict().items():
        assert torch.equal(v, again.params.state_dict()[k]), k
    assert not torch.equal(after3["layers.0.q_mu"],
                           restored.state_dict()["layers.0.q_mu"])
