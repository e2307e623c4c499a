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
from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import kernels as TK

F64 = torch.float64
RTOL = 1e-10
# one compiled program per shape: much cheaper than JAX's op-by-op compiles
jax_propagate = jax.jit(jdgp.propagate, static_argnums=(3, 4))


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
