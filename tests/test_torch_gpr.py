"""Port parity: exact GP regression (``dgp_tpu_torch/models/gpr.py``)
against ``dgp_tpu.models.gpr`` in float64 on CPU, on the same numpy data and
the same parameters (``convert.numpy_tree_from_reference`` /
``gpr_from_numpy``): the negative log marginal likelihood, the posterior and
the predictive, with and without bucket padding; the likelihood's
gradients; five Adam steps."""

import functools

import jax
import numpy as np
import pytest
import torch

from dgp_tpu.models import gpr as jgpr
from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import gpr as tgpr
from dgp_tpu_torch.ops import kernels as TK

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64


def data(n=11, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(n, d))
    Y = np.sin(3 * X[:, :1]) + 0.1 * X[:, 1:] ** 2 + 0.01 * rng.normal(size=(n, 1))
    return X, Y


def models(n_bucket):
    """The same GPR in both packages: dgp_tpu's, and the port's carrying
    its parameters."""
    X, Y = data()
    ref = jgpr.GPR((X, Y), JK.RBF.create(variance=0.8, lengthscales=[0.3, 0.5]),
                   noise_variance=1e-3, n_bucket=n_bucket)
    port = tgpr.GPR((X, Y), TK.RBF.create(variance=0.8, lengthscales=[0.3, 0.5],
                                          dtype=F64),
                    noise_variance=1e-3, n_bucket=n_bucket, device="cpu",
                    dtype=F64)
    tree = convert.numpy_tree_from_reference(ref.params)
    port.params = convert.gpr_from_numpy(tree, "cpu", F64)
    return ref, port


@functools.lru_cache(maxsize=None)
def reference(n_bucket):
    """dgp_tpu's likelihood, its gradient and both predictions at 7 new
    points, each through one jitted program (its eager ops would compile
    one by one)."""
    ref, _ = models(n_bucket)
    Xnew = np.random.default_rng(1).uniform(0, 1, size=(7, 2))
    X, Y, w = ref.train_data
    loss, grad = jax.jit(jax.value_and_grad(jgpr.neg_log_marginal_likelihood))(
        ref.params, X, Y, w)
    data = (X, Y) if w is None else (X, Y, w)
    pf = jax.jit(jgpr.predict_f)(ref.params, data, Xnew)
    py = jax.jit(jgpr.predict_y)(ref.params, data, Xnew)
    return Xnew, float(loss), grad, {"predict_f": pf, "predict_y": py}


def assert_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_constructor_and_convert_round_trip():
    """The port's wrapper builds the parameters dgp_tpu's builds from the
    same arguments, and the tree survives the round trip."""
    X, Y = data()
    ref = jgpr.GPR((X, Y), JK.RBF.create(variance=0.8, lengthscales=[0.3, 0.5]),
                   noise_variance=1e-3)
    port = tgpr.GPR((X, Y), TK.RBF.create(variance=0.8, lengthscales=[0.3, 0.5],
                                          dtype=F64),
                    noise_variance=1e-3, device="cpu", dtype=F64)
    want = convert.numpy_tree_from_reference(ref.params)
    got = convert.numpy_tree_from_port(port.params)
    for part in ("kernel", "likelihood"):
        for k, v in want[part].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(got[part][k], v, rtol=1e-15)
            else:
                assert got[part][k] == v


@pytest.mark.parametrize("n_bucket", [None, 8])
def test_nmll_and_predictions_match_reference(n_bucket):
    _, port = models(n_bucket)
    Xnew, loss, _, predictions = reference(n_bucket)
    assert_close(port.training_loss(), loss, 1e-10)
    for name, want in predictions.items():
        got = getattr(port, name)(Xnew)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert_close(g, w, 1e-10)
    if n_bucket:
        # the padded rows are decoupled exactly: the unpadded posterior
        X, Y = port.data
        unpadded = tgpr.predict_f(port.params, (X, Y), torch.tensor(Xnew))
        for g, w in zip(port.predict_f(Xnew), unpadded):
            assert_close(g, w.detach(), 1e-12)


@pytest.mark.parametrize("n_bucket", [None, 8])
def test_nmll_gradients_match_jax_grad(n_bucket):
    _, port = models(n_bucket)
    gj = reference(n_bucket)[2]
    want = {"kernel.variance_raw": gj.kernel.variance_raw,
            "kernel.lengthscales_raw": gj.kernel.lengthscales_raw,
            "likelihood.variance_raw": gj.likelihood.variance_raw}
    names, params = zip(*port.params.named_parameters())
    grads = torch.autograd.grad(port.training_loss(), params)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert_close(g, want[name], 1e-8)


def test_five_adam_steps_match_optax():
    ref, port = models(8)
    want = ref.optimize_adam(iterations=5, lr=0.01)
    got = port.optimize_adam(iterations=5, lr=0.01)
    assert_close(got, want, 1e-8)
    tree = convert.numpy_tree_from_reference(ref.params)
    mine = convert.numpy_tree_from_port(port.params)
    for part in ("kernel", "likelihood"):
        for k, v in tree[part].items():
            if isinstance(v, np.ndarray):
                assert_close(mine[part][k], v, 1e-8)


def test_gram_not_positive_definite_gives_nan_and_a_warning():
    """A Gram that is not positive definite (a negative noise variance that
    outweighs the kernel) gives a NaN likelihood, not an exception, and
    Adam warns after the phase, as dgp_tpu's loops do."""
    _, port = models(None)
    port.params = tgpr.GPRParams(port.params.kernel, _NegativeNoise())
    X, Y = port.data
    assert torch.isnan(tgpr.neg_log_marginal_likelihood(port.params, X, Y))
    mean, var = tgpr.predict_f(port.params, (X, Y), X[:3])
    assert torch.isnan(mean).all() and torch.isnan(var).all()
    with pytest.warns(RuntimeWarning, match="non-finite"):
        losses = port.optimize_adam(iterations=2)
    assert torch.isnan(losses).all()


class _NegativeNoise(torch.nn.Module):
    """A Gaussian likelihood whose variance is -2: the Gram K - 2 I (with
    K's diagonal below 1) is negative definite."""

    variance = -2.0


def test_gpr_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = data()
    kern = TK.RBF.create(lengthscales=[0.3, 0.5], dtype=F64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpr.GPR((X, Y), kern, dtype=F64)
    assert tgpr.GPR((X, Y), kern, dtype=F64, device="cpu").name == "gpr"
