"""The port's public surface against dgp_tpu's: every public name of the
JAX package's top level and of its models, layers, variational, bo,
parallel, utils and native namespaces resolves in dgp_tpu_torch or is a
listed deliberate difference; the precision switch; the small helpers
(add_jitter, safe_cholesky, tril, hv_2d) on the same numbers."""

import ast
import importlib
import inspect
import types

import numpy as np
import pytest
import torch

import dgp_tpu
import dgp_tpu.bo
import dgp_tpu.layers
import dgp_tpu.models
import dgp_tpu.native
import dgp_tpu.parallel
import dgp_tpu.utils
import dgp_tpu.variational
import jax.numpy as jnp
from dgp_tpu import config as jconfig
from dgp_tpu.ops import linalg as jlinalg
from dgp_tpu.ops import transforms as jtransforms
import dgp_tpu_torch
from dgp_tpu_torch import config as tconfig
from dgp_tpu_torch import native as tnative
from dgp_tpu_torch.ops import linalg as tlinalg
from dgp_tpu_torch.ops import transforms as ttransforms

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

PARAMS = ("the JAX package's pytree struct of a model's parameters; the "
          "port keeps them in nn.Modules, which convert.py maps to and from")
PASSES = "the TPU's MXU pass-count knob: the port runs IEEE fp32 throughout"
DIFFERENCES = {
    "bwd_precision": PASSES,
    "quad_precision": PASSES,
    "set_bwd_precision": PASSES,
    "set_quad_precision": PASSES,
    "models.DGPParams": PARAMS,
    "models.GPRParams": PARAMS,
    "models.MFDGPParams": PARAMS,
    "models.MFDGPEMParams": PARAMS,
    "models.MODGPParams": PARAMS,
}
NAMESPACES = ("models", "layers", "variational", "bo", "parallel", "utils",
              "native")


def lazy_exports(package):
    """The keys of the ``_exports`` dict in ``package.__getattr__``."""
    tree = ast.parse(inspect.getsource(package.__getattr__))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
    raise AssertionError("no _exports dict")


def public_names(module, prefix):
    """(qualified name, is a submodule) of the module's public names that
    the JAX package defines: its own functions, classes and submodules,
    not what it imports from elsewhere."""
    out = []
    for name, value in vars(module).items():
        if name.startswith("_") or name == "annotations":
            continue
        if isinstance(value, types.ModuleType):
            if value.__name__.startswith(module.__name__ + "."):
                out.append((f"{prefix}{name}", True))
            continue
        if getattr(value, "__module__", "").startswith("dgp_tpu"):
            out.append((f"{prefix}{name}", False))
    return out


def surface():
    names = [(n, False) for n in lazy_exports(dgp_tpu)]
    names += public_names(dgp_tpu, "")
    for ns in NAMESPACES:
        names += public_names(getattr(dgp_tpu, ns), f"{ns}.")
    return sorted(set(names))


def resolve(qualified, submodule):
    *path, name = qualified.split(".")
    module = importlib.import_module(".".join(["dgp_tpu_torch", *path]))
    if submodule:
        return importlib.import_module(f"{module.__name__}.{name}")
    return getattr(module, name)


def test_every_public_name_resolves_or_is_a_listed_difference():
    names = surface()
    assert len(names) > 80
    missing = []
    for qualified, submodule in names:
        if qualified in DIFFERENCES:
            with pytest.raises((AttributeError, ImportError)):
                resolve(qualified, submodule)
            continue
        try:
            resolve(qualified, submodule)
        except (AttributeError, ImportError) as e:
            missing.append(f"{qualified}: {e}")
    assert not missing, "\n".join(missing)
    assert set(DIFFERENCES) <= {n for n, _ in names}


def test_top_level_exports_are_the_ports_own():
    """The lazy exports point at the port's classes and modules, and
    ``import dgp_tpu_torch`` alone imports none of the models."""
    for name in lazy_exports(dgp_tpu):
        value = getattr(dgp_tpu_torch, name)
        owner = value.__name__ if isinstance(value, types.ModuleType) \
            else value.__module__
        assert owner.startswith("dgp_tpu_torch.")
    assert dgp_tpu_torch.parallel.make_mesh.__module__ == (
        "dgp_tpu_torch.parallel.mesh")
    assert dgp_tpu_torch.summary.__module__ == "dgp_tpu_torch.utils.monitor"
    with pytest.raises(AttributeError):
        dgp_tpu_torch.NoSuchThing  # noqa: B018


@pytest.fixture
def precision_restored():
    """Both packages' precision state put back after the test (it is
    process-wide, and xdist runs other tests in this process)."""
    saved = dict(tconfig._STATE), dict(jconfig._STATE)
    try:
        yield
    finally:
        tconfig._STATE.update(saved[0])
        jconfig._STATE.update(saved[1])


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_set_default_float_matches_the_reference(name, precision_restored):
    dgp_tpu_torch.set_default_float(getattr(torch, name))
    jconfig.set_default_float(name)
    assert dgp_tpu_torch.default_float() == getattr(torch, name)
    assert str(jconfig.default_float()) == name
    assert dgp_tpu_torch.default_jitter() == jconfig.default_jitter()
    dgp_tpu_torch.set_default_jitter(3e-5)
    jconfig.set_default_jitter(3e-5)
    assert dgp_tpu_torch.default_jitter() == jconfig.default_jitter() == 3e-5
    assert dgp_tpu_torch.default_jitter(torch.float32) == 3e-5


def test_models_take_the_default_float(precision_restored):
    from dgp_tpu_torch.ops import kernels as K

    assert dgp_tpu_torch.default_float() == torch.float32
    dgp_tpu_torch.set_default_float("float64")
    X = np.random.default_rng(0).uniform(size=(6, 1))
    model = dgp_tpu_torch.DGP(X, np.sin(X), X[:3],
                              [K.RBF.create(lengthscales=[1.0])] * 2, [1],
                              device="cpu")
    assert {p.dtype for p in model.params.parameters()} == {torch.float64}
    assert model.data[0].dtype == torch.float64
    with pytest.raises(ValueError, match="float32 or float64"):
        dgp_tpu_torch.set_default_float(torch.float16)


def spd_stack(seed, G=3, M=7):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(G, M, M))
    return A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(M)


@pytest.mark.parametrize("jitter", [None, 1e-3])
def test_add_jitter_and_safe_cholesky_match_the_reference(jitter):
    K = spd_stack(0)
    want = np.asarray(jlinalg.add_jitter(jnp.asarray(K), jitter))
    got = tlinalg.add_jitter(torch.as_tensor(K), jitter).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    want = np.asarray(jlinalg.safe_cholesky(jnp.asarray(K), jitter))
    got = tlinalg.safe_cholesky(torch.as_tensor(K), jitter).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_safe_cholesky_gives_nan_for_an_indefinite_matrix():
    K = spd_stack(1, G=2)
    K[1] -= 50.0 * np.eye(K.shape[-1])
    want = np.asarray(jlinalg.safe_cholesky(jnp.asarray(K)))
    got = tlinalg.safe_cholesky(torch.as_tensor(K)).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-14)
    lower = np.tril(np.ones(K.shape[1:], dtype=bool))
    assert np.isnan(got[1][lower]).all() and np.isnan(want[1][lower]).all()


def test_tril_matches_the_reference():
    x = np.random.default_rng(2).normal(size=(2, 5, 5))
    np.testing.assert_array_equal(
        ttransforms.tril(torch.as_tensor(x)).numpy(),
        np.asarray(jtransforms.tril(jnp.asarray(x))))


def test_num_inducing():
    from dgp_tpu_torch.layers import make_svgp_layer
    from dgp_tpu_torch.ops import kernels as K

    Z = np.random.default_rng(3).uniform(size=(9, 2))
    kern = K.RBF.create(lengthscales=[1.0, 1.0], dtype=torch.float64)
    plain = make_svgp_layer(kern, Z, 1, dtype=torch.float64, device="cpu")
    augmented = make_svgp_layer(kern, Z, 1, white=True, augmented=True,
                                dtype=torch.float64, device="cpu")
    assert plain.num_inducing == augmented.num_inducing == 9


def front(n, seed):
    """An in-box non-dominated front of n points and its indices."""
    rng = np.random.default_rng(seed)
    y0 = np.sort(rng.uniform(-4.0, 2.0, n))
    y1 = np.sort(rng.uniform(-4.0, 2.0, n))[::-1]
    Y = [y0.reshape(-1, 1), y1.reshape(-1, 1)]
    return list(range(n)), Y


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (600, 2)])
def test_hv_2d_matches_the_reference(n, seed):
    nd, Y = front(n, seed)
    bounds = (-5.0, -5.0, 2.5, 2.5)
    want = dgp_tpu.native.hv_2d(nd, Y, bounds)
    assert tnative.hv_2d(nd, Y, bounds) == pytest.approx(want, rel=1e-12)
