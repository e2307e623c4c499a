"""Port parity: the monitor utilities of dgp_tpu_torch (``summary``,
``summarize_tensor``, ``grad_norms``, ``training_metrics``) against
dgp_tpu's on the same numbers, and the profiling utilities (``trace``,
``steps_per_sec``).

Each model is built by the port on the CPU (no reference constructor
runs), and the reference's parameters are the JAX package's dataclasses
holding the same arrays (:func:`reference_params`, from convert's numpy
tree): ``summary`` only walks them, so no JAX program beyond the softplus
of each raw leaf is compiled.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgp_tpu.layers.svgp import SVGPLayer as JSVGPLayer
from dgp_tpu.models import dgp as jdgp
from dgp_tpu.models import gpr as jgpr
from dgp_tpu.models import mf_dgp as jmf
from dgp_tpu.models import mf_dgp_em as jem
from dgp_tpu.models import mo_dgp as jmo
from dgp_tpu.ops import kernels as JK
from dgp_tpu.ops import likelihoods as jlik
from dgp_tpu.ops import means as jmeans
from dgp_tpu.utils import monitor as jmon
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.models.gpr import GPR
from dgp_tpu_torch.models.mf_dgp import MultiFidelityDeepGP
from dgp_tpu_torch.models.mf_dgp_em import MultiFidelityDeepGP_EM
from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP
from dgp_tpu_torch.ops import kernels as TK
from dgp_tpu_torch.ops import likelihoods as tlik
from dgp_tpu_torch.utils import monitor as tmon
from dgp_tpu_torch.utils import profiling

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def _kernel(t):
    name = t["type"]
    if name in ("Sum", "Product"):
        return getattr(JK, name)(kernels=tuple(map(_kernel, t["kernels"])))
    fields = dict(variance_raw=jnp.asarray(t["variance_raw"]),
                  active_dims=None if t["active_dims"] is None
                  else tuple(t["active_dims"]))
    if "lengthscales_raw" in t:
        fields["lengthscales_raw"] = jnp.asarray(t["lengthscales_raw"])
    return getattr(JK, name)(**fields)


def _mean(t):
    if t["type"] == "Zero":
        return jmeans.Zero(t["num_outputs"])
    if t["type"] == "Identity":
        return jmeans.Identity()
    return jmeans.LinearMean(W=jnp.asarray(t["W"]))


def _likelihood(t):
    if t["type"] == "Gaussian":
        return jlik.Gaussian(variance_raw=jnp.asarray(t["variance_raw"]))
    if t["type"] == "Bernoulli":
        return jlik.Bernoulli(num_gh=t["num_gh"])
    return jlik.StudentT(scale_raw=jnp.asarray(t["scale_raw"]), df=t["df"],
                         num_gh=t["num_gh"])


def _layer(t):
    array = lambda name: jnp.asarray(t[name]) if name in t else None
    return JSVGPLayer(
        kernel=_kernel(t["kernel"]), z=array("z"), z_left=array("z_left"),
        q_mu=array("q_mu"), q_sqrt=array("q_sqrt"),
        mean_function=_mean(t["mean_function"]),
        num_outputs=t["num_outputs"], white=t["white"],
        input_prop_dim=t["input_prop_dim"], augmented="z_left" in t)


def reference_params(port_params):
    """The JAX package's parameters holding the port's ``port_params``
    (DGPParams, MFDGPParams, MFDGPEMParams, MODGPParams or GPRParams),
    built from convert's numpy tree: the same arrays under the same
    fields."""
    tree = convert.numpy_tree_from_port(port_params)
    if "kernel" in tree:
        return jgpr.GPRParams(kernel=_kernel(tree["kernel"]),
                              likelihood=_likelihood(tree["likelihood"]))
    layers = tuple(map(_layer, tree["layers"]))
    lik = _likelihood(tree["likelihood"])
    if "layers_red" in tree:
        return jem.MFDGPEMParams(
            layers=layers, layers_red=tuple(map(_layer, tree["layers_red"])),
            likelihood=lik,
            likelihood_projection=_likelihood(tree["likelihood_projection"]))
    cls = {"MFDGPParams": jmf.MFDGPParams, "MODGPParams": jmo.MODGPParams}.get(
        type(port_params).__name__, jdgp.DGPParams)
    return cls(layers=layers, likelihood=lik)


def nb_regression_model():
    """nb_DGP_regression's 3-layer non-whitened DGP (N = 50, M = 25, D = 1),
    built by the port."""
    np.random.seed(0)
    X = np.random.uniform(0, 1, 50)[:, None]
    Z = np.random.uniform(0, 1, 25)[:, None]
    Y = (X > 0.5).astype(float) + np.random.randn(*X.shape) * 1e-2
    kernels = [TK.RBF.create(lengthscales=[1.0], variance=1.0, dtype=F64)
               for _ in range(3)]
    return tdgp.DGP(X, Y, Z, kernels, [1, 1], num_samples=2, **CPU)


def models():
    """{name: a port model wrapper} for every family ``summary`` reads."""
    rng = np.random.default_rng(0)
    X3 = rng.uniform(size=(12, 3))
    Y3 = np.sin(3 * X3[:, :1])
    composite = [TK.RBF.create(variance=1.2, lengthscales=[0.7] * 3, dtype=F64)
                 + TK.Linear.create(variance=[0.5, 0.8, 0.3], dtype=F64),
                 TK.Matern52.create(variance=0.9, lengthscales=[0.8, 1.1],
                                    dtype=F64)]
    X4 = [rng.uniform(size=(8, 4)), rng.uniform(size=(4, 4))]
    X2 = rng.uniform(size=(6, 1))
    return {
        "nb_DGP_regression": nb_regression_model,
        "DGP whitened, Sum kernel, LinearMean, StudentT": lambda: tdgp.DGP(
            X3, Y3, X3[:5], composite, [2], white=True,
            likelihood=tlik.StudentT.create(0.3, df=5.0, dtype=F64), **CPU),
        "GPR": lambda: GPR((X3, Y3), TK.RBF.create(lengthscales=[0.5] * 3,
                                                   dtype=F64), **CPU),
        "MF-DGP": lambda: MultiFidelityDeepGP(
            X4, [np.sin(x.sum(1, keepdims=True)) for x in X4], **CPU),
        "MF-DGP-EM": lambda: MultiFidelityDeepGP_EM(
            [X4[0][:, :2], X4[1]], [np.cos(x.sum(1, keepdims=True))
                                    for x in X4], [X4[1][:, :2]], **CPU),
        "MO-DGP": lambda: MultiObjDeepGP([X2, X2.copy()], [np.sin(3 * X2),
                                                          np.cos(3 * X2)],
                                         loop=1, **CPU),
    }


@pytest.mark.parametrize("name", list(models()))
def test_summary_rows_match_reference(name):
    """One row per reference leaf, in its order, with its name, transform,
    shape, dtype, shown value and size; the printed table too."""
    model = models()[name]()
    ref = reference_params(model.params)
    lines, want_lines = [], []
    rows = tmon.summary(model, print_fn=lines.append)
    want = jmon.summary(ref, print_fn=want_lines.append)
    assert rows == want and lines == want_lines
    assert tmon.summary(model.params, print_fn=None) == rows
    names = [r["name"] for r in rows]
    assert len(set(names)) == len(names) >= 3
    if name == "nb_DGP_regression":
        assert lines[-1] == "total parameters: 2032"
        assert sum(r["size"] for r in rows) == model.number_parameters()
        assert names[:5] == ["layers[0].kernel.variance",
                             "layers[0].kernel.lengthscales", "layers[0].z",
                             "layers[0].q_mu", "layers[0].q_sqrt"]
    if name.startswith("MF-DGP-EM"):
        assert "layers_red[0].z" in names and names[-1] == (
            "likelihood_projection.variance")


def test_summary_of_a_bare_module():
    """A module that is not one of the models: tensors before submodules,
    each in registration order, list items as [i]."""
    class Bare(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.head = torch.nn.Linear(2, 3)
            self.scale_raw = torch.nn.Parameter(torch.zeros(()))
            self.blocks = torch.nn.ModuleList([torch.nn.Linear(3, 1)])

    rows = tmon.summary(Bare(), print_fn=None)
    assert [(r["name"], r["transform"], r["shape"]) for r in rows] == [
        ("scale", "softplus", ()), ("head.weight", "identity", (3, 2)),
        ("head.bias", "identity", (3,)),
        ("blocks[0].weight", "identity", (1, 3)),
        ("blocks[0].bias", "identity", (1,))]
    assert rows[0]["value"] == "0.69315"


def test_summarize_tensor_matches_reference(capsys):
    x = np.random.default_rng(1).normal(size=(4, 5))
    x[0, 1], x[2, 3] = np.nan, 1e-9
    got = tmon.summarize_tensor(torch.as_tensor(x), "q_mu")
    printed = capsys.readouterr().out
    assert got == jmon.summarize_tensor(jnp.asarray(x), "q_mu")
    assert capsys.readouterr().out == printed
    assert got["nans"] == 1 and got["near_zero"] == 1
    assert tmon.summarize_tensor(np.zeros((0, 2)))["shape"] == (0, 2)


def test_grad_norms_and_training_metrics_match_reference():
    """Gradients keyed by the reference's keystr paths, with its norms:
    each parameter's .grad set to a seeded draw, the reference's
    gradient tree holding the same arrays."""
    model = nb_regression_model()
    rng = np.random.default_rng(2)
    for p in model.params.parameters():
        p.grad = torch.as_tensor(rng.normal(size=p.shape))
    grads = reference_params(model.params)
    by_name = {name: p.grad for name, p in tmon.named_leaves(model.params)}
    import jax
    leaves, treedef = jax.tree_util.tree_flatten_with_path(grads)
    grads = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(by_name[jax.tree_util.keystr(path)].numpy())
        for path, _ in leaves])
    got, want = tmon.grad_norms(model.params), jmon.grad_norms(grads)
    assert list(got) == list(want) and ".layers[2].q_sqrt" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12)
    assert tmon.grad_norms(by_name).keys() == got.keys()
    loss = torch.tensor(3.5, dtype=F64)
    m, mj = (tmon.training_metrics(loss, model.params),
             jmon.training_metrics(jnp.asarray(3.5), grads))
    assert float(m["elbo"]) == float(mj["elbo"]) == -3.5
    np.testing.assert_allclose(float(m["grad_norm"]), float(mj["grad_norm"]),
                               rtol=1e-12)
    assert tmon.training_metrics(loss) == {"elbo": -loss}


def test_steps_per_sec():
    # the first torch.optim.Adam imports torch._dynamo (~2 s): here, not
    # where the files that take reference_params import this one
    import torch._dynamo  # noqa: F401

    rate, carry = profiling.steps_per_sec(lambda t: t + 1, torch.zeros(3),
                                          steps=5, warmup=2)
    assert rate > 0 and torch.equal(carry, torch.full((3,), 7.0))
    model = nb_regression_model()
    rate, out = profiling.steps_per_sec(
        lambda m: (m.optimize_adam(iterations=1, messages=0,
                                   shrink_inner=False), m)[1],
        model, steps=2, warmup=1)
    assert rate > 0 and out is model


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
