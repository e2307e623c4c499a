"""Port parity: the training loops of dgp_tpu_torch (masks, masked Adam,
adam_run, bucket padding, the ELBO's scaling and gradients, checkpoints)
against dgp_tpu, in float64 on CPU, on the same numpy inputs and the same
fixed unit normals."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dgp_tpu.layers.svgp import layer_kl as jlayer_kl
from dgp_tpu.models import dgp as jdgp
from dgp_tpu.models import training as jtrain
from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.models import training as ttrain
from dgp_tpu_torch.ops import cholesky as tch
from dgp_tpu_torch.ops import conditional_fused as tcf
from dgp_tpu_torch.ops import kernels as TK
from dgp_tpu_torch.ops import quadform as tq
from dgp_tpu_torch.utils import checkpoint

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401


F64 = torch.float64
S = 3


def composite_kernels():
    """Whitened layers the stationary fused kernel does not take: RBF +
    Linear (both ARD) on layer 0, and on layer 1 a Product and active_dims,
    RBF(dim 0) * Linear(dim 1) + RBF(dim 1)."""
    return [JK.RBF.create(variance=1.2, lengthscales=[0.7] * 3)
            + JK.Linear.create(variance=[0.5, 0.8, 0.3]),
            JK.RBF.create(variance=0.9, lengthscales=[0.8], active_dims=[0])
            * JK.Linear.create(variance=0.6, active_dims=[1])
            + JK.RBF.create(variance=0.5, lengthscales=[1.1], active_dims=[1])]


@functools.lru_cache(maxsize=None)
def reference_model(white=True, composite=False):
    """2-layer model, Din 3 -> 2 -> 1: layer 0 carries a frozen PCA mean
    function (a LinearMean weight the masks must keep frozen). With
    ``composite`` (whitened) its kernels are :func:`composite_kernels`."""
    rng = np.random.default_rng(0)
    N, M = 12, 6
    X = rng.uniform(0, 1, size=(N, 3))
    Y = np.sin(3 * X[:, :1]) + 0.1 * rng.normal(size=(N, 1))
    Z = X[rng.choice(N, M, replace=False)].copy()
    kernels = ([JK.RBF.create(variance=1.2, lengthscales=[0.7] * 3),
                JK.Matern52.create(variance=0.9, lengthscales=[0.8, 1.1])]
               if not composite else composite_kernels())
    model = jdgp.DGP(X, Y, Z, kernels, [2], num_samples=S, white=white)
    layers = []
    for layer in model.params.layers:  # off the prior
        D, M, _ = layer.q_sqrt.shape
        layers.append(layer.replace(
            q_mu=jnp.asarray(rng.normal(size=(M, D))),
            q_sqrt=layer.q_sqrt + jnp.asarray(
                np.tril(0.1 * rng.normal(size=(D, M, M))))))
    zs = [rng.normal(size=(S, N, l.num_outputs)) for l in layers]
    return model.params.replace(layers=tuple(layers)), X, Y, zs


def port_of(params):
    return convert.dgp_from_numpy(convert.numpy_tree_from_reference(params),
                                  "cpu", F64)


def path_name(path):
    return ".".join(str(getattr(p, "name", getattr(p, "idx", None)))
                    for p in path)


def flat(tree, prefix=""):
    """{path: array} over a numpy tree of convert's layout."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree} if isinstance(tree, np.ndarray) else {}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}"))
    return out


def assert_same_parameters(port, params, rtol):
    got = flat(convert.numpy_tree_from_port(port))
    want = flat(convert.numpy_tree_from_reference(params))
    assert got.keys() == want.keys() and len(got) >= 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * np.abs(want[k]).max(),
                                   err_msg=k)


def reference_fixed_loss(X, Y, zs):
    """-ELBO of dgp_tpu with propagate's draws replaced by the fixed zs."""
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    zj = [jnp.asarray(z) for z in zs]

    def loss(params, key):
        _, Fm, Fv = jdgp.propagate(params, Xj, key, S, False, zj)
        ve = params.likelihood.variational_expectations(Fm[-1], Fv[-1], Yj)
        kl = sum(jlayer_kl(l, l.z) for l in params.layers)
        return -(jnp.sum(jnp.mean(ve, axis=0)) - kl)

    return loss


def port_fixed_loss(X, Y, zs):
    zt = [torch.as_tensor(z) for z in zs]
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    return lambda params, generator: -tdgp.elbo(params, Xt, Yt, S, zs=zt)


MASKS = {
    "default": {},
    "natgrad": {"frozen_layer_fields": {1: {"q_mu", "q_sqrt"}}},
    "group-key": {"frozen_layer_fields": {("layers", 0): {"kernel"}}},
    "all": {"frozen_layer_fields": {"all": {"z"}}},
    "field": {"frozen_fields": ("likelihood",)},
}


@pytest.mark.parametrize("spec", sorted(MASKS))
def test_make_mask_matches_reference(spec):
    params, *_ = reference_model()
    want = {path_name(path): bool(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtrain.make_mask(params, **MASKS[spec]))[0]}
    got = ttrain.make_mask(port_of(params), **MASKS[spec])
    assert got == want
    assert got["layers.0.mean_function.W"] is False
    assert not all(got.values()) and any(got.values())


def test_number_parameters_matches_reference():
    """nb_DGP_regression: 2032 trainable parameters for the N=50, M=25,
    arch [1,1,1] model (tests/test_dgp.py)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(50, 1))
    Y = (X > 0.5).astype(float)
    Z = np.linspace(X.min(), X.max(), 25)[:, None]
    kernels = [TK.RBF.create(lengthscales=[1.0], dtype=F64) for _ in range(3)]
    model = tdgp.DGP(X, Y, Z, kernels, [1, 1], device="cpu", dtype=F64)
    assert model.number_parameters() == 2032
    assert model.number_parameters(trainable=False) == 2032
    params, *_ = reference_model()
    jm = jdgp.DGP.__new__(jdgp.DGP)
    jm.params = params
    port = tdgp.DGP.__new__(tdgp.DGP)
    port.params = port_of(params)
    for trainable in (True, False):  # the frozen PCA weight counts only here
        assert (port.number_parameters(trainable)
                == jm.number_parameters(trainable))


def test_masked_adam_update_equals_optax():
    """Three steps on fixed gradients: torch's Adam with eps=1e-7 moves the
    trained parameter as optax.adam does, and a frozen one not at all."""
    rng = np.random.default_rng(1)
    w0, f0 = rng.normal(size=(4, 3)), rng.normal(size=(5,))
    grads = [rng.normal(size=(4, 3)) * 10.0 ** rng.integers(-6, 3, size=(4, 3))
             for _ in range(3)]
    module = torch.nn.Module()
    # copies: torch's in-place steps must not reach w0, which JAX's CPU
    # backend may share (zero-copy) with jnp.asarray(w0) below
    module.w = torch.nn.Parameter(torch.tensor(w0))
    module.f = torch.nn.Parameter(torch.tensor(f0))
    opt = ttrain.masked_adam(module, {"w": True, "f": False}, lr=0.02, b1=0.8,
                             b2=0.95, eps=1e-7)
    jopt = optax.adam(0.02, b1=0.8, b2=0.95, eps=1e-7)
    wj = jnp.asarray(w0)
    state = jopt.init(wj)
    for g in grads:
        module.w.grad = torch.as_tensor(g)
        module.f.grad = torch.ones(5, dtype=F64)  # must be ignored
        opt.step()
        updates, state = jopt.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, updates)
    np.testing.assert_allclose(module.w.detach().numpy(), np.asarray(wj),
                               rtol=1e-12)
    np.testing.assert_array_equal(module.f.detach().numpy(), f0)


def test_adam_run_matches_reference():
    """Five Adam steps on a deterministic loss (fixed zs closed over in both
    packages): same losses, same parameters, frozen ones untouched."""
    params, X, Y, zs = reference_model()
    frozen = {"frozen_layer_fields": {1: {"q_mu", "q_sqrt"}}}
    pj, lj = jtrain.adam_run(
        reference_fixed_loss(X, Y, zs), params, jtrain.make_mask(params, **frozen),
        jax.random.PRNGKey(0), steps=5, lr=0.01)
    port = port_of(params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out, lt = ttrain.adam_run(
        port_fixed_loss(X, Y, zs), port, ttrain.make_mask(port, **frozen),
        None, steps=5, lr=0.01)
    assert out is port and lt.shape == (5,) and not lt.requires_grad
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-8)
    assert_same_parameters(port, pj, rtol=1e-8)
    after = port.state_dict()
    for name in ("layers.0.mean_function.W", "layers.1.q_mu", "layers.1.q_sqrt"):
        assert torch.equal(after[name], before[name]), name
    for name in ("layers.0.q_mu", "layers.1.z", "likelihood.variance_raw",
                 "layers.0.kernel.lengthscales_raw"):
        assert not torch.equal(after[name], before[name]), name
    assert all(p.grad is None for p in port.parameters())


def test_adam_run_chunked_matches_unchunked():
    params, X, Y, zs = reference_model()
    loss = port_fixed_loss(X, Y, zs)
    runs = []
    for every in (0, 2):
        port = port_of(params)
        seen = []
        _, losses = ttrain.adam_run(
            loss, port, ttrain.make_mask(port), None, steps=5, lr=0.01,
            checkpoint_every=every,
            checkpoint_fn=lambda p, done: seen.append(done))
        runs.append((losses, port.state_dict(), seen))
    (l0, s0, seen0), (l2, s2, seen2) = runs
    assert seen0 == [] and seen2 == [2, 4]
    assert torch.equal(l0, l2)
    assert all(torch.equal(s0[k], s2[k]) for k in s0)


def test_adam_run_metrics_messages_and_nonfinite_warning(capsys):
    params, X, Y, zs = reference_model()
    port = port_of(params)
    _, trace = ttrain.adam_run(
        port_fixed_loss(X, Y, zs), port, ttrain.make_mask(port), None, steps=3,
        messages=2, label="bound",
        metrics_fn=lambda p: {"noise": p.likelihood.variance})
    assert sorted(trace) == ["grad_norm", "loss", "noise"]
    assert all(v.shape == (3,) for v in trace.values())
    assert float(trace["grad_norm"].min()) > 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 2 and printed[0] == f"bound: {-float(trace['loss'][0])}"

    empty_port, empty = ttrain.adam_run(None, port, {}, None, steps=0)
    assert empty.shape == (0,) and empty_port is port

    def diverges(p, generator, data):
        return p.likelihood.variance_raw * data
    with pytest.warns(RuntimeWarning, match="non-finite loss at step 0"):
        ttrain.adam_run(diverges, port, ttrain.make_mask(port), None, steps=2,
                        data=torch.tensor(float("nan"), dtype=F64))


def test_pad_to_bucket_matches_reference_and_keeps_the_elbo():
    params, X, Y, zs = reference_model()
    port = port_of(params)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    assert ttrain.bucket_rows(12, 8) == jtrain.bucket_rows(12, 8) == 16
    for bucket in (8, 12):  # 12 rows: padded to 16, and already a multiple
        want = jtrain.pad_to_bucket(jnp.asarray(X), jnp.asarray(Y), bucket)
        got = ttrain.pad_to_bucket(Xt, Yt, bucket)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    Xp, Yp, w = ttrain.pad_to_bucket(Xt, Yt, 8)
    zt = [torch.as_tensor(z) for z in zs]
    zp = [torch.cat([z, z[:, :4]], dim=1) for z in zt]  # any normals for the pad rows
    with torch.no_grad():
        plain = tdgp.elbo(port, Xt, Yt, S, zs=zt)
        padded = tdgp.elbo(port, Xp, Yp, S, zs=zp, row_weights=w)
        scaled = tdgp.elbo(port, Xp, Yp, S, zs=zp, row_weights=w, num_data=24)
        half = tdgp.elbo(port, Xt, Yt, S, zs=zt, num_data=24)
    np.testing.assert_allclose(float(padded), float(plain), rtol=1e-12)
    np.testing.assert_allclose(float(scaled), float(half), rtol=1e-12)


def test_elbo_minibatch_scaling():
    """num_data doubles the data term and leaves the KL alone
    (tests/test_dgp.py::test_elbo_minibatch_scaling)."""
    params, X, Y, zs = reference_model()
    port = port_of(params)
    zt = [torch.as_tensor(z[:, :6]) for z in zs]
    Xb, Yb = torch.as_tensor(X[:6]), torch.as_tensor(Y[:6])
    with torch.no_grad():
        full = tdgp.elbo(port, Xb, Yb, S, zs=zt)
        scaled = tdgp.elbo(port, Xb, Yb, S, zs=zt, num_data=12)
        kl = sum(float(tdgp.layer_kl(l, l.z)) for l in port.layers)
    np.testing.assert_allclose(float(scaled), 2 * float(full) + kl, rtol=1e-8)


def test_loss_spec_minibatch_and_bucket():
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(10, 2))
    Y = np.sin(X[:, :1])
    kernels = [TK.RBF.create(lengthscales=[1.0, 1.0], dtype=F64),
               TK.RBF.create(lengthscales=[1.0, 1.0], dtype=F64)]
    make = functools.partial(tdgp.DGP, X, Y, X[:4], kernels, [2], white=True,
                             num_samples=2, device="cpu", dtype=F64)
    _, (Xb, Yb, w, n) = make(n_bucket=8)._loss_spec()
    assert Xb.shape == (16, 2) and float(w.sum()) == 10 and n is None
    model = make(minibatch_size=4, n_bucket=8)
    loss_fn, (Xb, Yb, n_true) = model._loss_spec()
    assert Xb.shape == (16, 2) and n_true == 10
    seen = []
    elbo = tdgp.elbo
    try:
        tdgp.elbo = lambda p, Xm, Ym, *a, **k: seen.append((Xm, k)) or elbo(
            p, Xm, Ym, *a, **k)
        loss_fn(model.params, model.generator, (Xb, Yb, n_true))
    finally:
        tdgp.elbo = elbo
    Xm, kw = seen[0]
    assert Xm.shape == (4, 2) and kw["num_data"] == 10
    assert all(any(torch.equal(r, x) for x in Xb[:10]) for r in Xm)  # no pad row
    losses = model.optimize_adam(iterations=3, messages=0)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())


@functools.lru_cache(maxsize=None)
def reference_gradients(white, composite=False):
    """(loss, {path: gradient}) of dgp_tpu's -ELBO on the fixed normals."""
    params, X, Y, zs = reference_model(white, composite)
    lj, gj = jax.jit(jax.value_and_grad(reference_fixed_loss(X, Y, zs)))(
        params, jax.random.PRNGKey(0))
    return float(lj), {path_name(path): np.asarray(leaf) for path, leaf in
                       jax.tree_util.tree_flatten_with_path(gj)[0]}


def check_elbo_gradients(white, composite=False):
    params, X, Y, zs = reference_model(white, composite)
    port = port_of(params)
    loss = port_fixed_loss(X, Y, zs)(port, None)
    grads = torch.autograd.grad(loss, list(port.parameters()))
    got = dict(zip((n for n, _ in port.named_parameters()), grads))
    want_loss, want = reference_gradients(white, composite)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-8)
    assert set(got) == set(want) - {"layers.0.mean_function.W"}
    for name, g in got.items():
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=1e-8,
            atol=1e-10 * np.abs(want[name]).max(), err_msg=name)


@pytest.mark.parametrize("white", [True, False])
def test_elbo_gradients_match_jax_grad(white):
    check_elbo_gradients(white)


def test_nonwhite_elbo_gradients_through_quadform(monkeypatch):
    """The non-whitened ELBO with the quadform's gate forced open: the CPU
    tensors go through QuadForm and its hand-written plain backward (one
    forward and one backward per layer), and the gradients still match
    jax.grad of dgp_tpu's ELBO."""
    calls = {"forward": 0, "backward": 0}
    forward, backward = tq.QuadForm.forward, tq.quadform_backward_plain

    def counted_forward(ctx, *args):
        calls["forward"] += 1
        return forward(ctx, *args)

    def counted_backward(*args):
        calls["backward"] += 1
        return backward(*args)

    monkeypatch.setattr(tq, "applicable", lambda Sq, A: True)
    monkeypatch.setattr(tq.QuadForm, "forward", staticmethod(counted_forward))
    monkeypatch.setattr(tq, "quadform_backward_plain", counted_backward)
    check_elbo_gradients(white=False)
    assert calls == {"forward": 2, "backward": 2}


@pytest.mark.parametrize("white", [True, False])
def test_elbo_gradients_through_the_cholesky_kernels(monkeypatch, white):
    """The ELBO with the Cholesky kernels' gate forced open: the CPU
    tensors go through CholeskyInverse once (the Kuu stack of both layers,
    one (M, white) group, whose factor the non-whitened KL takes too), with
    the hand-written adjoint; the gradients reach Z and the kernels'
    hyperparameters and still match jax.grad of dgp_tpu's ELBO."""
    calls = {"chol": 0, "chol_inv": 0}

    def counted(name, function):
        forward = function.forward

        def counted_forward(ctx, *args):
            calls[name] += 1
            return forward(ctx, *args)

        monkeypatch.setattr(function, "forward", staticmethod(counted_forward))

    counted("chol", tch.Cholesky)
    counted("chol_inv", tch.CholeskyInverse)
    monkeypatch.setattr(tch, "applicable", lambda *args, **kwargs: True)
    check_elbo_gradients(white)
    assert calls == {"chol": 0, "chol_inv": 1}


def test_composite_elbo_gradients_through_fused_conditional(monkeypatch):
    """A whitened model of composite kernels (Sum, Product, Linear,
    active_dims) with the fused conditional's gate forced open: the CPU
    tensors go through FusedConditionalWhite and its hand-written plain
    backward (one forward and one backward per layer), so dKuf and dKff
    reach the kernels' hyperparameters, Z and layer 1's inputs through
    autograd of K and K_diag; the ELBO and its gradients match jax.grad of
    dgp_tpu's ELBO."""
    calls = {"forward": 0, "backward": 0}
    forward = tcf.FusedConditionalWhite.forward
    backward = tcf.fused_conditional_white_backward_plain

    def counted_forward(ctx, *args):
        calls["forward"] += 1
        return forward(ctx, *args)

    def counted_backward(*args):
        calls["backward"] += 1
        return backward(*args)

    monkeypatch.setattr(tcf, "applicable", lambda *args: True)
    monkeypatch.setattr(tcf.FusedConditionalWhite, "forward",
                        staticmethod(counted_forward))
    monkeypatch.setattr(tcf, "fused_conditional_white_backward_plain",
                        counted_backward)
    check_elbo_gradients(white=True, composite=True)
    assert calls == {"forward": 2, "backward": 2}


def test_checkpoint_round_trip(tmp_path):
    params, *_ = reference_model()
    port = port_of(params)
    path = str(tmp_path / "model.npz")
    ttrain.make_checkpoint_fn(path)(port, 7)
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        for p in port.parameters():
            p.add_(1.0)
    assert checkpoint.load(path, port) is port
    for k, v in port.state_dict().items():
        assert torch.equal(v, saved[k]), k
    other, *_ = reference_model(white=False)
    smaller = port_of(other.replace(layers=other.layers[1:]))
    with pytest.raises(ValueError, match="checkpoint holds"):
        checkpoint.load(path, smaller)
