"""Port parity: the multi-fidelity deep GP of dgp_tpu_torch against dgp_tpu,
in float64 on CPU, on the reference's own unit normals.

Each JAX function runs jitted with ``jax.random.normal`` wrapped (pytest's
monkeypatch) so that it also returns every draw it makes, in order; the
port's function takes those draws as its ``noise``. Both then compute the
same number to f64 rounding, values and gradients alike. The JAX outputs
come from few compiled programs per model (XLA's compile of the
reference's ELBO gradient sets this file's time); their sub-calls share
one key, so ``predict_f`` and ``predict_y`` repeat ``propagate``'s graph,
which XLA folds.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.bo.doe import lhs
from dgp_tpu.models import mf_dgp as jmf
from dgp_tpu.models import training as jtrain
from dgp_tpu.ops import likelihoods as jlik
from dgp_tpu.utils.test_functions import park_high, park_low
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import mf_dgp as tmf
from dgp_tpu_torch.models import training as ttrain
from dgp_tpu_torch.ops import likelihoods as tlik

import chip_smoke

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_dgp import assert_same_tree
from test_torch_training import path_name

F64 = torch.float64
RTOL, GRAD_RTOL = 1e-10, 1e-8
S = 3
# these tiny programs run in microseconds: spend no compile time on them
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def recorded(fn):
    """``fn`` returning (value, [every jax.random.normal draw, in order])."""

    def run(*args, **kwargs):
        draws = []
        normal = jax.random.normal

        def recording(key, shape=(), dtype=float):
            z = normal(key, shape, dtype)
            draws.append(z)
            return z

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", recording)
            out = fn(*args, **kwargs)
        return out, draws

    return run


def data(n_fidelities):
    """Park on [0,1]^4 with N = [10, 4] (nb_mfdgp_improved's pair, cut), or
    a 3-fidelity chain in 2 dimensions (tests/test_mf_dgp.py's, cut)."""
    if n_fidelities == 2:
        X = [lhs(4, 10, seed=123), lhs(4, 4, seed=124)]
        return X, [park_low(X[0]), park_high(X[1])]
    rng = np.random.default_rng(7)
    X = [rng.uniform(0, 1, (8, 2)), rng.uniform(0, 1, (5, 2)),
         rng.uniform(0, 1, (3, 2))]
    f = lambda x: np.sin(3 * x[:, :1]) + x[:, 1:]
    return X, [f(X[0]) + 0.3, f(X[1]) + 0.1 * X[1][:, :1], f(X[2])]


def init_program(n_fidelities):
    """The reference's init on a key: its init_layers_mf (recorded) and the
    init's z_full (compute_full_zs on the same key with init's 100 samples
    repeats its key splits)."""
    X, _ = data(n_fidelities)
    kernels = jmf.make_mf_kernels(X[0].shape[1], n_fidelities)

    def init(key):
        (layers, draws) = recorded(jmf.init_layers_mf)(X, kernels, key=key)
        return layers, draws, jmf.compute_full_zs(layers, key, 100)

    return init


def elbo_program(n_fidelities):
    """The reference's ELBO and its gradient, with the draws, as one
    program of (params, key, row_weights, num_data): the plain full batch
    is unit weights and the true sizes, a scale of exactly 1
    (tests/test_mf_dgp.py::test_mf_weighted_scale_identity), so both cases
    share the program."""
    X, Y = data(n_fidelities)
    Xs, Ys = tuple(map(jnp.asarray, X)), tuple(map(jnp.asarray, Y))

    def run(p, key, w, n):
        return (*jax.value_and_grad(recorded(
            lambda q: jmf.elbo(q, Xs, Ys, key, S, row_weights=w,
                               num_data=n)), has_aux=True)(p),
            recorded(jmf.compute_full_zs)(p.layers, key))

    return run


def outputs_program():
    """The Park pair's other outputs the tests compare, {name: (value,
    draws)}: the ELBO of fidelity 0 alone, propagate (diagonal and full
    covariance), predict_f (fidelity 0 and the last) and predict_y at the
    last fidelity's inputs."""
    X, Y = data(2)
    Xs, Ys = tuple(map(jnp.asarray, X)), tuple(map(jnp.asarray, Y))
    Xn = Xs[-1]

    def run(p, key):
        out = {}
        out["elbo_upto0"] = recorded(jmf.elbo)(p, Xs, Ys, key, S,
                                               train_upto_fidelity=0)
        out["propagate"] = recorded(jmf.propagate)(p, Xn, key, S)
        out["propagate_full_cov"] = recorded(jmf.propagate)(
            p, Xn, key, S, full_cov=True)
        out["predict_f"] = recorded(jmf.predict_f)(p, Xn, key, S)
        out["predict_f0"] = recorded(jmf.predict_f)(p, Xn, key, S, 0)
        out["predict_y"] = recorded(jmf.predict_y)(p, Xn, key, S)
        return out

    return run


def unit_weights(X):
    return (tuple(jnp.ones(x.shape[0]) for x in X),
            tuple(jnp.asarray(float(len(x))) for x in X))


@functools.lru_cache(maxsize=None)
def programs():
    """The reference programs, compiled: each is traced and lowered in turn
    (the recording patches are process-wide), the costliest (the
    3-fidelity ELBO gradient) first, and handed to one of two threads to
    compile, at XLA's lowest backend optimization level, while the next is
    traced. The ELBO and output programs are lowered at the init's output
    shapes, which _init_variational keeps."""
    key = jax.random.PRNGKey(0)
    compiled = {}
    with ThreadPoolExecutor(2) as pool:
        def compile_(name, fn, *args):
            lowered = jax.jit(fn).lower(*args)
            compiled[name] = pool.submit(lowered.compile, FAST_COMPILE)
            return lowered

        for n in (3, 2):
            layers = compile_(f"init{n}", init_program(n), key).out_info[0]
            params = jmf.MFDGPParams(layers=tuple(layers),
                                     likelihood=jlik.Gaussian.create(1.0))
            compile_(f"elbo{n}", elbo_program(n), params, key,
                     *unit_weights(data(n)[0]))
        compile_("outputs", outputs_program(), params, key)
        return {name: c.result() for name, c in compiled.items()}


@functools.lru_cache(maxsize=None)
def reference(n_fidelities):
    """dgp_tpu's model, built by its init_layers_mf on PRNGKey(0) (recorded),
    as a MultiFidelityDeepGP before and after _init_variational (q_mu <-
    Y_f, q_sqrt scaled: off the prior, where the ELBO would not depend on
    Z_left); and the init's z_full. The wrapper is assembled around the
    compiled init: its constructor would run the init op by op, which XLA
    compiles one op at a time, slower than the whole program."""
    X, Y = data(n_fidelities)
    layers, draws, z_full = programs()[f"init{n_fidelities}"](
        jax.random.PRNGKey(0))
    jm = jmf.MultiFidelityDeepGP.__new__(jmf.MultiFidelityDeepGP)
    jm._key = jax.random.PRNGKey(2)
    jm._X = [jnp.asarray(x) for x in X]
    jm._Y = [jnp.asarray(y) for y in Y]
    jm.params = jmf.MFDGPParams(layers=tuple(layers),
                                likelihood=jlik.Gaussian.create(1.0))
    at_init = jm.params
    jm._init_variational()
    return dict(X=X, Y=Y, jm=jm, at_init=at_init, init_draws=draws,
                z_full=z_full)


def weights(X):
    """Row weights with the last two rows of fidelity 0 as padding, and
    full-dataset sizes that rescale every data term."""
    ws = [np.ones(x.shape[0]) for x in X]
    ws[0][-2:] = 0.0
    return ws, [float(x.shape[0] + 3) for x in X]


@functools.lru_cache(maxsize=None)
def elbo_reference(n_fidelities, weighted):
    """((value, draws), gradients, (compute_full_zs, its draws)) of the
    reference's ELBO on PRNGKey(1)."""
    X = reference(n_fidelities)["X"]
    if weighted:
        ws, nd = weights(X)
        ws = tuple(map(jnp.asarray, ws))
        nd = tuple(jnp.asarray(v) for v in nd)
    else:
        ws, nd = unit_weights(X)
    return programs()[f"elbo{n_fidelities}"](
        reference(n_fidelities)["jm"].params, jax.random.PRNGKey(1), ws, nd)


@functools.lru_cache(maxsize=None)
def outputs():
    """The Park pair's other reference outputs (outputs_program) on
    PRNGKey(1)."""
    return programs()["outputs"](reference(2)["jm"].params,
                                 jax.random.PRNGKey(1))


def port_of(params):
    return convert.mf_dgp_from_numpy(convert.numpy_tree_from_reference(params),
                                     "cpu", F64)


def npy(x):
    return x.detach().numpy()


def close(got, want, rtol=RTOL, what=""):
    """got within rtol of want's largest magnitude, elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(npy(got) if torch.is_tensor(got) else got, want,
                               rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def as_tensors(arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def normals(draws):
    """The reference's draws as the port's noise (writable copies)."""
    return [np.array(d) for d in draws]


@pytest.mark.parametrize("name", ["gaussian_logdensity",
                                  "fidelity_variational_expectations"])
def test_likelihood_functions_match_reference(name):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(3, 5, 1)), rng.normal(size=(3, 5, 1)),
            rng.uniform(0.1, 2.0, size=(3, 5, 1))]
    if name == "fidelity_variational_expectations":
        args.append(np.asarray(0.37))
    want = getattr(jlik, name)(*map(jnp.asarray, args))
    got = getattr(tlik, name)(*as_tensors(args))
    close(got, want)


@pytest.mark.parametrize("add_linear", [True, False])
@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_make_mf_kernels_matches_reference(n_fidelities, add_linear):
    """The same composite stack, raw values and active dims included."""
    want = jmf.make_mf_kernels(4, n_fidelities, add_linear=add_linear)
    got = tmf.make_mf_kernels(4, n_fidelities, add_linear=add_linear,
                              dtype=F64)
    assert len(got) == n_fidelities
    for g, w in zip(got, want):
        assert_same_tree(convert._kernel_tree(g), convert._kernel_tree(w))


@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_init_layers_mf_matches_reference(n_fidelities):
    """z_full (the augmented initial inducing inputs) and the initial
    q_sqrt = chol(Kuu(z_full)) of every layer, on the reference's init
    draws; z and z_left are the given Z."""
    ref = reference(n_fidelities)
    X = ref["X"]
    kernels = tmf.make_mf_kernels(X[0].shape[1], n_fidelities, dtype=F64)
    draws = ref["init_draws"]
    assert len(draws) == n_fidelities * (n_fidelities - 1) // 2
    layers = tmf.init_layers_mf(X, kernels, noise=normals(draws), dtype=F64,
                                device="cpu")
    with torch.no_grad():
        z_full = tmf.compute_full_zs(layers, num_samples=100,
                                     noise=normals(draws))
    for i, (lt, lj) in enumerate(zip(layers, ref["at_init"].layers)):
        assert lt.augmented == lj.augmented == (i > 0)
        z = lt.z_left if i else lt.z
        np.testing.assert_array_equal(npy(z), X[i])
        assert (lt.z is None) == (lj.z is None) == (i > 0)
        close(z_full[i], ref["z_full"][i], what=f"z_full {i}")
        close(lt.q_sqrt, lj.q_sqrt, what=f"q_sqrt {i}")
        close(lt.q_mu, lj.q_mu)


@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_compute_full_zs_matches_reference(n_fidelities):
    _, _, (zs, draws) = elbo_reference(n_fidelities, False)
    port = port_of(reference(n_fidelities)["jm"].params)
    with torch.no_grad():
        got = tmf.compute_full_zs(port.layers, noise=normals(draws))
    assert [tuple(z.shape) for z in got] == [z.shape for z in zs]
    for g, w in zip(got, zs):
        close(g, w)


@pytest.mark.parametrize("full_cov", [False, True])
def test_propagate_matches_reference(full_cov):
    """Every layer's samples, means and variances (full covariances too)."""
    ref = reference(2)
    want, draws = outputs()["propagate_full_cov" if full_cov else "propagate"]
    with torch.no_grad():
        got = tmf.propagate(port_of(ref["jm"].params), ref["X"][-1], S,
                            full_cov=full_cov, noise=normals(draws))
    for g_layers, w_layers in zip(got, want):
        for g, w in zip(g_layers, w_layers):
            assert tuple(g.shape) == w.shape
            close(g, w)


@pytest.mark.parametrize("what", ["predict_f", "predict_f0", "predict_y",
                                  "predict_density"])
def test_predictions_match_reference(what, monkeypatch):
    """predict_f at fidelity 0 and at the last, predict_y, and
    predict_density (the reference wrapper's logsumexp over samples, run
    on the predict_f it draws)."""
    ref = reference(2)
    params = port_of(ref["jm"].params)
    X = ref["X"][-1]
    with torch.no_grad():
        if what == "predict_density":
            (Fm, Fv), draws = outputs()["predict_f"]
            Y = park_high(X) + 0.1
            monkeypatch.setattr(jmf, "_predict_f_jit", lambda *a: (Fm, Fv))
            want = ref["jm"].predict_density(X, Y, S)
            got = tmf.predict_density(params, X, Y, S, noise=normals(draws))
        else:
            want, draws = outputs()[what]
            fn = tmf.predict_y if what == "predict_y" else tmf.predict_f
            kw = {"fidelity": 0} if what == "predict_f0" else {}
            got = fn(params, X, S, noise=normals(draws), **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert tuple(g.shape) == w.shape
        close(g, w)


def port_gradients(params, loss):
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return dict(zip(names, grads))


@pytest.mark.parametrize("case", ["2-plain", "2-weighted", "2-upto0",
                                  "3-plain"])
def test_elbo_matches_reference(case):
    """The ELBO (all fidelities, fidelity 0 alone, and with row weights and
    full-dataset sizes), and its gradient for every parameter, z_left's
    (nonzero: through the concat and the recomputed Z_right) included."""
    n_fidelities, variant = int(case[0]), case[2:]
    ref = reference(n_fidelities)
    out = (outputs()["elbo_upto0"] if variant == "upto0"
           else elbo_reference(n_fidelities, variant == "weighted")[:2])
    params = port_of(ref["jm"].params)
    kwargs = {}
    if variant == "weighted":
        ws, nd = weights(ref["X"])
        kwargs = dict(row_weights=as_tensors(ws), num_data=nd)
    elif variant == "upto0":
        kwargs = dict(train_upto_fidelity=0)
    (value, draws), grads = out if variant != "upto0" else (out, None)
    loss = tmf.elbo(params, ref["X"], ref["Y"], S, noise=normals(draws),
                    **kwargs)
    close(loss, value)
    if grads is None:
        return
    want = {path_name(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(grads)[0]}
    got = port_gradients(params, loss)
    assert got.keys() == want.keys()
    for name in want:
        close(got[name], want[name], GRAD_RTOL, name)
    for i in range(1, n_fidelities):
        g = want[f"layers.{i}.z_left"]
        assert np.all(np.isfinite(g)) and np.any(g != 0)


def port_model(n_fidelities, params=None):
    X, Y = data(n_fidelities)
    model = tmf.MultiFidelityDeepGP(X, Y, num_samples=S, device="cpu",
                                    dtype=F64)
    if params is not None:
        model.params = port_of(params)
    return model


@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_init_variational_matches_reference(n_fidelities):
    """q_mu <- Y_f, q_sqrt scaled by the population variance of Y_f (ddof
    0), and the likelihood variance from the last fidelity's."""
    ref = reference(n_fidelities)
    model = port_model(n_fidelities, ref["at_init"])
    model._init_variational()
    got = convert.numpy_tree_from_port(model.params)
    want = convert.numpy_tree_from_reference(ref["jm"].params)
    for layer_got, layer_want in zip(got["layers"], want["layers"]):
        for name in ("q_mu", "q_sqrt"):
            close(layer_got[name], layer_want[name], what=name)
    close(got["likelihood"]["variance_raw"],
          want["likelihood"]["variance_raw"])


@pytest.mark.parametrize("phase", ["1", "2", "3-natgrad", "3-adam"])
def test_phase_masks_match_reference(phase):
    """The frozen tensors of each phase, field by field."""
    ref = reference(2)
    model = port_model(2, ref["jm"].params)
    if phase == "3-adam":
        want_mask, got = (jtrain.make_mask(ref["jm"].params),
                          ttrain.make_mask(model.params))
    else:
        k = int(phase[0]) - 1
        want_mask, got = ref["jm"]._phase_masks()[k], model._phase_masks()[k]
    want = {path_name(p): bool(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(want_mask)[0]}
    assert got == want
    frozen = {n for n, trained in got.items() if not trained}
    assert {"layers.1.q_mu", "layers.1.q_sqrt"} <= frozen or phase == "3-adam"
    assert ("layers.1.z_left" in frozen) == (phase == "1")


@pytest.mark.parametrize("method", ["optimize_nat_adam", "optimize_adam"])
def test_staged_training_keeps_frozen_tensors(method):
    """Three steps of each phase on the CPU, held as chip_smoke holds the
    card's run (check_mf_training): finite losses, the last below the
    first (phase 2's moving inducing inputs raise the loss for a few
    steps); each phase's frozen tensors unchanged bit for bit (q aside
    in the natural-gradient phase, which that step moves); z_left moved
    from phase 2, the likelihood and q in phase 3."""
    model = port_model(2)
    kwargs = dict(iterations1=3, iterations2=3, iterations3=3, messages=0)
    if method == "optimize_nat_adam":
        kwargs["lr_adam"] = 0.005
    with chip_smoke.phase_snapshots() as seen:
        losses = getattr(model, method)(**kwargs)
    assert losses.shape == (9,)
    chip_smoke.check_mf_training(method, seen, losses,
                                 nat=method == "optimize_nat_adam", window=1)


def test_minibatch_loss_is_unbiased(monkeypatch):
    """The N_f / B_f scale makes the minibatch data term an unbiased
    estimator of the full batch's (the KL is shared): with one row per
    fidelity, the mean of the minibatch loss over every pair of rows is the
    full-batch loss, to the Monte-Carlo error of the unit normals (the
    index draws are enumerated; the normals still come from the
    generator)."""
    X, Y = data(2)
    full = port_model(2)
    mini = tmf.MultiFidelityDeepGP(X, Y, num_samples=S, device="cpu",
                                   dtype=F64, minibatch_size=1)
    mini.params = full.params
    pairs = [(i, j) for i in range(len(X[0])) for j in range(len(X[1]))]
    rows = iter(torch.tensor([r]) for pair in pairs for r in pair)
    randint = torch.randint
    drawn = []

    def enumerated(low, high, size, **kwargs):
        drawn.append(randint(low, high, size, **kwargs))
        return next(rows)

    monkeypatch.setattr(torch, "randint", enumerated)
    with torch.no_grad():
        loss, batch = mini._loss_spec()
        assert batch[2] == (10, 4)
        mean = np.mean([float(loss(full.params, mini.generator, batch))
                        for _ in pairs])
        loss, batch = full._loss_spec()
        want = float(loss(full.params, full.generator, batch))
    assert all(0 <= int(d) < n for d, n in zip(drawn, [10, 4] * len(pairs)))
    np.testing.assert_allclose(mean, want, rtol=1e-6)


def test_padded_rows_contribute_nothing():
    """With n_bucket, each fidelity's rows are padded with weight 0: the
    padded Y values do not reach the loss."""
    X, Y = data(2)
    model = tmf.MultiFidelityDeepGP(X, Y, num_samples=S, n_bucket=8,
                                    device="cpu", dtype=F64)
    loss, (Xs, Ys, ws, nd) = model._loss_spec()
    assert [x.shape[0] for x in Xs] == [16, 8] and nd == (10, 4)
    other = (Ys[0].clone().index_fill_(0, torch.arange(10, 16), 321.0),
             Ys[1].clone().index_fill_(0, torch.arange(4, 8), -77.0))
    state = model.generator.get_state()
    with torch.no_grad():
        a = loss(model.params, model.generator, (Xs, Ys, ws, nd))
        model.generator.set_state(state)
        b = loss(model.params, model.generator, (Xs, other, ws, nd))
    assert torch.isfinite(a) and float(a) == float(b)


@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_convert_round_trips_the_mf_tree(n_fidelities):
    """The reference's tree crosses convert into the port and comes back
    unchanged; layer 0 holds z, the augmented layers z_left alone."""
    tree = convert.numpy_tree_from_reference(reference(n_fidelities)["jm"].params)
    port = convert.mf_dgp_from_numpy(tree, "cpu", F64)
    assert isinstance(port, tmf.MFDGPParams)
    assert_same_tree(convert.numpy_tree_from_port(port), tree)
    assert [("z" in t, "z_left" in t) for t in tree["layers"]] == [
        (True, False)] + [(False, True)] * (n_fidelities - 1)
    names = [n for n, _ in port.named_parameters()]
    assert "layers.0.z" in names and "layers.0.z_left" not in names
    assert "layers.1.z_left" in names and "layers.1.z" not in names


def test_sharded_paths_raise():
    """As in dgp_tpu: predict_y_sharded with no mesh (given or built in)
    raises ValueError; a mesh that is not a DeviceMesh is refused. (The
    sharded paths themselves: tests/test_torch_parallel.py and
    tests/test_torch_sharded_serving.py.)"""
    X, Y = data(2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmf.MultiFidelityDeepGP(X, Y, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        port_model(2).predict_y_sharded(X[1], 3)
