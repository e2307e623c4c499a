"""Port parity: the multi-fidelity deep GP with Embedded Mapping of
dgp_tpu_torch against dgp_tpu, in float64 on CPU, on the reference's own
unit normals.

Each JAX function runs jitted with ``jax.random.normal`` wrapped (pytest's
monkeypatch) so that it also returns every draw it makes, in order; the
port's function takes those draws as its ``noise``. Both then compute the
same number to f64 rounding, values and gradients alike.

One call of the reference draws normals that no output depends on:
``propagate(project=True)`` (which ``project`` and every projection term of
the ELBO call) splits a key, computes ``compute_full_zs_em`` from it and
returns before it uses the result (dgp_tpu/models/mf_dgp_em.py:108-124).
The port computes no such Z_right. While recording, that one call of
``compute_full_zs_em`` (the one under ``propagate(project=True)``) is
replaced by a stub: the key split stays in ``propagate``, so every draw
that follows is the reference's own, and the dropped draws are neither
recorded nor traced. ``test_project_skips_only_the_dropped_z_right`` holds
the stubbed recording to the reference as it is: the same outputs, and its
draws the dropped Z_right's followed by the stubbed recording's.

The JAX outputs come from four compiled programs (XLA's compile of the
reference's ELBO gradients sets this file's time): the Park_VD pair's
init, its ELBO with its gradient, its other outputs, and the 3-fidelity
chain's ELBO with its gradient; the 3-fidelity reference holds the port's
own initial parameters (:func:`reference_of`), so it needs no init of its
own.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.bo.doe import lhs
from dgp_tpu.layers import svgp as jsvgp
from dgp_tpu.models import mf_dgp_em as jem
from dgp_tpu.models import training as jtrain
from dgp_tpu.ops import likelihoods as jlik
from dgp_tpu.ops import means as jmeans
from dgp_tpu.utils.test_functions import park_vd_high, park_vd_low
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import mf_dgp_em as tem
from dgp_tpu_torch.models import training as ttrain

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
# the 4-D rows project() is held at: off the reduction layer's inducing
# inputs W = X[1], where its posterior variance is the jitter alone and
# cancels to f64 rounding of the prior's
PROJECTED = lhs(4, 5, seed=7)


def recorded(fn, skip_dropped=True, full_zs=None):
    """``fn`` returning (value, [every jax.random.normal draw, in order]);
    with ``skip_dropped``, the Z_right that ``propagate(project=True)``
    computes and drops is stubbed (module docstring), and every
    ``compute_full_zs_em`` result that is kept is appended to the list
    ``full_zs`` where one is given."""

    def run(*args, **kwargs):
        draws, projecting = [], []
        normal = jax.random.normal
        propagate, compute_full_zs = jem.propagate, jem.compute_full_zs_em

        def recording(key, shape=(), dtype=float):
            z = normal(key, shape, dtype)
            draws.append(z)
            return z

        def propagating(*a, project=False, **kw):
            projecting.append(project)
            try:
                return propagate(*a, project=project, **kw)
            finally:
                projecting.pop()

        def computing(*a, **kw):
            if projecting and projecting[-1]:
                return None
            zs = compute_full_zs(*a, **kw)
            if full_zs is not None:
                full_zs.append(zs)
            return zs

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", recording)
            if skip_dropped:
                mp.setattr(jem, "propagate", propagating)
                mp.setattr(jem, "compute_full_zs_em", computing)
            out = fn(*args, **kwargs)
        return out, draws

    return run


def data(n_fidelities):
    """Park_VD (low fidelity 2-D, high fidelity 4-D, X_red the first two
    columns of the high fidelity's inputs; nb_mfdgpem's pair, cut to
    N = [8, 4]), or a 3-fidelity chain in 2, 3 and 5 dimensions
    (tests/test_mf_dgp_em.py's, cut)."""
    if n_fidelities == 2:
        X = [lhs(2, 8, seed=123), lhs(4, 4, seed=0)]
        return X, [park_vd_low(X[0]), park_vd_high(X[1])], [X[1][:, :2]]
    X = [lhs(2, 6, seed=0), lhs(3, 4, seed=1), lhs(5, 3, seed=2)]
    f = lambda x: np.sin(3 * x[:, :1]) + x[:, 1:2]
    return (X, [f(X[0]), f(X[1]) + 0.1, f(X[2]) - 0.1],
            [X[1][:, :2], X[2][:, :2]])


def reference_wrapper(n_fidelities, params):
    """dgp_tpu's MultiFidelityDeepGP_EM around ``params`` (its constructor
    would run the init op by op, which XLA compiles one op at a time)."""
    X, Y, Xr = data(n_fidelities)
    jm = jem.MultiFidelityDeepGP_EM.__new__(jem.MultiFidelityDeepGP_EM)
    jm._key = jax.random.PRNGKey(2)
    jm._X, jm._Y, jm._X_red = ([jnp.asarray(a) for a in arrays]
                               for arrays in (X, Y, Xr))
    jm.num_samples, jm.minibatch_size, jm.n_bucket, jm.mesh = S, None, None, None
    jm.params = params
    return jm


def init_program():
    """The Park_VD pair's dgp_tpu model, built by its make_mf_em_kernels
    and init_layers_mf_em on a key (recorded; Z = X, W = [X[1]]), and the
    init's z_full (compute_full_zs_em on the same key with init's 100
    samples repeats its key splits)."""
    X = data(2)[0]

    def init(key):
        kernels, kernels_red = jem.make_mf_em_kernels(X)
        (layers, layers_red), draws = recorded(jem.init_layers_mf_em)(
            X, X, [X[1]], kernels, kernels_red, key=key)
        params = jem.MFDGPEMParams(
            layers=tuple(layers), layers_red=tuple(layers_red),
            likelihood=jlik.Gaussian.create(1.0),
            likelihood_projection=jlik.Gaussian.create(1.0))
        return params, draws, jem.compute_full_zs_em(params, key, 100)

    return init


def elbo_program(n_fidelities):
    """The reference's ELBO and its gradient, with the draws and the
    effective inducing inputs it computes first (compute_full_zs_em, whose
    draws lead the ELBO's), as one program of (params, key, row_weights,
    num_data): the plain full batch is unit weights and the true sizes, a
    scale of exactly 1 (test_weighted_scale_identity), so both cases share
    the program."""
    X, Y, Xr = (tuple(map(jnp.asarray, a)) for a in data(n_fidelities))

    def run(p, key, w, n):
        def elbo(q):
            zs = []
            value, draws = recorded(
                lambda r: jem.elbo(r, X, Y, Xr, key, S, row_weights=w,
                                   num_data=n), full_zs=zs)(q)
            return value, (draws, zs[0])

        (value, (draws, zs)), grads = jax.value_and_grad(elbo,
                                                         has_aux=True)(p)
        return (value, draws), grads, zs

    return run


def outputs_program():
    """The Park_VD pair's other reference outputs the tests compare, {name:
    (value, draws)}: the ELBO of fidelity 0 alone, propagate (diagonal and
    full covariance), predict_f (the last fidelity, and fidelity 0 with
    fidelity_dim=0 on the 2-D inputs), project (recorded with and without
    the stub) and predict_y. Their sub-calls share one key, so predict_f
    and predict_y repeat propagate's graph, which XLA folds."""
    X, Y, Xr = (tuple(map(jnp.asarray, a)) for a in data(2))
    Xn, Xp = X[-1], jnp.asarray(PROJECTED)

    def run(p, key):
        return {
            "elbo_upto0": recorded(jem.elbo)(p, X, Y, Xr, key, S,
                                             train_upto_fidelity=0),
            "propagate": recorded(jem.propagate)(p, Xn, key, S),
            "propagate_full_cov": recorded(jem.propagate)(p, Xn, key, S,
                                                          full_cov=True),
            "predict_f": recorded(jem.predict_f)(p, Xn, key, S),
            "predict_f0": recorded(jem.predict_f)(p, X[0], key, S, 0, 0),
            "project": recorded(jem.project)(p, Xp, key, S, 0, 1),
            "project_as_is": recorded(jem.project, skip_dropped=False)(
                p, Xp, key, S, 0, 1),
            "predict_y": recorded(jem.predict_y)(p, Xn, key, S),
        }

    return run


def weight_args(n_fidelities, weighted):
    """(row_weights, num_data) of the ELBO programs: the padding of
    :func:`weights`, or unit weights and the true sizes."""
    X = data(n_fidelities)[0]
    if weighted:
        ws, nd = weights(X)
    else:
        ws, nd = [np.ones(x.shape[0]) for x in X], [float(len(x)) for x in X]
    return tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, nd))


@functools.lru_cache(maxsize=None)
def programs():
    """The four reference programs, compiled, and the 3-fidelity chain's
    parameters. Each is traced and lowered here in turn (the recording
    patches are process-wide) and handed to one of two threads to compile
    while the next is traced: XLA compiles a program on one core and
    releases the GIL, and the 3-fidelity gradient's compile alone takes
    about as long as the other three's. Each compiles at XLA's lowest
    backend optimization level (FAST_COMPILE): they run in microseconds.
    The Park_VD programs are lowered at the init's output shapes, which
    _init_variational keeps."""
    key = jax.random.PRNGKey(0)
    params3 = reference_of(port_model(3, init=True).params)
    compiled = {}
    with ThreadPoolExecutor(2) as pool:
        def compile_(name, fn, *args):
            lowered = jax.jit(fn).lower(*args)
            compiled[name] = pool.submit(lowered.compile, FAST_COMPILE)
            return lowered

        compile_("elbo3", elbo_program(3), params3, key, *weight_args(3, False))
        params = compile_("init", init_program(), key).out_info[0]
        compile_("elbo2", elbo_program(2), params, key, *weight_args(2, False))
        compile_("outputs", outputs_program(), params, key)
        return {name: c.result() for name, c in compiled.items()}, params3


@functools.lru_cache(maxsize=None)
def reference():
    """The Park_VD pair's dgp_tpu model on PRNGKey(0) (init_program), before
    and after _init_variational (q_mu <- Y_f and X_red, q_sqrt scaled: off
    the prior, where the ELBO would not depend on Z_left)."""
    at_init, draws, z_full = programs()[0]["init"](jax.random.PRNGKey(0))
    jm = reference_wrapper(2, at_init)
    jm._init_variational()
    return dict(jm=jm, at_init=at_init, init_draws=draws, z_full=z_full)


def reference_of(params):
    """dgp_tpu's MFDGPEMParams holding the port's ``params``: the structure
    from the JAX package's own constructors (traced for their shapes
    alone), every leaf the port's tensor of the same path."""
    tree = convert.numpy_tree_from_port(params)

    def layer(t, kernel):
        return jsvgp.SVGPLayer(
            kernel=kernel, z=t.get("z"), z_left=t.get("z_left"),
            q_mu=t["q_mu"], q_sqrt=t["q_sqrt"],
            mean_function=jmeans.Zero(t["num_outputs"]),
            num_outputs=t["num_outputs"], augmented="z_left" in t)

    X = data(len(tree["layers"]))[0]
    kernels, kernels_red = jax.eval_shape(lambda: jem.make_mf_em_kernels(X))
    skeleton = jem.MFDGPEMParams(
        layers=tuple(map(layer, tree["layers"], kernels)),
        layers_red=tuple(map(layer, tree["layers_red"], kernels_red)),
        likelihood=jlik.Gaussian(variance_raw=0.0),
        likelihood_projection=jlik.Gaussian(variance_raw=0.0))
    values = dict(params.named_parameters())
    leaves, treedef = jax.tree_util.tree_flatten_with_path(skeleton)
    assert {path_name(p) for p, _ in leaves} == values.keys()
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(npy(values[path_name(p)])) for p, _ in leaves])


def weights(X):
    """Row weights with the last row of each fidelity as padding (the
    last fidelity's also weighs the projection term), and full-dataset
    sizes that rescale every term."""
    ws = [np.ones(x.shape[0]) for x in X]
    for w in ws:
        w[-1] = 0.0
    return ws, [float(x.shape[0] + 3) for x in X]


@functools.lru_cache(maxsize=None)
def elbo_reference(n_fidelities, weighted):
    """The parameters, and ((value, draws), gradients, compute_full_zs_em)
    of the reference's ELBO at them on PRNGKey(1)."""
    compiled, params3 = programs()
    params = reference()["jm"].params if n_fidelities == 2 else params3
    return params, compiled[f"elbo{n_fidelities}"](
        params, jax.random.PRNGKey(1), *weight_args(n_fidelities, weighted))


@functools.lru_cache(maxsize=None)
def outputs():
    """outputs_program's values on PRNGKey(1)."""
    return programs()[0]["outputs"](reference()["jm"].params,
                                    jax.random.PRNGKey(1))


def port_of(params):
    return convert.mf_dgp_em_from_numpy(
        convert.numpy_tree_from_reference(params), "cpu", F64)


def port_model(n_fidelities, params=None, init=False, **kwargs):
    """The port's model on the CPU in float64 (off the prior with
    ``init``), holding ``params`` (a reference's) where given."""
    X, Y, Xr = data(n_fidelities)
    model = tem.MultiFidelityDeepGP_EM(X, Y, Xr, num_samples=S, device="cpu",
                                       dtype=F64, **kwargs)
    if params is not None:
        model.params = port_of(params)
    if init:
        model._init_variational()
    return model


def npy(x):
    return x.detach().numpy()


def close(got, want, rtol=RTOL, what=""):
    """got within rtol of want's largest magnitude, elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(npy(got) if torch.is_tensor(got) else got, want,
                               rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def normals(draws):
    """The reference's draws as the port's noise (writable copies)."""
    return [np.array(d) for d in draws]


@pytest.mark.parametrize("add_linear", [True, False])
@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_make_mf_em_kernels_matches_reference(n_fidelities, add_linear):
    """The same composite stacks on each fidelity's own dimensions and the
    same reduction RBFs, raw values and active dims included."""
    X = data(n_fidelities)[0]
    want = jem.make_mf_em_kernels(X, add_linear=add_linear)
    got = tem.make_mf_em_kernels(X, add_linear=add_linear, dtype=F64)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list)
        for g, w in zip(g_list, w_list):
            assert_same_tree(convert._kernel_tree(g), convert._kernel_tree(w))


def test_init_layers_mf_em_matches_reference():
    """The reduction layer maps 4-D to 2-D on W = X[1]; z_full (the
    augmented initial inducing inputs, [z_left 4-D, z_right 1-D]) and every
    layer's initial q_sqrt = chol(Kuu), the reduction layer's too, on the
    reference's init draws."""
    ref = reference()
    X, _, _ = data(2)
    kernels, kernels_red = tem.make_mf_em_kernels(X, dtype=F64)
    draws = ref["init_draws"]
    assert [d.shape for d in draws] == [(100, 4, 2), (100, 4, 1)]
    layers, layers_red = tem.init_layers_mf_em(
        X, X, [X[1]], kernels, kernels_red, noise=normals(draws), dtype=F64,
        device="cpu")
    lik = port_of(ref["at_init"])
    port = tem.MFDGPEMParams(layers, layers_red, lik.likelihood,
                             lik.likelihood_projection)
    with torch.no_grad():
        z_full = tem.compute_full_zs_em(port, num_samples=100,
                                        noise=normals(draws))
    assert [tuple(z.shape) for z in z_full] == [(8, 2), (4, 5)]
    np.testing.assert_array_equal(npy(layers[0].z), X[0])
    np.testing.assert_array_equal(npy(layers[1].z_left), X[1])
    np.testing.assert_array_equal(npy(layers_red[0].z), X[1])
    assert layers[1].z is None and layers[1].augmented
    assert tuple(layers_red[0].q_mu.shape) == (4, 2)
    assert tuple(layers_red[0].q_sqrt.shape) == (2, 4, 4)
    for i, (g, w) in enumerate(zip(z_full, ref["z_full"])):
        close(g, w, what=f"z_full {i}")
    for lt, lj in zip((*layers, *layers_red),
                      (*ref["at_init"].layers, *ref["at_init"].layers_red)):
        close(lt.q_sqrt, lj.q_sqrt, what="q_sqrt")
        close(lt.q_mu, lj.q_mu)


def test_compute_full_zs_em_matches_reference():
    """The layers' effective inducing inputs, as the ELBO computes them
    first: layer 1's Z_left mapped through the reduction layer and layer
    0, on the ELBO's first two draws."""
    params, ((_, draws), _, zs) = elbo_reference(2, False)
    with torch.no_grad():
        got = tem.compute_full_zs_em(port_of(params), noise=normals(draws))
    assert [tuple(z.shape) for z in got] == [z.shape for z in zs]
    for g, w in zip(got, zs):
        close(g, w)


@pytest.mark.parametrize("full_cov", [False, True])
def test_propagate_matches_reference(full_cov):
    """Every layer's samples, means and variances (full covariances too),
    the reduction chain first."""
    want, draws = outputs()["propagate_full_cov" if full_cov else "propagate"]
    with torch.no_grad():
        got = tem.propagate(port_of(reference()["jm"].params), data(2)[0][-1],
                            S, full_cov=full_cov, noise=normals(draws))
    for g_layers, w_layers in zip(got, want):
        for g, w in zip(g_layers, w_layers):
            assert tuple(g.shape) == w.shape
            close(g, w)


@pytest.mark.parametrize("what", ["predict_f", "predict_f0", "project",
                                  "predict_y", "predict_density"])
def test_predictions_match_reference(what, monkeypatch):
    """predict_f at the last fidelity and at fidelity 0 (fidelity_dim=0, on
    the 2-D inputs), project (the reduction posterior of 4-D inputs in the
    2-D space, at PROJECTED), predict_y, and predict_density (the reference wrapper's
    logsumexp over samples, run on the predict_f it draws)."""
    jm = reference()["jm"]
    params = port_of(jm.params)
    X = data(2)[0]
    with torch.no_grad():
        if what == "predict_density":
            (Fm, Fv), draws = outputs()["predict_f"]
            Y = park_vd_high(X[1]) + 0.1
            monkeypatch.setattr(jem, "_predict_f_jit", lambda *a: (Fm, Fv))
            want = jm.predict_density(X[1], Y, S)
            got = tem.predict_density(params, X[1], Y, S, noise=normals(draws))
        else:
            want, draws = outputs()[what]
            if what == "predict_f0":
                got = tem.predict_f(params, X[0], S, fidelity=0,
                                    fidelity_dim=0, noise=normals(draws))
            elif what == "project":
                got = tem.project(params, PROJECTED, S, fidelity=0,
                                  fidelity_dim=1, noise=normals(draws))
            else:
                fn = tem.predict_y if what == "predict_y" else tem.predict_f
                got = fn(params, X[1], S, noise=normals(draws))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert tuple(g.shape) == w.shape
        close(g, w)


def test_project_skips_only_the_dropped_z_right():
    """Recorded as it is, the reference's project draws the Z_right of
    compute_full_zs_em ([50, M_1, D] for the reduction layer, then for
    layer 0) and then the reduction layer's normals; its outputs are the
    stubbed recording's bit for bit, and its draws after the dropped ones
    are the stubbed recording's: the port, which draws no Z_right there,
    consumes exactly those."""
    (want, draws), (as_is, all_draws) = (outputs()["project"],
                                         outputs()["project_as_is"])
    for g, w in zip(as_is, want):
        np.testing.assert_array_equal(g, w)
    assert [d.shape for d in all_draws] == [(50, 4, 2), (50, 4, 1), (S, 5, 2)]
    assert len(draws) == 1
    np.testing.assert_array_equal(all_draws[-1], draws[0])


def port_gradients(params, loss):
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return dict(zip(names, grads))


@pytest.mark.parametrize("case", ["2-plain", "2-weighted", "2-upto0",
                                  "3-plain"])
def test_elbo_matches_reference(case):
    """The ELBO (every fidelity, fidelity 0 alone with its projection term,
    and with row weights and full-dataset sizes), and its gradient for every
    parameter: z_left's (through the concat and the recomputed Z_right), the
    reduction layers' z and q_mu, and the projection likelihood's each
    nonzero. The 3-fidelity chain (2 -> 3 -> 5) runs the reduction
    sub-chains layers_red[L-i:] and the skip inputs Hs[-(i+1)] for i = 2."""
    n_fidelities, variant = int(case[0]), case[2:]
    X, Y, Xr = data(n_fidelities)
    kwargs = {}
    if variant == "upto0":
        params = reference()["jm"].params
        (value, draws), grads = outputs()["elbo_upto0"], None
        kwargs = dict(train_upto_fidelity=0)
    else:
        params, ((value, draws), grads, *_) = elbo_reference(
            n_fidelities, variant == "weighted")
        if variant == "weighted":
            ws, nd = weights(X)
            kwargs = dict(row_weights=[torch.as_tensor(w) for w in ws],
                          num_data=nd)
    port = port_of(params)
    loss = tem.elbo(port, X, Y, Xr, S, noise=normals(draws), **kwargs)
    close(loss, value)
    if grads is None:
        return
    want = {path_name(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(grads)[0]}
    got = port_gradients(port, loss)
    assert got.keys() == want.keys()
    for name in want:
        close(got[name], want[name], GRAD_RTOL, name)
    nonzero = [f"layers.{i}.z_left" for i in range(1, n_fidelities)]
    nonzero += [f"layers_red.{i}.{f}" for i in range(n_fidelities - 1)
                for f in ("z", "q_mu")]
    for name in nonzero + ["likelihood_projection.variance_raw"]:
        g = want[name]
        assert np.all(np.isfinite(g)) and np.any(g != 0), name


def test_init_variational_matches_reference():
    """Fidelity q_mu <- Y_f, reduction q_mu <- X_red, q_sqrt scaled (the
    population variance of Y_f, ddof 0), and both likelihood variances."""
    ref = reference()
    model = port_model(2, ref["at_init"], init=True)
    got = convert.numpy_tree_from_port(model.params)
    want = convert.numpy_tree_from_reference(ref["jm"].params)
    for group in ("layers", "layers_red"):
        for layer_got, layer_want in zip(got[group], want[group]):
            for name in ("q_mu", "q_sqrt"):
                close(layer_got[name], layer_want[name], what=name)
    for lik in ("likelihood", "likelihood_projection"):
        close(got[lik]["variance_raw"], want[lik]["variance_raw"])


def staged(monkeypatch, model, method, training_module, empty, **options):
    """(mask, names of the natural gradient's q pairs) of each phase of
    ``method`` (called with ``options``), with the training loops stubbed
    to return at once."""
    seen = []

    def adam_run(loss_fn, params, mask, *args, **kwargs):
        seen.append((mask, None))
        return params, empty

    def nat_adam_run(loss_fn, params, mask, *args, get_qs, **kwargs):
        seen.append((mask, get_qs(params)))
        return params, empty

    monkeypatch.setattr(training_module, "adam_run", adam_run)
    monkeypatch.setattr(training_module, "nat_adam_run", nat_adam_run)
    getattr(model, method)(messages=0, **options)
    return seen


@pytest.mark.parametrize("method", ["optimize_nat_adam", "optimize_adam"])
def test_phase_masks_match_reference(method, monkeypatch):
    """The frozen tensors of each phase, field by field, as each optimizer
    hands them to the training loops, and the natural gradient's q pairs
    (every fidelity layer's, then every reduction layer's). Both
    likelihoods stay frozen in the first two phases and in the natural-
    gradient phase; Adam's phase 3 frees the model likelihood but keeps the
    projection likelihood and the reduction layers' q frozen."""
    ref = reference()
    want = staged(monkeypatch, reference_wrapper(2, ref["at_init"]), method,
                  jtrain, jnp.zeros((0,)))
    port = port_model(2, ref["at_init"])
    got = staged(monkeypatch, port, method, ttrain,
                 torch.zeros((0,), dtype=F64))
    assert len(got) == len(want) == 3
    by_id = {id(p): n for n, p in port.params.named_parameters()}
    for phase, ((mask, qs), (want_mask, want_qs)) in enumerate(
            zip(got, want), 1):
        assert mask == {path_name(p): bool(leaf) for p, leaf in
                        jax.tree_util.tree_flatten_with_path(want_mask)[0]}
        frozen = {n for n, trained in mask.items() if not trained}
        assert {"likelihood_projection.variance_raw",
                "layers_red.0.q_mu", "layers_red.0.q_sqrt"} <= frozen
        assert ("likelihood.variance_raw" in frozen) == (
            phase < 3 or method == "optimize_nat_adam")
        assert ("layers.1.z_left" in frozen) == (phase == 1)
        assert "layers_red.0.z" not in frozen
        assert (qs is None) == (want_qs is None) == (
            phase < 3 or method == "optimize_adam")
        if qs is not None:
            assert [(by_id[id(m)], by_id[id(L)]) for m, L in qs] == [
                (f"{g}.{i}.q_mu", f"{g}.{i}.q_sqrt")
                for g, i in (("layers", 0), ("layers", 1), ("layers_red", 0))]
            assert len(want_qs) == len(qs)


@pytest.mark.parametrize("method", ["optimize_nat_adam", "optimize_adam"])
def test_staged_training_keeps_frozen_tensors(method):
    """A few steps of each phase on the CPU (small steps: the first steps
    of phase 2 raise the loss), held as chip_smoke holds the card's run (check_mf_training with em_moves): finite losses, the last
    below the first; each phase's frozen tensors unchanged bit for bit (q
    aside in the natural-gradient phase); the reduction layer's z moved
    from phase 1, z_left from phase 2, q in phase 3 (the reduction q_sqrt
    by the natural gradient only), the model likelihood in Adam's phase 3
    alone, the projection likelihood never."""
    model = port_model(2)
    if method == "optimize_nat_adam":
        kwargs = dict(lr_adam=0.0005, lr_gamma=0.05, iterations3=6)
    else:
        kwargs = dict(lr=0.005, iterations3=3)
    with chip_smoke.phase_snapshots() as seen:
        losses = getattr(model, method)(iterations1=3, iterations2=3,
                                        messages=0, **kwargs)
    assert losses.shape == (6 + kwargs["iterations3"],)
    chip_smoke.check_mf_training(method, seen, losses,
                                 nat=method == "optimize_nat_adam", window=1,
                                 moves=chip_smoke.em_moves, tag="em")


def seeded(model, fn, seed=5):
    """fn() with the model's generator reset to ``seed`` first."""
    model.generator.manual_seed(seed)
    with torch.no_grad():
        return fn()


def test_weighted_scale_identity():
    """Unit row weights with num_data = N equal the plain ELBO exactly, the
    N_{f+1}/N_f scale of the projection term included (the counterpart of
    tests/test_mf_dgp_em.py::test_em_weighted_scale_identity)."""
    model = port_model(2)
    X, Y, Xr = model._X, model._Y, model._X_red
    plain = seeded(model, lambda: tem.elbo(model.params, X, Y, Xr, S,
                                           model.generator))
    ws = [torch.ones(x.shape[0], dtype=F64) for x in X]
    weighted = seeded(model, lambda: tem.elbo(
        model.params, X, Y, Xr, S, model.generator, row_weights=ws,
        num_data=[x.shape[0] for x in X]))
    assert torch.isfinite(plain) and abs(float(plain - weighted)) < 1e-10


def test_padded_rows_contribute_nothing():
    """With n_bucket, each fidelity's rows are padded with weight 0 and
    X_red[0] in lockstep with fidelity 1: the padded Y and X_red values do
    not reach the loss (the counterpart of
    tests/test_mf_dgp_em.py::test_em_padded_rows_contribute_nothing)."""
    model = port_model(2, n_bucket=6)
    loss, (Xs, Ys, Xr, ws, nd) = model._loss_spec()
    assert [x.shape[0] for x in Xs] == [12, 6] and Xr[0].shape[0] == 6
    assert nd == (8, 4)
    other = (Ys[0].clone().index_fill_(0, torch.arange(8, 12), 55.0),
             Ys[1].clone().index_fill_(0, torch.arange(4, 6), -3.0))
    other_red = (Xr[0].clone().index_fill_(0, torch.arange(4, 6), 9.0),)
    a = seeded(model, lambda: loss(model.params, model.generator,
                                   (Xs, Ys, Xr, ws, nd)))
    b = seeded(model, lambda: loss(model.params, model.generator,
                                   (Xs, other, other_red, ws, nd)))
    assert torch.isfinite(a) and float(a) == float(b)


def test_minibatch_loss_is_unbiased(monkeypatch):
    """The minibatch scales make the minibatch data and projection terms
    unbiased estimators of the full batch's (the KLs are shared): with one
    row per fidelity, whose draw also picks the projection target of
    fidelity 1's row, the mean of the minibatch loss over every pair of
    rows is the full-batch loss, to the Monte-Carlo error of the unit
    normals (the index draws are enumerated; the normals still come from
    the generator)."""
    full = port_model(2)
    mini = port_model(2, minibatch_size=1)
    mini.params = full.params
    n0, n1 = (x.shape[0] for x in full._X)
    pairs = [(i, j) for i in range(n0) for j in range(n1)]
    rows = iter(torch.tensor([r]) for pair in pairs for r in pair)
    randint = torch.randint
    drawn = []

    def enumerated(low, high, size, **kwargs):
        drawn.append(randint(low, high, size, **kwargs))
        return next(rows)

    monkeypatch.setattr(torch, "randint", enumerated)
    with torch.no_grad():
        loss, batch = mini._loss_spec()
        assert batch[3] == (n0, n1)
        mean = np.mean([float(loss(full.params, mini.generator, batch))
                        for _ in pairs])
        loss, batch = full._loss_spec()
        want = float(loss(full.params, full.generator, batch))
    assert all(0 <= int(d) < n for d, n in zip(drawn, [n0, n1] * len(pairs)))
    np.testing.assert_allclose(mean, want, rtol=1e-6)


def test_three_fidelity_shapes():
    """Three fidelities in 2, 3 and 5 dimensions: reduction layers mapping
    5 -> 3 -> 2 on W = [X[2], X[1]], and z_full [z_left, z_right] of 1 + 3
    and 1 + 5 columns (the counterpart of
    tests/test_mf_dgp_em.py::test_three_fidelity_variant_dims)."""
    model = port_model(3)
    reds = model.params.layers_red
    assert [tuple(l.q_mu.shape) for l in reds] == [(3, 3), (4, 2)]
    assert [tuple(l.z.shape) for l in reds] == [(3, 5), (4, 3)]
    with torch.no_grad():
        zs = tem.compute_full_zs_em(model.params, model.generator)
        mean, var = model.predict(data(3)[0][2])
    assert [tuple(z.shape) for z in zs] == [(6, 2), (4, 4), (3, 6)]
    assert mean.shape == (3, 1) and np.all(np.isfinite(mean))


@pytest.mark.parametrize("n_fidelities", [2, 3])
def test_convert_round_trips_the_em_tree(n_fidelities):
    """The reference's tree (the port's, for the 3-fidelity chain) crosses
    convert into the port and comes back unchanged, the reduction layers
    and the projection likelihood included."""
    if n_fidelities == 2:
        tree = convert.numpy_tree_from_reference(reference()["jm"].params)
    else:
        tree = convert.numpy_tree_from_port(port_model(3).params)
    port = convert.mf_dgp_em_from_numpy(tree, "cpu", F64)
    assert isinstance(port, tem.MFDGPEMParams)
    assert_same_tree(convert.numpy_tree_from_port(port), tree)
    assert len(tree["layers_red"]) == n_fidelities - 1
    assert "likelihood_projection" in tree
    names = [n for n, _ in port.named_parameters()]
    assert "layers_red.0.z" in names and "layers.1.z_left" in names


def test_sharded_paths_raise():
    """As in dgp_tpu: predict_y_sharded with no mesh (given or built in)
    raises ValueError; a mesh that is not a DeviceMesh is refused. (The
    sharded paths themselves: tests/test_torch_parallel.py and
    tests/test_torch_sharded_serving.py.)"""
    X, Y, Xr = data(2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tem.MultiFidelityDeepGP_EM(X, Y, Xr, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        port_model(2).predict_y_sharded(X[1], 3)


def test_natural_gradient_step_moves_q_in_float32():
    """One natural-gradient step at the natural-gradient init (q_sqrt
    scaled 1e-3 var(Y) and, on the reduction layer, 1e-5): in float32
    every layer's q_sqrt moves, as the float64 model's does under the same
    jitter. The step's maps run in float64: in float32, eta2 - eta1 eta1^T
    cancels the small S against m m^T, the factor fails and the guard
    rejects every step."""
    from dgp_tpu_torch.config import jitter_scope
    from dgp_tpu_torch.variational.natgrad import natgrad_step_multi

    params, ((_, draws), _, _) = elbo_reference(2, False)
    tree = convert.numpy_tree_from_reference(params)
    X, Y, Xr = data(2)

    def step(dtype):
        port = convert.mf_dgp_em_from_numpy(tree, "cpu", dtype)
        names = {id(p): n for n, p in port.named_parameters()}
        pairs = tem.get_qs(port)
        keys = [(names[id(m)], names[id(L)]) for m, L in pairs]
        noise = [torch.as_tensor(d, dtype=dtype) for d in normals(draws)]

        def loss(qs):
            over = {k: t for (a, b), (m, L) in zip(keys, qs)
                    for k, t in ((a, m), (b, L))}
            return torch.func.functional_call(port, over, (
                lambda p: -tem.elbo(p, X, Y, Xr, S, noise=noise),))

        with jitter_scope(1e-4):
            return pairs, natgrad_step_multi(pairs, loss, 0.01)

    for (old32, new32), (old64, new64) in zip(zip(*step(torch.float32)),
                                              zip(*step(F64))):
        moved32 = new32[1] - torch.tril(old32[1].detach())
        moved64 = new64[1] - torch.tril(old64[1].detach())
        assert torch.isfinite(new32[1]).all() and bool((moved32 != 0).any())
        assert bool((moved64 != 0).any())
        close(moved32.double(), npy(moved64), rtol=1e-2)
