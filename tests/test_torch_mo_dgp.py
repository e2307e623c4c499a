"""Port parity: the multi-objective deep GP of dgp_tpu_torch against
dgp_tpu, in float64 on CPU, on the reference's own unit normals.

Each JAX function runs jitted with ``jax.random.normal`` wrapped (pytest's
monkeypatch) so that it also returns every draw it makes, in order; the
port's function takes those draws as its ``noise``. Both then compute the
same number to f64 rounding, values and gradients alike. A trajectory of
this model is chaotically sensitive to the last bit, so training is held
by the port's own checks, never against the reference's trajectory.

The JAX outputs come from four compiled programs (XLA's compile of them
sets this file's time): the init, objective 0's ELBO at loop 0 with its
gradient, the ELBO at loop 1, and the other outputs, each lowered in turn
and compiled in a thread while the next is traced, at XLA's lowest backend
optimization level. A
loop-2 propagation at the training inputs (50 samples) serves the
propagate, predict_f, predict_y and predict_density tests and the restart
score: the reference's predict_f is that propagation indexed, and its
fit score's two objectives run on one key at equal inputs. The restart
logic is tested on the port alone, as tests/test_mo_dgp.py tests the
reference's.
"""

import copy
import functools
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch._dynamo  # noqa: F401  (the first torch.optim.Adam imports it)

from dgp_tpu.models import mf_dgp as jmf
from dgp_tpu.models import mo_dgp as jmo
from dgp_tpu.models import training as jtrain
from dgp_tpu.ops import likelihoods as jlik
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import mf_dgp as tmf
from dgp_tpu_torch.models import mo_dgp as tmo
from dgp_tpu_torch.models import training as ttrain
from dgp_tpu_torch.utils import checkpoint

import chip_smoke

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_dgp import assert_same_tree
from test_torch_mf_dgp import close, normals, npy, recorded
from test_torch_mf_dgp_em import seeded, staged
from test_mo_dgp import mo_data
from test_torch_training import path_name

F64 = torch.float64
RTOL, GRAD_RTOL = 1e-10, 1e-8
S = 3
# request rows off the training inputs (normalized x of the DoE lies in
# about [-1.6, 1.6]), a count other than N
ROWS = np.linspace(-1.5, 1.5, 7)[:, None]
DENSITY_Y = np.sin(3 * ROWS)   # the targets of predict_density at ROWS
# these tiny programs run in microseconds: spend no compile time on them
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def data():
    """mo_data()'s DoE: multi_obj_1D_4 at 10 LHS points (seed 0), x and
    both objectives normalized."""
    X, Y, _ = mo_data()
    return X, Y


def reference_wrapper(params):
    """dgp_tpu's MultiObjDeepGP around ``params`` at loop 2 (its
    constructor would run the init op by op, which XLA compiles one op at
    a time)."""
    X, Y = data()
    jm = jmo.MultiObjDeepGP.__new__(jmo.MultiObjDeepGP)
    jm._key = jax.random.PRNGKey(2)
    jm._X, jm._Y = ([jnp.asarray(a) for a in arrays] for arrays in (X, Y))
    jm.loop, jm.num_samples = 2, S
    jm.minibatch_size, jm.n_bucket, jm.mesh = None, None, None
    jm.params = params
    return jm


def init_program():
    """The reference's layers, built by its make_mo_kernels and
    init_layers_mf(pad_cols=1) on a key (recorded; the default Z, [X_0,
    Y_1] and X_1), and the init's z_full (compute_full_zs on the same key
    with init's 100 samples repeats its key splits)."""
    X, Y = data()
    Z = jmo.MultiObjDeepGP._make_inducing_points(X, Y)

    def init(key):
        kernels = jmo.make_mo_kernels(1, 2)
        layers, draws = recorded(jmf.init_layers_mf)(Z, kernels, key=key,
                                                     pad_cols=1)
        params = jmo.MODGPParams(layers=tuple(layers),
                                 likelihood=jlik.Gaussian.create(1.0))
        return params, draws, jmf.compute_full_zs(layers, key, 100,
                                                  pad_cols=1)

    return init


def gradient_program():
    """The reference's ELBO of objective 0 alone at loop 0 and its
    gradient, with the draws, as one program of (params, key, row_weights,
    num_data): the plain full batch is unit weights and the true sizes, a
    scale of exactly 1 (tests/test_mo_dgp.py::test_mo_weighted_scale_identity),
    so both cases share the program. Objective 0 at loop 0 is layer 1 on
    layer 0's output, so every parameter but the likelihood's has a
    gradient; XLA compiles the whole ELBO's gradient at loop 0 in twice the
    time, at loop 1 in three times (its value is held by elbo_program)."""
    X, Y = (tuple(map(jnp.asarray, a)) for a in data())

    def run(p, key, w, n):
        return jax.value_and_grad(recorded(
            lambda q: jmo.elbo(q, X, Y, key, S, loop=0,
                               train_upto_objective=0, row_weights=w,
                               num_data=n)), has_aux=True)(p)

    return run


def elbo_program():
    """The reference's ELBO at loop 1, with the draws, as a program of
    (params, key, row_weights, num_data), as gradient_program's."""
    X, Y = (tuple(map(jnp.asarray, a)) for a in data())

    def run(p, key, w, n):
        return recorded(jmo.elbo)(p, X, Y, key, S, 1, row_weights=w,
                                  num_data=n)

    return run


def outputs_programs():
    """The other reference outputs the tests compare, {name: (value,
    draws)} (or a value), as two programs of (params, key): propagate at
    ROWS at loop 1, the wrapper's predict_y and predict_density on it (its
    jitted predict_f stubbed to return it), and the lengthscale jitter;
    propagate at ROWS at loop 0 with full covariances and at the training
    inputs at loop 2 with 50 samples (the fit score's propagation)."""
    X = jnp.asarray(data()[0][0])
    rows = jnp.asarray(ROWS)

    def first(p, key):
        out = {"propagate1": recorded(jmo.propagate)(p, rows, key, S, 1),
               "jitter": recorded(jmo._jitter_lengthscales)(p, key)}
        # the wrapper's predict_y and predict_density on that propagation
        (_, Fmeans, Fvars), _ = out["propagate1"]
        jm = reference_wrapper(p)
        jm.loop = 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmo, "_predict_f_jit",
                       lambda *a: (Fmeans[-1], Fvars[-1]))
            out["predict_y"] = jm.predict_y(rows, S)
            out["predict_density"] = jm.predict_density(rows, DENSITY_Y, S)
        return out

    def second(p, key):
        return {"propagate0_full_cov": recorded(jmo.propagate)(
                    p, rows, key, S, 0, True),
                "propagate2": recorded(jmo.propagate)(p, X, key, 50, 2)}

    return first, second


def compile_programs():
    """The reference programs, compiled: each is traced and lowered in turn
    (the recording patches are process-wide), the costliest to compile
    first, and handed to a thread to compile while the next is traced. The
    others are traced at the init's output shapes, which
    _init_variational keeps."""
    key = jax.random.PRNGKey(0)
    weighted = weight_args(data()[0], False)
    first, second = outputs_programs()
    compiled = {}
    with ThreadPoolExecutor(4) as pool:
        def compile_(name, traced):
            compiled[name] = pool.submit(traced.lower().compile, FAST_COMPILE)

        init = jax.jit(init_program()).trace(key)
        params = init.out_info[0]
        for name, fn, args in (
                ("gradient", gradient_program(), weighted),
                ("outputs1", second, ()), ("elbo", elbo_program(), weighted),
                ("outputs0", first, ())):
            compile_(name, jax.jit(fn).trace(params, key, *args))
        compile_("init", init)
        return {name: c.result() for name, c in compiled.items()}


@functools.lru_cache(maxsize=None)
def programs():
    """The compiled reference programs (compile_programs)."""
    return compile_programs()


def weights(X):
    """Row weights with the last two rows of objective 0 and the first of
    objective 1 as padding, and full-dataset sizes that rescale every data
    term."""
    ws = [np.ones(x.shape[0]) for x in X]
    ws[0][-2:] = 0.0
    ws[1][0] = 0.0
    return ws, [float(x.shape[0] + 3) for x in X]


def weight_args(X, weighted):
    """(row_weights, num_data) of the ELBO program: :func:`weights`, or
    unit weights and the true sizes."""
    if weighted:
        ws, nd = weights(X)
    else:
        ws, nd = [np.ones(x.shape[0]) for x in X], [float(len(x)) for x in X]
    return tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, nd))


@functools.lru_cache(maxsize=None)
def reference():
    """The reference's model on PRNGKey(0) (init_program), before and after
    _init_variational (q_mu <- Y_i, q_sqrt scaled: off the prior)."""
    at_init, draws, z_full = programs()["init"](jax.random.PRNGKey(0))
    jm = reference_wrapper(at_init)
    jm._init_variational()
    return dict(jm=jm, at_init=at_init, init_draws=draws, z_full=z_full)


@functools.lru_cache(maxsize=None)
def elbo_reference(program, weighted):
    """The output of the reference's ``program`` ("gradient": ((value,
    draws), gradients); "elbo": (value, draws)) on PRNGKey(1)."""
    return programs()[program](reference()["jm"].params, jax.random.PRNGKey(1),
                               *weight_args(data()[0], weighted))


@functools.lru_cache(maxsize=None)
def outputs():
    """outputs_programs' values on PRNGKey(1)."""
    args = reference()["jm"].params, jax.random.PRNGKey(1)
    compiled = programs()
    return {**compiled["outputs0"](*args), **compiled["outputs1"](*args)}


def port_of(params):
    return convert.mo_dgp_from_numpy(convert.numpy_tree_from_reference(params),
                                     "cpu", F64)


def port_model(params=None, init=False, **kwargs):
    """The port's model on the CPU in float64 at loop 2 (off the prior with
    ``init``), holding ``params`` (a reference's) where given."""
    X, Y = data()
    kwargs = dict(dict(loop=2, num_samples=S), **kwargs)
    model = tmo.MultiObjDeepGP(X, Y, device="cpu", dtype=F64, **kwargs)
    if params is not None:
        model.params = port_of(params)
    if init:
        model._init_variational()
    return model


def hold_outputs(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if isinstance(w, tuple):
            hold_outputs(g, w)
            continue
        assert tuple(g.shape) == w.shape
        close(g, w)


# -- the port alone ------------------------------------------------------------


@pytest.mark.parametrize("method", ["optimize_nat_adam", "optimize_adam"])
def test_staged_training_keeps_frozen_tensors(method):
    """A few float32 steps of each phase on the CPU at loop 1, held as
    chip_smoke holds the card's run (check_mf_training with mo_moves):
    finite losses, the last below the first; each phase's frozen tensors
    unchanged bit for bit (q aside in the natural-gradient phase, whose
    guarded steps move it); z and z_left moved from phase 2, the
    likelihood and q in phase 3."""
    X, Y = data()
    model = tmo.MultiObjDeepGP(X, Y, loop=1, num_samples=2, device="cpu",
                               dtype=torch.float32)
    kwargs = dict(iterations1=2, iterations2=2, iterations3=3, messages=0)
    if method == "optimize_nat_adam":
        kwargs["restarts"] = 1
    with chip_smoke.phase_snapshots() as seen:
        losses = getattr(model, method)(**kwargs)
    assert losses.shape == (7,) and losses.dtype == torch.float32
    chip_smoke.check_mf_training(method, seen, losses,
                                 nat=method == "optimize_nat_adam", window=1,
                                 moves=chip_smoke.mo_moves, tag="mo")


def restart_model(**kwargs):
    """tests/test_mo_dgp.py's restart configuration (10 uniform points,
    sin(3x) and cos(2x), seed 2, in float64), cut to 6 points, loop 0 and
    one sample."""
    X = np.random.default_rng(5).uniform(0, 1, (6, 1))
    return tmo.MultiObjDeepGP([X, X.copy()], [np.sin(3 * X), np.cos(2 * X)],
                              loop=0, num_samples=1, seed=2, device="cpu",
                              dtype=F64, **kwargs)


SHORT = dict(iterations1=1, iterations2=0, iterations3=1, messages=0)


def scored(monkeypatch, scores):
    """Stub _restart_score to return ``scores`` in turn; returns the list
    of (score, criterion, the parameters' state) it was asked at."""
    seen = []
    scores = iter(scores)

    def fake(self, criterion, eval_key):
        s = next(scores)
        seen.append((s, criterion, copy.deepcopy(self.params.state_dict())))
        return s

    monkeypatch.setattr(tmo.MultiObjDeepGP, "_restart_score", fake)
    return seen


def same_state(params, state):
    got = params.state_dict()
    return got.keys() == state.keys() and all(
        torch.equal(got[k], state[k]) for k in state)


def test_auto_with_a_good_first_fit_is_restarts_1(monkeypatch):
    """restarts="auto" (the default) with a first score above the
    threshold runs the schedule once and is bit for bit the restarts=1
    run: the same losses, parameters and generator state (restart 0 keeps
    the published init and the generator's own stream)."""
    single = restart_model()
    want = single.optimize_nat_adam(restarts=1, **SHORT)
    calls = []
    guarded = tmo.MultiObjDeepGP._nat_adam_guarded

    def counting(self, *a, **k):
        calls.append(1)
        return guarded(self, *a, **k)

    monkeypatch.setattr(tmo.MultiObjDeepGP, "_nat_adam_guarded", counting)
    seen = scored(monkeypatch, [0.99])
    auto = restart_model()
    got = auto.optimize_nat_adam(**SHORT)
    assert len(calls) == 1 and [c for _, c, _ in seen] == ["fit"]
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert same_state(auto.params, single.params.state_dict())
    assert torch.equal(auto.generator.get_state(),
                       single.generator.get_state())


def test_escalation_stops_at_the_threshold(monkeypatch):
    """A first score below restart_threshold restarts; the escalation stops
    at the first candidate at or above it (not at max_restarts) and keeps
    the best; each restart r > 0 starts from jittered lengthscales (the
    other tensors as restart 0's start) and its own stream."""
    starts = []
    guarded = tmo.MultiObjDeepGP._nat_adam_guarded

    def recording(self, *a, **k):
        starts.append((copy.deepcopy(self.params.state_dict()),
                       self.generator.get_state()))
        return guarded(self, *a, **k)

    monkeypatch.setattr(tmo.MultiObjDeepGP, "_nat_adam_guarded", recording)
    seen = scored(monkeypatch, [0.3, 0.5, 0.95, 999.0])
    model = restart_model()
    model.optimize_nat_adam(**SHORT)
    assert [s for s, _, _ in seen] == [0.3, 0.5, 0.95]
    assert same_state(model.params, seen[2][2])
    first = starts[0][0]
    for state, stream in starts[1:]:
        for name, value in state.items():
            assert torch.equal(value, first[name]) != name.endswith(
                "lengthscales_raw"), name
        assert not torch.equal(stream, starts[0][1])
    assert not torch.equal(starts[1][1], starts[2][1])


def test_nan_never_wins_and_checkpoints_per_restart(monkeypatch, tmp_path):
    """A non-finite score never wins (restart 0's NaN loses to restart 1's
    -0.37, which beats restart 2's -1.2); each restart checkpoints to its
    own path, and the final save holds the kept candidate."""
    seen = scored(monkeypatch, [float("nan"), -0.37, -1.2])
    model = restart_model()
    path = str(tmp_path / "mo.ckpt")
    model.optimize_nat_adam(restarts=3, checkpoint_path=path,
                            checkpoint_every=1, **dict(SHORT, iterations3=2))
    assert [c for _, c, _ in seen] == ["fit"] * 3
    assert same_state(model.params, seen[1][2])
    assert sorted(os.listdir(tmp_path)) == [
        "mo.ckpt", "mo.ckpt.r0", "mo.ckpt.r1", "mo.ckpt.r2"]
    loaded = checkpoint.load(path, like=restart_model().params)
    assert same_state(loaded, model.params.state_dict())


def test_best_of_k_scores_on_one_stream():
    """restarts=2 with real "elbo" scores: finite losses of the kept run;
    the "fit" score deterministic on one evaluation key."""
    model = restart_model()
    losses = model.optimize_nat_adam(restarts=2, restart_select="elbo",
                                     **SHORT)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert math.isfinite(model._restart_score("fit", 7))
    assert model._restart_score("fit", 7) == model._restart_score("fit", 7)


def test_padded_rows_contribute_nothing():
    """With n_bucket, each objective's rows are padded with weight 0: the
    padded Y values do not reach the loss, and unit weights with the true
    sizes give the plain loss."""
    model = port_model(n_bucket=8)
    loss, (Xs, Ys, ws, nd) = model._loss_spec()
    assert [x.shape[0] for x in Xs] == [16, 16] and nd == (10, 10)
    other = (Ys[0].clone().index_fill_(0, torch.arange(10, 16), 44.0),
             Ys[1].clone().index_fill_(0, torch.arange(10, 16), -9.0))
    a = seeded(model, lambda: loss(model.params, model.generator,
                                   (Xs, Ys, ws, nd)))
    b = seeded(model, lambda: loss(model.params, model.generator,
                                   (Xs, other, ws, nd)))
    assert torch.isfinite(a) and float(a) == float(b)
    plain = seeded(model, lambda: -tmo.elbo(model.params, model._X,
                                            model._Y, S, model.generator))
    ones = [torch.ones(10, dtype=F64)] * 2
    unit = seeded(model, lambda: -tmo.elbo(
        model.params, model._X, model._Y, S, model.generator,
        row_weights=ones, num_data=[10, 10]))
    assert abs(float(plain - unit)) <= 1e-12 * abs(float(plain))


def test_minibatch_loss_is_unbiased(monkeypatch):
    """The N_f / B_f scale makes the minibatch data terms an unbiased
    estimator of the full batch's (the KLs are shared): with one row per
    objective, the mean of the minibatch loss over every pair of rows is
    the full-batch loss (the index draws enumerated). Every unit normal is
    0, so each row's data term is the same function of that row alone in
    both: the 1e-6 White anchor makes the Monte-Carlo error of drawn
    normals larger than the loss. At loop 1, on 4 rows, off the prior."""
    X, Y = data()
    X, Y = [x[:4] for x in X], [y[:4] for y in Y]
    full = tmo.MultiObjDeepGP(X, Y, loop=1, num_samples=S, device="cpu",
                              dtype=F64)
    full._init_variational()
    mini = tmo.MultiObjDeepGP(X, Y, loop=1, num_samples=S, device="cpu",
                              dtype=F64, minibatch_size=1)
    pairs = [(i, j) for i in range(4) for j in range(4)]
    rows = iter(torch.tensor([r]) for pair in pairs for r in pair)
    randint = torch.randint
    drawn = []

    def enumerated(low, high, size, **kwargs):
        drawn.append(randint(low, high, size, **kwargs))
        return next(rows)

    monkeypatch.setattr(torch, "randint", enumerated)
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None, **kw:
                        torch.zeros(shape, **kw))
    with torch.no_grad():
        loss, batch = mini._loss_spec()
        assert batch[2] == (4, 4)
        mean = np.mean([float(loss(full.params, mini.generator, batch))
                        for _ in pairs])
        loss, batch = full._loss_spec()
        want = float(loss(full.params, full.generator, batch))
    assert all(0 <= int(d) < 4 for d in drawn) and len(drawn) == 2 * len(pairs)
    np.testing.assert_allclose(mean, want, rtol=1e-10)


def test_wrapper_defaults_and_sharded_paths():
    """The wrapper's defaults (Z[0] = [X_0, Y_1], Z[1] = X_1; model is the
    wrapper itself; exactly two objectives out of propagate); as in
    dgp_tpu, predict_y_sharded with no mesh raises ValueError, and a mesh
    that is not a DeviceMesh is refused (the sharded paths themselves:
    tests/test_torch_parallel.py, tests/test_torch_sharded_serving.py)."""
    X, Y = data()
    model = port_model()
    assert model.model is model and model.name == "mo_dgp"
    np.testing.assert_array_equal(model.Z[0], np.hstack([X[0], Y[1]]))
    Fs, Fmeans, Fvars = model.propagate(ROWS, S=4)
    assert [tuple(f.shape) for f in Fs] == [(4, 7, 1)] * 2
    mean, var = model.predict(ROWS)
    assert mean.shape == var.shape == (7, 1) and np.all(var > 0)
    assert tuple(model.predict_density(ROWS, np.sin(ROWS), 4).shape) == (7, 1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmo.MultiObjDeepGP(X, Y, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        model.predict_y_sharded(ROWS, 3)


# -- parity with the reference ---------------------------------------------------


def test_init_layers_matches_reference():
    """init_layers_mf(pad_cols=1) on the MO kernels: layer 0 at Z_0 = [X_0,
    Y_1], layer 1 augmented at X_1 with Z_right = layer 0 at [X_1, 0]; the
    z_full and every layer's initial q_sqrt = chol(Kuu) on the reference's
    init draw."""
    ref = reference()
    X, Y = data()
    draws = ref["init_draws"]
    assert [d.shape for d in draws] == [(100, 10, 1)]
    Z = tmo.MultiObjDeepGP._make_inducing_points(X, Y)
    layers = tmf.init_layers_mf(Z, tmo.make_mo_kernels(1, 2, dtype=F64),
                                pad_cols=1, noise=normals(draws), dtype=F64,
                                device="cpu")
    with torch.no_grad():
        z_full = tmf.compute_full_zs(layers, num_samples=100, pad_cols=1,
                                     noise=normals(draws))
    assert [tuple(z.shape) for z in z_full] == [(10, 2), (10, 2)]
    np.testing.assert_array_equal(npy(layers[0].z), np.hstack([X[0], Y[1]]))
    np.testing.assert_array_equal(npy(layers[1].z_left), X[1])
    for i, (lt, lj) in enumerate(zip(layers, ref["at_init"].layers)):
        close(z_full[i], ref["z_full"][i], what=f"z_full {i}")
        close(lt.q_sqrt, lj.q_sqrt, what=f"q_sqrt {i}")
        close(lt.q_mu, lj.q_mu)


@pytest.mark.parametrize("add_linear", [True, False])
def test_make_mo_kernels_matches_reference(add_linear):
    """The coupled kernel on every layer, White(1e-6) on layer 0 only,
    raw values and active dims included."""
    want = jmo.make_mo_kernels(1, 2, add_linear=add_linear)
    got = tmo.make_mo_kernels(1, 2, add_linear=add_linear, dtype=F64)
    assert len(got) == 2
    assert [type(k.kernels[-1]).__name__ for k in got] == ["White", "RBF"]
    for g, w in zip(got, want):
        assert_same_tree(convert._kernel_tree(g), convert._kernel_tree(w))


@pytest.mark.parametrize("case", ["0_full_cov", "1", "2"])
def test_propagate_matches_reference(case):
    """Both objectives' samples, means and variances at loop 0 (with full
    covariances), 1 and 2: its own Z_right, the shared seed column, then
    2·loop + 2 conditionals (3 at loop 0)."""
    loop, full_cov = int(case[0]), case.endswith("full_cov")
    want, draws = outputs()[f"propagate{case}"]
    X, n, samples = (data()[0][0], 10, 50) if loop == 2 else (ROWS, 7, S)
    assert [d.shape for d in draws] == [(50, 10, 1), (n, 1)] + [
        (samples, n, 1)] * (2 * loop + 2 + (loop == 0))
    with torch.no_grad():
        got = tmo.propagate(port_of(reference()["jm"].params), X, samples,
                            loop=loop, full_cov=full_cov,
                            noise=normals(draws))
    assert all(len(g) == 2 for g in got)
    hold_outputs(got, want)


@pytest.mark.parametrize("what", ["predict_f0", "predict_f1", "predict_fNone",
                                  "predict_y", "predict_density"])
def test_predictions_match_reference(what):
    """predict_f at objective 0, 1 and the default (the last) at loop 1,
    held to the reference's propagation on the same draws (its predict_f
    indexes it); predict_y and predict_density, the reference wrapper's,
    run on that propagation's last objective. At ROWS, off the training
    inputs: there the variances sit at the 1e-6 White floor, where f64
    rounding in v moves log p by ~1e-9 of scale."""
    params = port_of(reference()["jm"].params)
    out = outputs()
    (_, Fmeans, Fvars), draws = out["propagate1"]
    kw = dict(loop=1, noise=normals(draws))
    with torch.no_grad():
        if what == "predict_density":
            got = tmo.predict_density(params, ROWS, DENSITY_Y, S, **kw)
        elif what == "predict_y":
            got = tmo.predict_y(params, ROWS, S, **kw)
        else:
            objective = None if what == "predict_fNone" else int(what[-1])
            got = tmo.predict_f(params, ROWS, S, objective=objective, **kw)
            idx = -1 if objective is None else objective
            out = {what: (Fmeans[idx], Fvars[idx])}
    hold_outputs(got, out[what])


@pytest.mark.parametrize("case", ["plain", "weighted", "upto0-plain",
                                  "upto0-weighted"])
def test_elbo_matches_reference(case):
    """The ELBO at loop 1, plain and with row weights and full-dataset
    sizes; and of objective 0 alone at loop 0 (objective 1's data term and
    KL dropped) with its gradient for every parameter (the likelihood's 0,
    z_left's, layer 0's z's and its White variance's nonzero)."""
    X, Y = data()
    params = port_of(reference()["jm"].params)
    upto0 = case.startswith("upto0")
    weighted = case.endswith("weighted")
    if upto0:
        (value, draws), grads = elbo_reference("gradient", weighted)
        kwargs = dict(loop=0, train_upto_objective=0)
    else:
        (value, draws), grads = elbo_reference("elbo", weighted), None
        kwargs = dict(loop=1)
    if weighted:
        ws, nd = weights(X)
        kwargs.update(row_weights=[torch.as_tensor(w) for w in ws],
                      num_data=nd)
    loop = kwargs["loop"]
    per_objective = [(50, 10, 1), (10, 1)] + [(S, 10, 1)] * (2 * loop + 2 + (
        loop == 0))
    assert [d.shape for d in draws] == [(50, 10, 1)] + per_objective * (
        1 if upto0 else 2)
    loss = tmo.elbo(params, X, Y, S, noise=normals(draws), **kwargs)
    close(loss, value)
    if grads is None:
        return
    want = {path_name(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(grads)[0]}
    names = [n for n, _ in params.named_parameters()]
    got = torch.autograd.grad(loss, list(params.parameters()),
                              allow_unused=True)
    got = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(params.named_parameters(), got)}
    assert sorted(got) == sorted(want) and len(names) == len(want)
    for name in want:
        close(got[name], want[name], GRAD_RTOL, name)
    assert not np.any(want["likelihood.variance_raw"])
    for name in ("layers.1.z_left", "layers.0.z",
                 "layers.0.kernel.kernels.1.variance_raw"):
        assert np.all(np.isfinite(want[name])) and np.any(want[name] != 0)


def test_init_variational_matches_reference():
    """q_mu <- Y_i, q_sqrt scaled by the population variance of Y_i (ddof
    0), and the likelihood variance from the last objective's."""
    ref = reference()
    got = convert.numpy_tree_from_port(port_model(ref["at_init"],
                                                  init=True).params)
    want = convert.numpy_tree_from_reference(ref["jm"].params)
    for layer_got, layer_want in zip(got["layers"], want["layers"]):
        for name in ("q_mu", "q_sqrt"):
            close(layer_got[name], layer_want[name], what=name)
    close(got["likelihood"]["variance_raw"],
          want["likelihood"]["variance_raw"])


def test_jitter_lengthscales_matches_reference():
    """The restarts' log-normal lengthscale jitter on the reference's own
    eps per lengthscale tensor (drawn in the reference's leaf order, which
    is the port's parameter order): every lengthscale moved, every other
    tensor bit for bit the same, the input left as it was."""
    params = port_of(reference()["jm"].params)
    before = copy.deepcopy(params.state_dict())
    want, draws = outputs()["jitter"]
    want = {path_name(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    names = [n for n, _ in params.named_parameters()
             if n.endswith("lengthscales_raw")]
    assert len(draws) == len(names) == 6
    assert names == [n for n in want if n.endswith("lengthscales_raw")]
    got = tmo._jitter_lengthscales(params, noise=normals(draws))
    for name, leaf in got.named_parameters():
        if name in names:
            close(leaf, want[name], what=name)
            assert not torch.equal(leaf, before[name])
        else:
            assert torch.equal(leaf, before[name]), name
    for name, leaf in params.state_dict().items():
        assert torch.equal(leaf, before[name])


@pytest.mark.parametrize("criterion", ["fit", "elbo"])
def test_restart_score_matches_reference(criterion, monkeypatch):
    """The restart score on one evaluation stream: "fit", the worst
    per-objective train r2 of predict_f at 50 samples (moment-matched; the
    reference's shared key gives both objectives the same normals, and
    their inputs are equal), and "elbo" (at loop 1); the reference
    wrapper's _restart_score runs on the outputs of its jitted calls
    recorded at that key."""
    jm = reference_wrapper(reference()["jm"].params)
    model = port_model(jm.params)
    if criterion == "fit":
        (_, Fmeans, Fvars), draws = outputs()["propagate2"]
        monkeypatch.setattr(
            jmo, "_predict_f_jit",
            lambda p, X, key, S_, obj, *a: (Fmeans[obj], Fvars[obj]))
    else:
        jm.loop = model.loop = 1
        value, draws = elbo_reference("elbo", False)
        monkeypatch.setattr(jmo, "_elbo_jit", lambda *a: value)
    want = jm._restart_score(criterion, jax.random.PRNGKey(1))
    got = model._restart_score(criterion, normals(draws))
    assert isinstance(got, float) and math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(ValueError, match="restart_select"):
        model._restart_score("nope", normals(draws))


@pytest.mark.parametrize("method", ["optimize_nat_adam", "optimize_adam"])
def test_phase_masks_match_reference(method, monkeypatch):
    """The frozen tensors of each phase, field by field, as each optimizer
    hands them to the training loops, and the natural gradient's q pairs
    (every layer's): phase 1 trains the kernels alone, phase 2 also z and
    z_left, phase 3 everything but q (natural gradients) or everything
    (Adam)."""
    kwargs = {"restarts": 1} if method == "optimize_nat_adam" else {}
    ref = reference()
    want = staged(monkeypatch, reference_wrapper(ref["at_init"]), method,
                  jtrain, jnp.zeros((0,)), **kwargs)
    port = port_model(ref["at_init"])
    got = staged(monkeypatch, port, method, ttrain,
                 torch.zeros((0,), dtype=F64), **kwargs)
    assert len(got) == len(want) == 3
    by_id = {id(p): n for n, p in port.params.named_parameters()}
    for phase, ((mask, qs), (want_mask, want_qs)) in enumerate(
            zip(got, want), 1):
        assert mask == {path_name(p): bool(leaf) for p, leaf in
                        jax.tree_util.tree_flatten_with_path(want_mask)[0]}
        frozen = {n for n, trained in mask.items() if not trained}
        q = {f"layers.{i}.{f}" for i in (0, 1) for f in ("q_mu", "q_sqrt")}
        assert (q <= frozen) == (phase < 3 or method == "optimize_nat_adam")
        assert ("likelihood.variance_raw" in frozen) == (phase < 3)
        assert {"layers.0.z", "layers.1.z_left"} <= frozen if phase == 1 \
            else not {"layers.0.z", "layers.1.z_left"} & frozen
        assert (qs is None) == (want_qs is None) == (
            phase < 3 or method == "optimize_adam")
        if qs is not None:
            assert [(by_id[id(m)], by_id[id(L)]) for m, L in qs] == [
                (f"layers.{i}.q_mu", f"layers.{i}.q_sqrt") for i in (0, 1)]
            assert len(want_qs) == len(qs)


def test_convert_round_trips_the_mo_tree():
    """The reference's tree crosses convert into the port and comes back
    unchanged; layer 0 holds z ([X, Y_1], two columns), layer 1 z_left."""
    tree = convert.numpy_tree_from_reference(reference()["jm"].params)
    port = convert.mo_dgp_from_numpy(tree, "cpu", F64)
    assert isinstance(port, tmo.MODGPParams)
    assert_same_tree(convert.numpy_tree_from_port(port), tree)
    assert [("z" in t, "z_left" in t) for t in tree["layers"]] == [
        (True, False), (False, True)]
    assert tree["layers"][0]["z"].shape == (10, 2)
