"""Port parity: data-parallel training over ``torch.distributed``
(``parallel/mesh.py``, ``parallel/data_parallel.py``, the wrappers'
``mesh=``), in float64 on the CPU.

One module-scoped start of 4 gloo ranks runs every rank-side check
(:func:`parallel_checks`) and hands its results back to this process; the
tests read them. Meanwhile this process computes the references: dgp_tpu's
``sharded_dgp_loss`` on ``make_mesh(4)`` over the conftest's virtual CPU
devices (value and gradient of a 1-layer model, N = 42, so the rows pad to
44), and its ``pad_shard_batch``. The 2-layer DGP, MF, EM and MO sharded
losses are held to the port's single-device functions, which the other
test files hold to dgp_tpu: each rank gets its rows' slice of one fixed
draw (recorded from a single-device run), the multi-fidelity and
multi-objective models every draw of their augmented inducing inputs
whole.
"""

import datetime
import os
import pickle
import threading
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from chip_smoke import rank_rows, rank_share, recorded_draws
# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
WORLD = 4
S = 3
RTOL, GRAD_RTOL = 1e-10, 1e-8
# the reference's tiny programs run in microseconds: spend no compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


# -- the ranks --------------------------------------------------------------------


def _rank_main(target, rank, world, folder):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{folder}/init", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        results = target()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def start_ranks(target, folder, world=WORLD):
    """Start ``world`` gloo ranks on the CPU, each running ``target()`` and
    saving the dict it returns. The ranks come from a fork server, a fresh
    process that imports torch and the port once (a spawned rank spends
    seconds importing them, four at once) and, having no threads, forks
    safely; the first start waits for its imports, so the ranks start in
    a thread while this process goes on. Returns that thread; it holds
    the processes once joined."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch._dynamo", "numpy",
                                "dgp_tpu_torch.parallel.data_parallel",
                                target.__module__])
    procs = [ctx.Process(target=_rank_main, args=(target, r, world,
                                                  str(folder)))
             for r in range(world)]
    starter = threading.Thread(target=lambda: [p.start() for p in procs])
    starter.procs = procs
    starter.start()
    return starter


def collect(starter, folder, timeout=120):
    """Every rank's results, rank by rank."""
    starter.join(timeout)
    procs = starter.procs
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * len(procs)
    out = []
    for r in range(len(procs)):
        with open(os.path.join(folder, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def attempt(results, name, fn, *args):
    """results[name] = fn(*args), or the traceback of its failure."""
    try:
        results[name] = fn(*args)
    except Exception:  # reported by the test that reads it
        results[name] = {"error": traceback.format_exc()}


def result(ranks, name):
    """The named check's result on every rank (failing on a rank's error)."""
    out = [r[name] for r in ranks]
    for rank, got in enumerate(out):
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"rank {rank}: {got['error']}")
    return out


def npy(t):
    return t.detach().cpu().numpy().copy()


def named_grads(params, grads):
    return {n: npy(g) for (n, _), g in zip(params.named_parameters(), grads)
            if g is not None}


# -- models (built alike on every rank and here) ------------------------------------


def one_layer(mesh=None, N=42, seed=5, off_prior=False):
    """A sampling-free 1-layer DGP (its ELBO does not depend on the draws),
    non-whitened, M = 6."""
    from dgp_tpu_torch.models import dgp as tdgp
    from dgp_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(N, 1))
    Y = np.sin(5 * X)
    model = tdgp.DGP(X, Y, X[:6].copy(),
                     [TK.RBF.create(lengthscales=[1.0], dtype=F64)], [],
                     num_samples=S, seed=7, mesh=mesh, **CPU)
    if off_prior:
        move_q(model.params, seed + 1)
    return model


def two_layer(mesh=None, N=42, seed=3, num_samples=S, **kwargs):
    """A 2-layer DGP, Din 2 -> 2 -> 1, q off the prior."""
    from dgp_tpu_torch.models import dgp as tdgp
    from dgp_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(N, 2))
    Y = np.sin(3 * X[:, :1]) + X[:, 1:] ** 2
    kernels = [TK.RBF.create(variance=1.2, lengthscales=[0.7] * 2, dtype=F64)
               for _ in range(2)]
    model = tdgp.DGP(X, Y, X[:7].copy(), kernels, [2],
                     num_samples=num_samples, seed=seed, mesh=mesh, **CPU,
                     **kwargs)
    move_q(model.params, seed + 1)
    return model


@torch.no_grad()
def move_q(params, seed):
    rng = np.random.default_rng(seed)
    for layer in params.layers:
        D, M, _ = layer.q_sqrt.shape
        layer.q_mu.copy_(torch.as_tensor(rng.normal(size=(M, D))))
        layer.q_sqrt.add_(torch.as_tensor(np.tril(0.1 * rng.normal(
            size=(D, M, M)))))


def mf_model(mesh=None):
    from dgp_tpu_torch.models import mf_dgp as tmf

    rng = np.random.default_rng(11)
    X = [rng.uniform(0, 1, size=(14, 2)), rng.uniform(0, 1, size=(6, 2))]
    Y = [np.sin(4 * x[:, :1]) + x[:, 1:] for x in X]
    model = tmf.MultiFidelityDeepGP(X, Y, num_samples=S, mesh=mesh, **CPU)
    model._init_variational()
    return model


def em_model(mesh=None):
    from dgp_tpu_torch.models import mf_dgp_em as tem

    rng = np.random.default_rng(12)
    X = [rng.uniform(0, 1, size=(14, 2)), rng.uniform(0, 1, size=(6, 4))]
    Y = [np.sin(4 * X[0][:, :1]) + X[0][:, 1:],
         np.sin(4 * X[1][:, :1]) + X[1][:, 1:2] * X[1][:, 3:]]
    model = tem.MultiFidelityDeepGP_EM(X, Y, [X[1][:, :2]], num_samples=S,
                                       mesh=mesh, **CPU)
    model._init_variational()
    return model


def mo_model(mesh=None):
    from dgp_tpu_torch.models import mo_dgp as tmo

    X = np.linspace(0, 1, 10)[:, None]
    Y = [np.sin(6 * X), np.cos(5 * X) + X]
    model = tmo.MultiObjDeepGP([X, X.copy()], Y, loop=2, num_samples=S,
                               mesh=mesh, **CPU)
    model._init_variational()
    return model


# -- rank-side checks --------------------------------------------------------------------


def check_one_layer(mesh):
    """The 1-layer sharded loss and gradient (against dgp_tpu) and the
    local batch."""
    from dgp_tpu_torch.parallel import data_parallel as dp

    model = one_layer(off_prior=True)
    X, Y = model.data
    batch = dp.pad_shard_batch(mesh, X, Y)
    loss = dp.sharded_dgp_loss(mesh, S)
    value = loss(model.params, model.generator, batch)
    grads = loss.reduce_grads(torch.autograd.grad(
        value, list(model.params.parameters())))
    return {"value": float(value), "grads": named_grads(model.params, grads),
            "X": npy(batch[0]), "w": npy(batch[2]), "num_data": batch[3]}


def two_layer_reference(model, num_samples=S):
    """The single-device loss, its gradient and its draws."""
    from dgp_tpu_torch.models import dgp as tdgp

    X, Y = model.data
    gen = torch.Generator().manual_seed(0)
    _, zs = recorded_draws(lambda: tdgp.elbo(model.params, X, Y, num_samples,
                                             gen))
    value = -tdgp.elbo(model.params, X, Y, num_samples, zs=zs)
    grads = torch.autograd.grad(value, list(model.params.parameters()))
    return float(value), named_grads(model.params, grads), zs


def check_two_layer(mesh, kind):
    """The 2-layer sharded loss and gradient against the single-device ones
    on one draw, on a 1-D, a data x sample or a (slice, data) mesh."""
    from dgp_tpu_torch.parallel import data_parallel as dp
    from dgp_tpu_torch.parallel import mesh as pm

    num_samples = 4 if kind == "2d" else S
    single = two_layer(num_samples=num_samples)
    want, want_grads, zs = two_layer_reference(single, num_samples)
    sharded = two_layer(mesh, num_samples=num_samples)
    row_axes, sample_axis = dp.mesh_row_axes(mesh)
    block, n_blocks = pm.block_of(mesh, row_axes)
    local = [rank_rows(z, 1, block, n_blocks) for z in zs]
    if sample_axis:
        k = pm.axis_size(mesh, sample_axis)
        s = num_samples // k
        i = pm.axis_index(mesh, sample_axis)
        local = [z[i * s:(i + 1) * s] for z in local]
    loss, batch = sharded._loss_spec()
    value = loss(sharded.params, sharded.generator, batch, zs=local)
    grads = loss.reduce_grads(torch.autograd.grad(
        value, list(sharded.params.parameters())))
    return {"value": float(value), "want": want,
            "grads": named_grads(sharded.params, grads),
            "want_grads": want_grads}


def check_family(mesh, build, elbo_of):
    """A multi-fidelity or multi-objective model's sharded loss (its
    wrapper's _loss_spec on the mesh) and gradient against the
    single-device ones, on one draw."""
    from dgp_tpu_torch.parallel import mesh as pm

    single = build()
    gen = torch.Generator().manual_seed(0)
    _, draws = recorded_draws(lambda: elbo_of(single, gen=gen))
    want = -elbo_of(single, noise=draws)
    want_grads = torch.autograd.grad(want, list(single.params.parameters()))
    sharded = build(mesh)
    block, n_blocks = pm.block_of(mesh)
    loss, batch = sharded._loss_spec()
    value = loss(sharded.params, sharded.generator, batch,
                 noise=rank_share(draws, S, block, n_blocks))
    grads = loss.reduce_grads(torch.autograd.grad(
        value, list(sharded.params.parameters())))
    return {"value": float(value), "want": float(want),
            "grads": named_grads(sharded.params, grads),
            "want_grads": named_grads(single.params, want_grads)}


def check_factories(mesh, mesh2d, slices):
    """make_data_parallel_elbo, make_data_sample_parallel_elbo,
    make_multislice_elbo and make_data_parallel_loss on this rank's rows
    of the sampling-free 1-layer model (44 rows: every split is even),
    beside its single-device ELBO."""
    from dgp_tpu_torch.models import dgp as tdgp
    from dgp_tpu_torch.parallel import data_parallel as dp
    from dgp_tpu_torch.parallel import mesh as pm

    model = one_layer(N=44, off_prior=True)
    X, Y = model.data
    out = {"want": float(tdgp.elbo(model.params, X, Y, 4))}
    with torch.no_grad():
        for name, m, elbo in (
                ("1d", mesh, dp.make_data_parallel_elbo(mesh, 4)),
                ("2d", mesh2d, dp.make_data_sample_parallel_elbo(mesh2d, 4)),
                ("slices", slices, dp.make_multislice_elbo(slices, 4))):
            rows = dp.mesh_row_axes(m)[0]
            Xl, Yl = pm.shard_batch(m, X, Y, axis_name=rows)
            out[name] = float(elbo(model.params, Xl, Yl, None))
        Xl, Yl = pm.shard_batch(mesh, X, Y)
        out["loss"] = float(dp.make_data_parallel_loss(mesh, 4)(Xl, Yl)(
            model.params, None))
    return out


def mf_elbo(model, gen=None, noise=None):
    from dgp_tpu_torch.models import mf_dgp as tmf

    return tmf.elbo(model.params, model._X, model._Y, S, gen, noise=noise)


def em_elbo(model, gen=None, noise=None):
    from dgp_tpu_torch.models import mf_dgp_em as tem

    return tem.elbo(model.params, model._X, model._Y, model._X_red, S, gen,
                    noise=noise)


def mo_elbo(model, gen=None, noise=None):
    from dgp_tpu_torch.models import mo_dgp as tmo

    return tmo.elbo(model.params, model._X, model._Y, S, gen, loop=2,
                    noise=noise)


def params_of(module):
    return {n: npy(p) for n, p in module.named_parameters()}


def check_trajectory(mesh):
    """5 + 5 Adam + natural-gradient steps of the 1-layer model on the mesh
    and on one device."""
    single, sharded = one_layer(), one_layer(mesh)
    single.optimize_nat_adam(iterations1=5, iterations2=5, messages=0)
    losses = sharded.optimize_nat_adam(iterations1=5, iterations2=5,
                                       messages=0)
    return {"params": params_of(sharded.params),
            "want": params_of(single.params), "losses": npy(losses)}


def check_steps(mesh):
    """Adam steps on every rank's own draws: the 2-layer DGP (2 Adam, then
    1 + 1 Adam + natural-gradient), MF (2 Adam) and MO (2 restarts of a
    1 + 0 + 1 guarded schedule): every rank must end with the same
    parameters."""
    from dgp_tpu_torch.models import training

    out = {}
    model = two_layer(mesh)
    model.optimize_adam(iterations=2, messages=0)
    model.optimize_nat_adam(iterations1=1, iterations2=1, messages=0)
    out["dgp"] = params_of(model.params)
    model = mf_model(mesh)
    loss, batch = model._loss_spec()
    training.adam_run(loss, model.params, training.make_mask(model.params),
                      model.generator, steps=2, data=batch)
    out["mf"] = params_of(model.params)
    model = mo_model(mesh)
    model.optimize_nat_adam(iterations1=1, iterations2=0, iterations3=1,
                            messages=0, restarts=2)
    out["mo"] = params_of(model.params)
    return out


def check_minibatch(mesh, mesh2d):
    """The minibatch estimator at fixed indices against its formula, its
    mean over 200 draws, and a data x sample mesh's draws."""
    from dgp_tpu_torch.layers.svgp import layer_kl
    from dgp_tpu_torch.models import dgp as tdgp
    from dgp_tpu_torch.parallel import data_parallel as dp

    model = one_layer(off_prior=True)
    params = model.params
    X, Y = model.data
    batch = dp.pad_shard_batch(mesh, X, Y)
    Xl, Yl, w, n = batch
    B, b_local = 8, 2
    loss = dp.sharded_dgp_minibatch_loss(mesh, S, B)
    n_local = int(w.sum())
    idx = torch.tensor([0, n_local - 1])
    with torch.no_grad():
        got = float(loss(params, None, batch, idx=idx))
        Fm, Fv = tdgp.predict_f(params, Xl[idx], S)
        ve = params.likelihood.variational_expectations(Fm, Fv, Yl[idx])
        est = torch.sum(torch.mean(ve, dim=0)) * n_local / b_local
        dist.all_reduce(est)
        want = float(-(est - sum(layer_kl(l, l.z) for l in params.layers)))
        full = float(dp.sharded_dgp_loss(mesh, S)(params, None, batch))
        gen = torch.Generator().manual_seed(dp.rank_seed(mesh, 1))
        draws = np.array([float(loss(params, gen, batch))
                          for _ in range(200)])
        mesh_model = one_layer(mesh2d, off_prior=True)
        mesh_model.minibatch_size, mesh_model.num_samples = B, 4
        loss2, batch2 = mesh_model._loss_spec()
        two_d = [float(loss2(mesh_model.params, mesh_model.generator, batch2))
                 for _ in range(3)]
    return {"got": got, "want": want, "full": full, "draws": draws,
            "two_d": two_d}


def check_family_minibatch(mesh):
    """One minibatch loss-and-gradient of MF, EM and MO on every rank's own
    draws (the values and reduced gradients must agree across ranks)."""
    out = {}
    for name, build, sizes in (("mf", mf_model, [8, 4]),
                               ("em", em_model, [8, 4]),
                               ("mo", mo_model, [4, 4])):
        model = build(mesh)
        model.minibatch_size = sizes
        loss, batch = model._loss_spec()
        value = loss(model.params, model.generator, batch)
        grads = loss.reduce_grads(torch.autograd.grad(
            value, list(model.params.parameters()), allow_unused=True))
        out[name] = {"value": float(value),
                     "grads": named_grads(model.params, grads)}
    return out


def check_errors(mesh2d):
    """The topology checks' errors, with the JAX package's texts."""
    from dgp_tpu_torch.parallel import data_parallel as dp
    from dgp_tpu_torch.parallel import mesh as pm

    out = {}
    for name, fn in [
            ("other_axes", lambda: dp.mesh_row_axes(
                pm.make_mesh(axis_name="rows", device_type="cpu"))),
            ("require_1d", lambda: dp._require_1d(mesh2d, "data", "what")),
            ("not_a_mesh", lambda: dp.mesh_row_axes(object())),
            ("too_many", lambda: pm.make_mesh(8, device_type="cpu")),
            ("no_card", lambda: pm.make_mesh()),
            ("samples", lambda: dp.sharded_dgp_loss(mesh2d, 3)),
            ("mf_2d", lambda: dp.sharded_mf_loss(mesh2d, 3))]:
        try:
            fn()
            out[name] = None
        except Exception as e:  # the test reads the type and text
            out[name] = (type(e).__name__, str(e))
    return out


def parallel_checks():
    from dgp_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(device_type="cpu")
    mesh2d = pm.make_mesh_2d(2, 2, device_type="cpu")
    slices = pm.make_mesh_multislice(2, 2, device_type="cpu")
    results = {}
    attempt(results, "one_layer", check_one_layer, mesh)
    for kind, m in (("1d", mesh), ("2d", mesh2d), ("slices", slices)):
        attempt(results, f"two_layer_{kind}", check_two_layer, m, kind)
    for name, build, elbo_of in (("mf", mf_model, mf_elbo),
                                 ("em", em_model, em_elbo),
                                 ("mo", mo_model, mo_elbo)):
        attempt(results, name, check_family, mesh, build, elbo_of)
    attempt(results, "factories", check_factories, mesh, mesh2d, slices)
    attempt(results, "trajectory", check_trajectory, mesh)
    attempt(results, "steps", check_steps, mesh)
    attempt(results, "minibatch", check_minibatch, mesh, mesh2d)
    attempt(results, "family_minibatch", check_family_minibatch, mesh)
    attempt(results, "errors", check_errors, mesh2d)
    return results


# -- the reference, and the tests ------------------------------------------------------


def reference_one_layer():
    """dgp_tpu's sharded_dgp_loss on make_mesh(4): (value, {name: grad},
    the padded batch)."""
    import jax
    import jax.numpy as jnp

    from dgp_tpu.parallel import data_parallel as jdp
    from dgp_tpu.parallel import mesh as jmesh
    from test_torch_monitor import reference_params
    from test_torch_training import path_name

    model = one_layer(off_prior=True)
    X, Y = (jnp.asarray(npy(a)) for a in model.data)
    mesh = jmesh.make_mesh(WORLD)
    batch = jdp.pad_shard_batch(mesh, X, Y)
    args = (reference_params(model.params), jax.random.PRNGKey(0), batch)
    value, grads = jax.jit(jax.value_and_grad(jdp.sharded_dgp_loss(
        mesh, S))).lower(*args).compile(FAST_COMPILE)(*args)
    named = {path_name(path): np.asarray(leaf) for path, leaf in
             jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(value), named, [np.asarray(a) for a in batch]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ranks")
    procs = start_ranks(parallel_checks, folder)
    try:
        reference = reference_one_layer()
    finally:
        out = collect(procs, folder)
    return out, reference


def assert_close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def assert_grads(got, want):
    assert got.keys() <= want.keys() and len(got) >= 4
    for name in got:
        np.testing.assert_allclose(
            got[name], want[name], rtol=GRAD_RTOL,
            atol=1e-10 * max(np.abs(want[name]).max(), 1e-300), err_msg=name)


def assert_rank_equal(values):
    """Every rank's values bit for bit rank 0's."""
    first = values[0]
    for rank, other in enumerate(values[1:], 1):
        if isinstance(first, dict):
            assert other.keys() == first.keys()
            for k in first:
                assert np.array_equal(other[k], first[k]), (rank, k)
        else:
            assert np.array_equal(other, first), rank


def test_sharded_dgp_loss_matches_reference(ranks):
    """The 1-layer sharded loss on 4 ranks (42 rows padded to 44) against
    dgp_tpu's on 4 devices: value to 1e-10, gradient to 1e-8."""
    out, (value, grads, _) = ranks
    for got in result(out, "one_layer"):
        np.testing.assert_allclose(got["value"], value, rtol=RTOL)
        assert_grads(got["grads"], grads)


def test_pad_shard_batch_matches_reference(ranks):
    """Each rank's block is its device's shard of dgp_tpu's padded batch:
    11 rows each, the last two of rank 3 padding of weight 0."""
    out, (_, _, (X, Y, w, n)) = ranks
    for rank, got in enumerate(result(out, "one_layer")):
        rows = slice(11 * rank, 11 * (rank + 1))
        np.testing.assert_array_equal(got["X"], X[rows])
        np.testing.assert_array_equal(got["w"], w[rows])
        assert got["num_data"] == int(n) == 42
    assert [float(r["w"].sum()) for r in result(out, "one_layer")] == [
        11, 11, 11, 9]


@pytest.mark.parametrize("kind", ["1d", "2d", "slices"])
def test_two_layer_sharded_loss_matches_single_device(ranks, kind):
    """The 2-layer sharded loss and gradient, each rank on its slice of one
    draw, equal the single-device ones on the whole draw on a 1-D mesh,
    a data x sample mesh and a (slice, data) mesh."""
    out, _ = ranks
    got = result(out, f"two_layer_{kind}")
    for g in got:
        np.testing.assert_allclose(g["value"], g["want"], rtol=RTOL)
        assert_grads(g["grads"], g["want_grads"])
    assert_rank_equal([g["grads"] for g in got])


@pytest.mark.parametrize("family", ["mf", "em", "mo"])
def test_family_sharded_loss_matches_single_device(ranks, family):
    """MF, EM and MO through their wrappers' _loss_spec on the mesh: the
    sharded loss and gradient on each rank's slice of one draw (the
    augmented inducing inputs' draws whole) equal the single-device ones;
    every rank's gradient bit-equal."""
    out, _ = ranks
    got = result(out, family)
    for g in got:
        np.testing.assert_allclose(g["value"], g["want"], rtol=RTOL)
        assert_grads(g["grads"], g["want_grads"])
    assert_rank_equal([g["grads"] for g in got])


def test_elbo_factories_match_single_device(ranks):
    """The JAX package's ELBO factories, ported: on a 1-D, a data x sample
    and a (slice, data) mesh the sampling-free model's sharded ELBO is its
    single-device one, and make_data_parallel_loss its negative."""
    out, _ = ranks
    for g in result(out, "factories"):
        for name in ("1d", "2d", "slices"):
            np.testing.assert_allclose(g[name], g["want"], rtol=RTOL)
        np.testing.assert_allclose(g["loss"], -g["want"], rtol=RTOL)


def test_mesh_trainer_trajectory_matches_single_device(ranks):
    """DGP(mesh=...) trains through the same loops as one device; on the
    sampling-free 1-layer model 5 + 5 Adam + natural-gradient steps land
    within 1e-9 of the single-device parameters, bit-equal on every rank
    (42 rows: the weighted padding is exercised)."""
    out, _ = ranks
    got = result(out, "trajectory")
    for g in got:
        assert g["params"].keys() == g["want"].keys()
        for k in g["want"]:
            np.testing.assert_allclose(g["params"][k], g["want"][k],
                                       rtol=1e-9, atol=1e-9, err_msg=k)
        assert np.all(np.isfinite(g["losses"])) and g["losses"].shape == (10,)
    assert_rank_equal([g["params"] for g in got])
    assert_rank_equal([g["losses"] for g in got])


@pytest.mark.parametrize("family", ["dgp", "mf", "mo"])
def test_ranks_stay_bit_equal_on_their_own_draws(ranks, family):
    """Each rank draws its own normals; after the steps (MO: two restarts,
    their key and scores the first rank's) every rank holds the same
    parameters, bit for bit."""
    out, _ = ranks
    params = [g[family] for g in result(out, "steps")]
    assert all(np.all(np.isfinite(v)) for v in params[0].values())
    assert_rank_equal(params)


def test_minibatch_estimator_at_fixed_indices(ranks):
    """At fixed local indices the sharded minibatch loss is the sum over
    ranks of (n_local / B_local) times the rows' terms, minus the KL."""
    out, _ = ranks
    for g in result(out, "minibatch"):
        np.testing.assert_allclose(g["got"], g["want"], rtol=RTOL)


def test_minibatch_mean_is_the_full_loss(ranks):
    """The mean of 200 minibatch losses (per-rank draws) lies within 4
    standard errors of the full sharded loss; on a data x sample mesh the
    minibatch loss runs and agrees across ranks."""
    out, _ = ranks
    got = result(out, "minibatch")
    for g in got:
        d = g["draws"]
        assert abs(d.mean() - g["full"]) <= 4 * d.std() / np.sqrt(d.size)
        assert np.all(np.isfinite(g["two_d"]))
    assert_rank_equal([np.array(g["two_d"]) for g in got])
    assert_rank_equal([g["draws"] for g in got])


@pytest.mark.parametrize("family", ["mf", "em", "mo"])
def test_family_minibatch_losses_agree_across_ranks(ranks, family):
    out, _ = ranks
    got = [g[family] for g in result(out, "family_minibatch")]
    assert np.isfinite(got[0]["value"])
    assert_rank_equal([np.array(g["value"]) for g in got])
    assert_rank_equal([g["grads"] for g in got])


@pytest.mark.parametrize("case, kind, text", [
    ("other_axes", "ValueError", "unsupported mesh axes ('rows',)"),
    ("require_1d", "ValueError",
     "what supports 1-D ('data',) data meshes only; got axes "
     "('data', 'sample')"),
    ("not_a_mesh", "TypeError", "DeviceMesh"),
    ("too_many", "ValueError", "requested 8 ranks"),
    ("no_card", "RuntimeError", "device_type='cpu'"),
    ("samples", "ValueError", "num_samples=3 must divide over the 2-way "
     "sample axis"),
    ("mf_2d", "ValueError", "sharded_mf_loss supports 1-D"),
])
def test_topology_errors(ranks, case, kind, text):
    out, _ = ranks
    for got in result(out, "errors"):
        assert got[case] is not None and got[case][0] == kind
        assert text in got[case][1]
