"""Port parity: the nonlinear autoregressive multi-fidelity GP
(``dgp_tpu_torch/models/nargp.py``) against ``dgp_tpu`` in float64 on CPU,
on the same numpy data and parameters (``convert.numpy_tree_from_reference``
/ ``nargp_from_numpy``): level 0 against the exact GPR; the mean chain and
the augmented, bucket-padded ``train_data``; the per-level NLLs to 1e-10 and
their gradients to 1e-8 (relative); ``predict_f``'s [S, m, 1] moments at 2
and 3 levels on the reference's own unit normals (drawn with the keys
``dgp_tpu``'s ``predict_f`` uses, passed as ``noise``) to 1e-10; the
multi-start engine on level 1's composite kernel fed the reference's own
stacked starts (loss trace to 1e-8 relative, the same winner, its
parameters to 1e-8); and the cache that the ``params`` and ``data``
setters invalidate. Each reference configuration runs as one jitted
program (its eager ops would compile one by one)."""

import copy
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# the first torch.optim.Adam imports torch._dynamo (~1.5 s): import it with
# the rest
import torch._dynamo  # noqa: F401

from dgp_tpu.models import gpr as jgpr
from dgp_tpu.models import nargp as jnargp
from dgp_tpu.models.training import multistart_adam_engine
from dgp_tpu_torch import convert
from dgp_tpu_torch.models import gpr as tgpr
from dgp_tpu_torch.models import nargp as tnargp
from dgp_tpu_torch.models import training
from dgp_tpu_torch.ops import kernels as TK

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_cokriging import assert_close, assert_trees_close

F64 = torch.float64
S = 6       # MC samples of predict_f
M_NEW = 5   # new points

# levels: (rows per level, input dimensions, n_bucket)
CONFIGS = {2: ((9, 5), 2, 8), 3: ((8, 5, 4), 1, None)}


def data(n_fid):
    sizes, d, _ = CONFIGS[n_fid]
    rng = np.random.default_rng(3)
    Xs = [rng.uniform(0, 1, (n, d)) for n in sizes]
    f0 = lambda x: np.sin(6 * x[:, :1])
    Ys = [f0(Xs[0])] + [f0(x) ** 2 + 0.1 * t * x[:, :1]
                        for t, x in enumerate(Xs[1:], 1)]
    return Xs, Ys


def new_points(n_fid):
    return np.random.default_rng(11).uniform(0, 1, (M_NEW, CONFIGS[n_fid][1]))


@functools.lru_cache(maxsize=None)
def reference_model(n_fid):
    """dgp_tpu's model at its canonical init (its constructor's eager ops
    run once)."""
    return jnargp.NARGP(data(n_fid), n_bucket=CONFIGS[n_fid][2])


def off_init(params):
    leaves, treedef = jax.tree.flatten(params)
    return jax.tree.unflatten(
        treedef, [x + 0.1 * (i % 5 + 1) * (-1) ** i
                  for i, x in enumerate(leaves)])


def with_params(ref, params):
    """A shallow copy of ``ref`` under ``params`` (its train_data then
    recomputes the mean chain)."""
    out = copy.copy(ref)
    out.params = params
    return out


def draws(key, n_fid, fidelity):
    """The unit normals dgp_tpu's predict_f draws, in its order: level 1's
    sample from ``key``, then each later level's below ``fidelity`` from
    fold_in(key, t) (folded in turn)."""
    out = [jax.random.normal(key, (S, M_NEW, 1), jnp.float64)]
    for t in range(1, fidelity % n_fid):
        key = jax.random.fold_in(key, t)
        out.append(jax.random.normal(key, (S, M_NEW, 1), jnp.float64))
    return out


def outputs_program(n_fid):
    """dgp_tpu's model off its init: its parameters, augmented train_data,
    per-level NLLs and their gradients at that data, and predict_f at
    every fidelity with the normals it draws."""
    ref = reference_model(n_fid)

    def outputs(Xnew, key):
        params = off_init(ref.params)
        datas = with_params(ref, params).train_data

        def total(ps):
            # level t's NLL reaches only params[t] (the data held fixed),
            # so the sum's gradient holds each level's own
            losses = jnp.stack([jgpr.neg_log_marginal_likelihood(p, *d)
                                for p, d in zip(ps, datas)])
            return jnp.sum(losses), losses

        (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
        preds = [(jnargp.predict_f(params, datas, Xnew, key, S, t),
                  draws(key, n_fid, t)) for t in range(n_fid)]
        return params, datas, losses, grads, preds

    return outputs, (new_points(n_fid), jax.random.PRNGKey(5))


def engine_program():
    """The reference's own three stacked starts of level 1 (its _starts)
    and its engine's 20 steps on them, on the 2-level model's augmented
    level-1 data."""
    ref = reference_model(2)
    run = multistart_adam_engine(jgpr.neg_log_marginal_likelihood, 20, 0.05)

    def engine(key):
        params = off_init(ref.params)
        datas = with_params(ref, params).train_data
        stacked = ref._starts(params[1], 3, key)
        return (stacked,) + run(stacked, datas[1])

    return engine, (jax.random.PRNGKey(1),)


@functools.lru_cache(maxsize=None)
def programs():
    """The three reference programs' outputs, each traced in turn and
    compiled in a thread of its own while the next is traced (XLA compiles
    a program on one core and releases the GIL)."""
    calls = {"engine": engine_program(), 3: outputs_program(3),
             2: outputs_program(2)}
    with ThreadPoolExecutor(3) as pool:
        compiled = {name: pool.submit(jax.jit(fn).lower(*args).compile)
                    for name, (fn, args) in calls.items()}
        return {name: c.result()(*calls[name][1])
                for name, c in compiled.items()}


def port_model(n_fid, n_bucket="config"):
    """The port's model carrying the reference's off-init parameters."""
    _, d, bucket = CONFIGS[n_fid]
    port = tnargp.NARGP(data(n_fid), n_bucket=bucket if n_bucket == "config"
                        else n_bucket, device="cpu", dtype=F64)
    port.params = convert.nargp_from_numpy(
        convert.numpy_tree_from_reference(programs()[n_fid][0]), "cpu", F64)
    return port


def test_constructor_and_convert_round_trip():
    """The port's wrapper builds the per-level parameters dgp_tpu's builds
    (level 1 the composite k_rho(x) k_f(f) + k_delta(x) with its active
    dimensions), and the tree survives the round trip."""
    port = tnargp.NARGP(data(2), n_bucket=8, device="cpu", dtype=F64)
    tree = convert.numpy_tree_from_reference(reference_model(2).params)
    got = convert.numpy_tree_from_port(port.params)
    assert_trees_close(got, tree, 1e-15)
    sum_tree = got["levels"][1]["kernel"]
    assert sum_tree["type"] == "Sum"
    assert [k["active_dims"] for k in sum_tree["kernels"][0]["kernels"]] == \
        [[0, 1], [2]]
    back = convert.nargp_from_numpy(tree, "cpu", F64)
    assert_trees_close(convert.numpy_tree_from_port(back), tree, 0.0)
    with pytest.raises(ValueError, match="fidelities"):
        tnargp.NARGP(([np.zeros((3, 1))], [np.zeros((3, 1))]), device="cpu")


@pytest.mark.parametrize("n_fid", [2, 3])
def test_train_data_is_the_reference_mean_chain(n_fid):
    """The augmented, padded train_data (the mean chain of the levels below
    beside each level's inputs; padding rows repeat row 0) to 1e-10."""
    port = port_model(n_fid)
    want = programs()[n_fid][1]
    for got_level, want_level in zip(port.train_data, want):
        for got, w in zip(got_level, want_level):
            if w is None:
                assert got is None
                continue
            assert got.shape == w.shape
            assert_close(got, w, 1e-10)


@pytest.mark.parametrize("n_fid", [2, 3])
def test_nll_and_gradients_match_reference(n_fid):
    """Each level's NLL to 1e-10 and every leaf of its gradient to 1e-8 of
    the leaf's scale; training_loss is their sum."""
    port = port_model(n_fid)
    _, _, losses, grads, _ = programs()[n_fid]
    assert_close(port.training_loss(), np.sum(np.asarray(losses)), 1e-10)
    for t, (params, data) in enumerate(zip(port.params, port.train_data)):
        got = tgpr.neg_log_marginal_likelihood(params, *data)
        assert_close(got, losses[t], 1e-10)
        g = torch.autograd.grad(got, list(params.parameters()))
        as_tree = copy.deepcopy(params)
        with torch.no_grad():
            for p, gi in zip(as_tree.parameters(), g):
                p.copy_(gi)
        assert_trees_close(convert.numpy_tree_from_port(as_tree),
                           convert.numpy_tree_from_reference(grads[t]),
                           1e-8)


@pytest.mark.parametrize("n_fid", [2, 3])
def test_predict_f_on_reference_normals(n_fid):
    """predict_f's moments at every fidelity on the reference's own normals
    to 1e-10: [1, m, 1] exact at fidelity 0, [S, m, 1] above it; the
    wrapper's too (fidelity None the highest)."""
    port = port_model(n_fid)
    Xnew = new_points(n_fid)
    for t, ((mean, var), noise) in enumerate(programs()[n_fid][4]):
        noise = [np.array(z) for z in noise]
        with torch.no_grad():
            got = tnargp.predict_f(port.params, port.train_data,
                                   torch.tensor(Xnew), S, t, noise=noise)
        shape = (1 if t == 0 else S, M_NEW, 1)
        for g, w in zip(got, (mean, var)):
            assert g.shape == w.shape == shape
            assert_close(g, w, 1e-10)
    got = port.predict_f(Xnew, S=S, noise=noise)
    assert_close(got[0], mean, 1e-10)
    assert_close(got[1], var, 1e-10)


def test_level0_matches_plain_gpr():
    """Fidelity 0 is the exact single-level GPR posterior, and the
    predictive adds level 0's noise."""
    Xs, Ys = data(2)
    port = tnargp.NARGP((Xs, Ys), device="cpu", dtype=F64)
    g = tgpr.GPR((Xs[0], Ys[0]),
                 TK.RBF.create(lengthscales=[0.5, 0.5], dtype=F64),
                 noise_variance=1e-4, device="cpu", dtype=F64)
    Xt = new_points(2)
    m0, v0 = port.predict_f(Xt, S=5, fidelity=0)
    mg, vg = g.predict_f(Xt)
    assert m0.shape == v0.shape == (1, M_NEW, 1)
    torch.testing.assert_close(m0[0], mg, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(v0[0], vg, rtol=1e-12, atol=1e-12)
    my, vy = port.predict_y(Xt, 5, fidelity=0)
    torch.testing.assert_close(vy[0], vg + 1e-4, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(my[0], mg, rtol=0, atol=0)


def test_bucket_padding_is_exactly_decoupled():
    """Same parameters, padded and unpadded: equal predictions on the same
    normals, and the padded NLL apart from the unpadded one by a constant
    that moving the parameters does not change."""
    padded, raw = port_model(2, 8), port_model(2, None)
    assert padded.train_data[1][0].shape == (8, 3)
    assert raw.train_data[1][2] is None
    Xt = new_points(2)
    gen = lambda: torch.Generator().manual_seed(7)
    for a, b in zip(padded.predict_f(Xt, S=S, generator=gen()),
                    raw.predict_f(Xt, S=S, generator=gen())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)
    gap = lambda: float(padded.training_loss().detach()
                        - raw.training_loss().detach())
    c0 = gap()
    for m in (padded, raw):
        params = copy.deepcopy(m.params)
        with torch.no_grad():
            for p in params.parameters():
                p += 0.3
        m.params = params
    np.testing.assert_allclose(gap(), c0, rtol=0, atol=1e-8)


def test_setters_invalidate_the_cached_train_data():
    """train_data is computed once per params or data assignment: assigning
    params recomputes the same chain, assigning data (a believer's fantasy
    row) recomputes it on the new rows."""
    port = port_model(2)
    td = port.train_data
    assert port.train_data is td
    port.params = port.params
    td2 = port.train_data
    assert td2 is not td
    for a, b in zip(td, td2):
        assert torch.equal(a[0], b[0])
    Xs, Ys = port.data
    port.data = (Xs[:1] + (torch.cat([Xs[1], Xs[1][:1] * 0.5]),),
                 Ys[:1] + (torch.cat([Ys[1], Ys[1][:1]]),))
    td3 = port.train_data
    assert td3 is not td2 and port.train_data is td3
    assert td3[1][0].shape == (8, 3) and float(td3[1][2].sum()) == 6.0


def test_engine_matches_reference_on_its_starts():
    """Level 1's composite kernel through training.multistart_adam on the
    reference's own stacked starts: the winner's loss trace to 1e-8
    relative, the same final NLL and the winner's parameters to 1e-8."""
    stacked, best, nll, losses = programs()["engine"]
    port = port_model(2)
    port_stacked = convert.gpr_from_numpy(
        convert.numpy_tree_from_reference(stacked), "cpu", F64)
    with torch.no_grad():
        initial = tgpr.neg_log_marginal_likelihood(
            port_stacked, *port.train_data[1]).numpy()
    got, got_nll, trace = training.multistart_adam(
        tgpr.neg_log_marginal_likelihood, port_stacked, port.train_data[1],
        20, 0.05)
    assert initial.shape == (3,) and trace.shape == (20,)
    assert_close(trace, losses, 1e-8)
    assert float(got_nll) == pytest.approx(float(nll), rel=1e-8)
    assert_trees_close(convert.numpy_tree_from_port(got),
                       convert.numpy_tree_from_reference(best), 1e-8)
    # the same winner: the start whose initial loss opens both traces
    gaps = np.abs(initial - float(losses[0])) / abs(float(losses[0]))
    assert np.sum(gaps < 1e-8) == 1


def test_optimize_trains_level_by_level(monkeypatch):
    """optimize(): one batched engine run per level (level 1 on the mean
    chain of the freshly trained level 0), the traces per level, the joint
    NLL in _nll, and the cache seeded with the data it trained on."""
    port = port_model(2)
    seen = []
    run = training.multistart_adam

    def spy(loss_fn, stacked, batch, iterations, lr):
        seen.append((next(stacked.parameters()).shape[0], batch[0].shape))
        return run(loss_fn, stacked, batch, iterations, lr)

    monkeypatch.setattr(training, "multistart_adam", spy)
    traces = port.optimize(n_starts=3, iterations=15, lr=0.05, seed=2)
    assert seen == [(3, (16, 2)), (3, (8, 3))]
    assert [t.shape for t in traces] == [(15,), (15,)]
    assert all(bool(torch.isfinite(t).all()) for t in traces)
    cached = port.train_data
    assert port._nll == pytest.approx(float(port.training_loss().detach()),
                                      rel=1e-10)
    port.params = port.params
    for a, b in zip(cached, port.train_data):
        torch.testing.assert_close(a[0], b[0], rtol=1e-12, atol=1e-12)
