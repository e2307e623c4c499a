"""Port parity: exact AR(1) co-kriging (``dgp_tpu_torch/models/cokriging.py``)
and the multi-start Adam engine (``training.multistart_adam``) against
``dgp_tpu`` in float64 on CPU, on the same numpy data and parameters
(``convert.numpy_tree_from_reference`` / ``ar1_from_numpy``): the joint
NLL to 1e-10 and its gradient to 1e-8 (relative), the posterior and the
predictive at every fidelity to 1e-10, at 2 fidelities (bucket-padded) and
3 (the three-fidelity oracle of ``tests/test_cokriging.py``); padded equal
to unpadded; and the engine fed the reference's own stacked starts: loss
trace to 1e-8 relative, the same winner, its parameters to 1e-8. Each
reference configuration runs as one jitted program (its eager ops would
compile one by one)."""

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

from dgp_tpu.models import cokriging as jar1
from dgp_tpu.models.training import multistart_adam_engine
from dgp_tpu_torch import convert
from dgp_tpu_torch.config import jitter_scope
from dgp_tpu_torch.models import cokriging as tar1
from dgp_tpu_torch.models import training

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64

# (rows per fidelity, input dimensions, n_bucket)
CONFIGS = {2: ((7, 4), 2, 8), 3: ((6, 4, 3), 1, None)}


def data(sizes, d, seed=7):
    rng = np.random.default_rng(seed)
    Xs = [rng.uniform(0, 1, (n, d)) for n in sizes]
    Ys = [rng.normal(size=(n, 1)) for n in sizes]
    return Xs, Ys


def off_init(params):
    """The parameters moved off the canonical init (rho off 1, each leaf
    its own shift)."""
    leaves, treedef = jax.tree.flatten(params)
    return jax.tree.unflatten(
        treedef, [x + 0.15 * (i + 1) * (-1) ** i for i, x in enumerate(leaves)])


@functools.lru_cache(maxsize=None)
def reference_model(n_fid, bucket):
    """dgp_tpu's model at its canonical init (its constructor's eager ops
    run once)."""
    sizes, d, _ = CONFIGS[n_fid]
    return jar1.AR1CoKriging(data(sizes, d), n_bucket=bucket)


def new_points(n_fid):
    return np.random.default_rng(11).uniform(0, 1, (5, CONFIGS[n_fid][1]))


def outputs_program(n_fid):
    """dgp_tpu's model off its init: its parameters, padded data, NLL, the
    NLL's gradient, and predict_f and predict_y at every fidelity
    (predict_y as the reference's own, the fidelity's likelihood on
    predict_f: a second joint Gram per fidelity would double the trace)."""
    ref = reference_model(n_fid, CONFIGS[n_fid][2])

    def outputs(Xnew):
        params, data = off_init(ref.params), ref.train_data
        loss, grad = jax.value_and_grad(jar1.neg_log_marginal_likelihood)(
            params, *data)
        preds = []
        for t in range(n_fid):
            pf = jar1.predict_f(params, data, Xnew, t)
            preds.append((pf, params.likelihoods[t].predict_mean_and_var(*pf)))
        return params, data, loss, grad, preds

    return outputs, (new_points(n_fid),)


def engine_program():
    """The reference's own three stacked starts (its _starts) and its
    engine's 20 steps on them, at the smallest shape."""
    ref = reference_model(2, CONFIGS[2][2])
    run = multistart_adam_engine(jar1.neg_log_marginal_likelihood, 20, 0.05)

    def engine(key):
        stacked = ref._starts(3, key)
        return (stacked,) + run(stacked, ref.train_data)

    return engine, (jax.random.PRNGKey(0),)


@functools.lru_cache(maxsize=None)
def programs():
    """The three reference programs' outputs, each program traced in turn
    (the engine's, whose compile is the longest, first) and compiled in a
    thread of its own while the next is traced (XLA compiles a program on
    one core and releases the GIL)."""
    calls = {"engine": engine_program(), 3: outputs_program(3),
             2: outputs_program(2)}
    with ThreadPoolExecutor(3) as pool:
        compiled = {name: pool.submit(jax.jit(fn).lower(*args).compile)
                    for name, (fn, args) in calls.items()}
        return {name: c.result()(*calls[name][1])
                for name, c in compiled.items()}


def reference(n_fid):
    """(NLL, gradient, [(predict_f, predict_y) per fidelity]) of dgp_tpu."""
    return programs()[n_fid][2:]


def models(n_fid, n_bucket="config"):
    """The same AR(1) model in both packages, off its init: dgp_tpu's
    parameters and padded data, and the port carrying those parameters."""
    sizes, d, bucket = CONFIGS[n_fid]
    params, ref_data = programs()[n_fid][:2]
    port = tar1.AR1CoKriging(data(sizes, d),
                             n_bucket=bucket if n_bucket == "config"
                             else n_bucket,
                             device="cpu", dtype=F64)
    port.params = convert.ar1_from_numpy(
        convert.numpy_tree_from_reference(params), "cpu", F64)
    return ref_data, port


def assert_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def leaves(tree, prefix=""):
    """(path, array) of a convert tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from leaves(t, f"{prefix}.{i}")
    elif isinstance(tree, np.ndarray):
        yield prefix, tree


def assert_trees_close(got, want, rtol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], rtol)


def grad_tree(params, grads):
    """The convert tree of ``params`` with each value replaced by its
    gradient."""
    out = convert.ar1_from_numpy(convert.numpy_tree_from_port(params), "cpu",
                                 F64)
    with torch.no_grad():
        for p, g in zip(out.parameters(), grads):
            p.copy_(g)
    return convert.numpy_tree_from_port(out)


def test_constructor_and_convert_round_trip():
    """The port's wrapper builds the parameters and padded data dgp_tpu's
    builds from the same arguments, and the tree survives the round
    trip."""
    sizes, d, bucket = CONFIGS[2]
    port = tar1.AR1CoKriging(data(sizes, d), n_bucket=bucket, device="cpu",
                             dtype=F64)
    tree = convert.numpy_tree_from_reference(reference_model(2, bucket).params)
    assert_trees_close(convert.numpy_tree_from_port(port.params), tree, 1e-15)
    back = convert.ar1_from_numpy(tree, "cpu", F64)
    assert_trees_close(convert.numpy_tree_from_port(back), tree, 0.0)
    ref_data, _ = models(2)
    for want, got in zip(ref_data, port.train_data):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="fidelities"):
        tar1.AR1CoKriging(([np.zeros((3, 1))], [np.zeros((3, 1))]),
                          device="cpu")


@pytest.mark.parametrize("n_fid", [2, 3])
def test_nll_and_gradient_match_reference(n_fid):
    """The joint NLL to 1e-10 and every leaf of its gradient to 1e-8 of the
    leaf's scale."""
    _, port = models(n_fid)
    loss, grad, _ = reference(n_fid)
    got = port.training_loss()
    assert got.dtype == F64 and got.shape == ()
    assert_close(got, loss, 1e-10)
    grads = torch.autograd.grad(got, list(port.params.parameters()))
    assert_trees_close(grad_tree(port.params, grads),
                       convert.numpy_tree_from_reference(grad), 1e-8)


@pytest.mark.parametrize("n_fid", [2, 3])
def test_predictions_match_reference(n_fid):
    """predict_f and predict_y at every fidelity to 1e-10, and the wrapper's
    [1, m, 1] moments (fidelity None the highest)."""
    _, port = models(n_fid)
    _, _, preds = reference(n_fid)
    Xnew = new_points(n_fid)
    for t, (pf, py) in enumerate(preds):
        for fn, want in ((tar1.predict_f, pf), (tar1.predict_y, py)):
            with torch.no_grad():
                got = fn(port.params, port.train_data, torch.tensor(Xnew), t)
            for g, w in zip(got, want):
                assert g.shape == w.shape == (5, 1)
                assert_close(g, w, 1e-10)
        mean, var = port.predict_f(Xnew, fidelity=t)
        assert mean.shape == var.shape == (1, 5, 1)
        assert_close(mean[0], pf[0], 1e-10)
        assert_close(var[0], pf[1], 1e-10)
    mean, var = port.predict_y(Xnew)
    assert_close(mean[0], preds[-1][1][0], 1e-10)
    assert_close(var[0], preds[-1][1][1], 1e-10)


def test_bucket_padding_is_exactly_decoupled():
    """Same parameters, padded and unpadded: equal posteriors at every
    fidelity, and NLLs apart by the padding's constant at two parameter
    points (tests/test_cokriging.py's oracle)."""
    _, padded = models(2, n_bucket=8)
    _, raw = models(2, n_bucket=None)
    n_rows = sum(x.shape[0] for x in raw.train_data[0])
    n_rows_b = sum(x.shape[0] for x in padded.train_data[0])
    assert (n_rows, n_rows_b) == (11, 16)
    Xnew = new_points(2)
    for t in range(2):
        for a, b in zip(padded.predict_f(Xnew, fidelity=t),
                        raw.predict_f(Xnew, fidelity=t)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-10)
    const = 0.5 * (n_rows_b - n_rows) * np.log(2 * np.pi)
    for _ in range(2):
        with torch.no_grad():
            gap = padded.training_loss() - raw.training_loss()
        assert float(gap) == pytest.approx(const, rel=1e-10)
        with torch.no_grad():
            for m in (padded, raw):
                for p in m.params.parameters():
                    p += 0.3


def engine_run():
    stacked, best, nll, losses = programs()["engine"]
    return stacked, best, float(nll), np.asarray(losses)


def test_engine_matches_reference_on_its_starts(monkeypatch):
    """optimize() on the reference's own stacked starts (a _starts that
    returns them): the winner's loss trace to 1e-8 relative, the same final
    NLL, and the winner's parameters to 1e-8; every start advanced by one
    batched loss per step."""
    stacked, best, nll, losses = engine_run()
    _, port = models(2)
    monkeypatch.setattr(port, "_starts", lambda n, seed: convert.ar1_from_numpy(
        convert.numpy_tree_from_reference(stacked), "cpu", F64))
    calls = []
    loss_fn = tar1.neg_log_marginal_likelihood

    def counted(params, *batch):
        out = loss_fn(params, *batch)
        calls.append(tuple(out.shape))
        return out

    monkeypatch.setattr(tar1, "neg_log_marginal_likelihood", counted)
    trace = port.optimize(n_starts=3, iterations=20, lr=0.05)
    assert calls == [(3,)] * 21      # 20 steps and the final evaluation
    assert trace.shape == (20,)
    assert_close(trace, losses, 1e-8)
    assert port._nll == pytest.approx(nll, rel=1e-8)
    assert port.params.rho.shape == (1,)
    assert_trees_close(convert.numpy_tree_from_port(port.params),
                       convert.numpy_tree_from_reference(best), 1e-8)
    # the same winner: the start whose initial loss opens both traces
    with torch.no_grad():
        initial = tar1.neg_log_marginal_likelihood(
            convert.ar1_from_numpy(convert.numpy_tree_from_reference(stacked),
                                   "cpu", F64), *port.train_data).numpy()
    gaps = np.abs(initial - losses[0]) / abs(losses[0])
    assert np.sum(gaps < 1e-8) == 1 and gaps[np.argmin(gaps)] < 1e-8


def stacked_starts(port, noises):
    """Starts of ``port`` stacked, start i with likelihood variances
    noises[i] (every other leaf the canonical init's)."""
    starts = []
    for noise in noises:
        tree = convert.numpy_tree_from_port(port.params)
        for lik in tree["likelihoods"]:
            lik["variance_raw"] = np.log(np.expm1(np.float64(noise)))
        starts.append(convert.ar1_from_numpy(tree, "cpu", F64))
    return training.stack_starts(starts)


def test_indefinite_start_gives_inf_and_loses():
    """Under a jitter of -0.5 a start with noise 1e-4 has an indefinite
    joint Gram: alone, the engine returns +inf for it (NaN through the
    Cholesky, never an exception); beside two positive definite starts it
    loses, and their trajectory and winner are bit for bit those of a run
    without it."""
    _, port = models(2)
    batch = port.train_data
    run = lambda noises: training.multistart_adam(
        tar1.neg_log_marginal_likelihood, stacked_starts(port, noises), batch,
        10, 0.05)
    with jitter_scope(-0.5):
        _, nll, trace = run([1e-4])
        assert nll == torch.inf and bool(torch.isnan(trace).all())
        good = run([2.0, 3.0])
        mixed = run([2.0, 1e-4, 3.0])
    assert bool(torch.isfinite(good[2]).all())
    assert torch.equal(mixed[1], good[1]) and torch.equal(mixed[2], good[2])
    for a, b in zip(mixed[0].parameters(), good[0].parameters()):
        assert torch.equal(a, b)


def test_starts_are_the_canonical_init_then_jittered():
    """_starts: start 0 is the model's parameters; the later starts differ
    in every leaf, rho drawn about {1, 2, 0.5, -1}; the same seed gives the
    same starts."""
    _, port = models(3)
    stacked = port._starts(5, seed=3)
    again = port._starts(5, seed=3)
    for (name, p), q, base in zip(stacked.named_parameters(),
                                  again.parameters(),
                                  port.params.parameters()):
        assert p.shape == (5,) + base.shape and torch.equal(p, q)
        assert torch.equal(p[0], base), name
        assert bool((p[1:] != base).all()), name
    assert float(stacked.rho[1:].detach().abs().max()) < 4.0
