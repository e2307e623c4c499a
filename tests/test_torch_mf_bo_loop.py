"""The port's multi-fidelity BO loop (``dgp_tpu_torch/bo/mf_bo.py``) on CPU
tensors in float64, at tiny budgets (AR(1): 2 starts x 30 Adam steps, DE
15 x 15; the variational forms: 3 samples, schedule (20, 10, 10)): the
invariants ``tests/test_mf_bo.py`` holds ``dgp_tpu``'s loop to. The two
packages draw other random numbers, so the trajectories themselves differ
and are not compared; ``test_torch_mf_bo.py`` holds MF_BO's steps to
``dgp_tpu`` one by one. No JAX here."""

import numpy as np
import pytest
import torch
# the first torch.optim.Adam imports torch._dynamo (~1.5 s): import it with
# the rest
import torch._dynamo  # noqa: F401

from dgp_tpu_torch.bo.mf_bo import DEFAULT_MODEL_DIC, MF_BO
from dgp_tpu_torch.utils.test_functions import forrester_high, forrester_low

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

ON_CPU = dict(device="cpu", dtype=torch.float64)
FIDS = [forrester_low, forrester_high]
AR1 = {"type": "ar1", "n_starts": 2, "iterations": 30}
VARIATIONAL = {"num_samples": 3, "schedule": (20, 10, 10)}
RUN = dict(popsize_DE=15, iterations_DE=15, num_samples=15)
# the constraint GPRs' spec: 50 Adam steps (2,000 by default)
CON_SPEC = {"kernels": "rbf", "iterations": 50}


def loop(model_dic=AR1, fidelities=FIDS, DoE_sizes=(6, 3), seed=0, **kw):
    return MF_BO(fidelities=fidelities, DoE_sizes=DoE_sizes, d=1,
                 model_dic=model_dic, seed=seed, **kw, **ON_CPU)


def evaluate(X, fids, fidelities=FIDS):
    return np.vstack([np.asarray(fidelities[f](X[i:i + 1]),
                                 dtype=float).reshape(1, 1)
                      for i, f in enumerate(fids)])


def ring_con(x):
    """Feasible iff x >= 0.55 (the Forrester optimum x* = 0.757 stays)."""
    return 0.55 - np.asarray(x)[:, 0]


def assert_accounts(bo, n0, trace, infills):
    """Only the chosen fidelities' archives grew, the cost is the sum of
    their costs, the best trace never rises, every query is in the box."""
    assert len(trace) == infills + 1 == len(bo.cost_trace)
    assert len(bo.fidelity_choices) == infills
    for f in range(bo.n_fid):
        assert len(bo.X[f]) == len(bo.Y[f]) == n0[f] + \
            bo.fidelity_choices.count(f)
        assert np.all((bo.X[f] >= 0) & (bo.X[f] <= 1))
    assert all(np.isfinite(trace))
    assert all(b <= a + 1e-12 for a, b in zip(trace, trace[1:]))
    assert bo.cost_spent == pytest.approx(
        sum(bo.costs[f] for f in bo.fidelity_choices))
    assert bo.cost_trace[-1] == pytest.approx(bo.cost_spent)


def test_loop_runs_and_accounts():
    bo = loop(DoE_sizes=(8, 4))
    assert bo.n_fid == 2 and bo.costs == [0.1, 1.0]
    n0 = [len(x) for x in bo.X]
    trace = bo.run(2, verbose=False, **RUN)
    assert_accounts(bo, n0, trace, 2)


def test_fidelity_rule_extremes():
    """gamma = 0 with the guard off queries the lowest fidelity, and a
    low-fidelity query leaves the best trace; gamma = 1e9 the highest."""
    lo = loop(gamma=0.0, dup_tol=0.0, seed=1)
    lo.run(2, verbose=False, **RUN)
    assert lo.fidelity_choices == [0, 0]
    assert lo.cost_spent == pytest.approx(0.2)
    assert lo.best_trace[-1] == lo.best_trace[0]
    hi = loop(gamma=1e9, seed=1)
    hi.run(1, verbose=False, **RUN)
    assert hi.fidelity_choices == [1]


def trained_ar1(bo):
    Ys_n, _, _ = bo._normalized_Y()
    m = bo.make_model(Ys_n, seed=0)
    m.optimize(n_starts=2, iterations=30, seed=0)
    return m


def fresh_point(bo):
    """The middle of the widest gap between the low-fidelity rows."""
    xs = np.sort(bo.X[0].ravel())
    gaps = np.diff(xs)
    return np.array([[xs[int(np.argmax(gaps))] + gaps.max() / 2.0]])


def test_duplicate_escalation_and_pending_queries():
    """At gamma = 0 a point already in the low-fidelity archive (or pending
    there) escalates to fidelity 1; a fresh point stays at 0."""
    bo = loop(gamma=0.0, seed=5)
    m = trained_ar1(bo)
    assert bo._select_fidelity(m, bo.X[0][2:3] + 1e-5) == 1
    x = fresh_point(bo)
    assert bo._select_fidelity(m, x) == 0
    assert bo._select_fidelity(m, x + 1e-5, extra_queries=[(x, 0)]) == 1
    assert bo._select_fidelity(m, x, extra_queries=[(x, 1)]) == 0


def test_three_fidelity_loop():
    def mid(x):
        return 0.5 * (forrester_low(x) + forrester_high(x))

    bo = loop(fidelities=[forrester_low, mid, forrester_high],
              DoE_sizes=(8, 5, 3))
    assert bo.costs == [0.01, 0.1, 1.0]
    n0 = [len(x) for x in bo.X]
    trace = bo.run(2, verbose=False, **RUN)
    assert_accounts(bo, n0, trace, 2)


def test_suggest_observe_equals_run():
    """suggest() + observe() with the values computed outside reproduce
    run()'s trajectory bit for bit: the same seed stream, infill counter
    and bookkeeping."""
    bo1 = loop(DoE_sizes=(8, 4), seed=3)
    bo1.run(2, verbose=False, **RUN)
    bo2 = loop(DoE_sizes=(8, 4), seed=3)
    for _ in range(2):
        x, f = bo2.suggest(**RUN, verbose=False)
        assert x.shape == (1, 1) and f in (0, 1)
        bo2.observe(x, evaluate(x, [f]), f)
    for f in range(2):
        np.testing.assert_array_equal(bo1.X[f], bo2.X[f])
        np.testing.assert_array_equal(bo1.Y[f], bo2.Y[f])
    assert bo1.fidelity_choices == bo2.fidelity_choices
    assert bo1.best_trace == bo2.best_trace
    assert torch.equal(bo1._run_gen.get_state(), bo2._run_gen.get_state())


def test_save_load_resumes_exactly(tmp_path):
    """save() mid-run and load(): the next infill of both equal (archives,
    traces, seed stream, settings)."""
    bo = loop(seed=3, dup_tol=2e-3)
    bo.run(1, verbose=False, **RUN)
    path = str(tmp_path / "mf_bo.npz")
    bo.save(path)
    bo2 = MF_BO.load(path, FIDS, **ON_CPU)
    assert bo2.model_dic == bo.model_dic and bo2.dup_tol == 2e-3
    assert bo2.best_trace == bo.best_trace
    assert all(np.array_equal(a, b) for a, b in zip(bo2._Z0, bo._Z0))
    assert torch.equal(bo2._run_gen.get_state(), bo._run_gen.get_state())
    for b in (bo, bo2):
        b.run(1, verbose=False, **RUN)
    for f in range(2):
        np.testing.assert_array_equal(bo2.X[f], bo.X[f])
    assert bo2.best_trace == bo.best_trace
    assert bo2.cost_trace == bo.cost_trace
    assert bo2.fidelity_choices == bo.fidelity_choices
    assert bo2._iteration == bo._iteration == 2


def test_pending_points_survive_save_load(tmp_path):
    bo = loop(seed=4)
    x1, f1 = bo.suggest(**RUN)
    path = str(tmp_path / "mf_pending.npz")
    bo.save(path)
    bo2 = MF_BO.load(path, FIDS, **ON_CPU)
    np.testing.assert_array_equal(bo2.pending_X, x1)
    np.testing.assert_array_equal(bo2.pending_f, [f1])
    # the loaded loop conditions on the pending lie: the surrogate's data
    # holds one more row at the pending fidelity than the archive
    bo2.suggest(**RUN)
    Xs, _ = bo2._bstate["model"].data
    assert Xs[int(f1)].shape[0] == len(bo2.X[int(f1)]) + 1
    assert bo2.pending_X.shape == (2, 1)
    bo2.clear_pending()
    assert bo2.pending_X.shape == (0, 1) and bo2._bstate is None


def test_constrained_load_never_evaluates_the_constraint(tmp_path):
    calls = []

    def counted(x):
        calls.append(len(x))
        return ring_con(x)

    bo = loop(constraints=[counted], model_C_dic=CON_SPEC, seed=2)
    n_init = len(calls)
    assert n_init == 2   # once per fidelity's DoE
    path = str(tmp_path / "mf_con.npz")
    bo.save(path)
    bo2 = MF_BO.load(path, FIDS, constraints=[counted], **ON_CPU)
    assert len(calls) == n_init
    assert all(np.array_equal(a, b) for a, b in zip(bo2.C, bo.C))
    assert bo2.best_trace == bo.best_trace


def test_batch_lies_never_reach_the_archives():
    """A batch of 2 with believer lies: every archive row is a real
    evaluation, the picks differ, and one round is one infill."""
    bo = loop(seed=1)
    n0 = [len(x) for x in bo.X]
    bo.run(1, batch_size=2, verbose=False, **RUN)
    assert bo._iteration == 1 and len(bo.fidelity_choices) == 2
    assert sum(len(bo.X[f]) - n0[f] for f in range(2)) == 2
    for f in range(2):
        np.testing.assert_allclose(bo.Y[f], FIDS[f](bo.X[f]), atol=1e-12)
    new = np.vstack([bo.X[f][n0[f]:] for f in range(2)])
    assert abs(float(new[0, 0] - new[1, 0])) > 1e-6


def test_async_suggests_match_a_batch_infill():
    """suggest(1); suggest(1); observe(both) walks the batch_size=2
    trajectory exactly."""
    bo1 = loop(seed=7)
    Xb, fb = bo1.suggest(batch_size=2, **RUN)
    bo1.observe(Xb, evaluate(Xb, fb), fb)
    bo2 = loop(seed=7)
    xa, fa = bo2.suggest(**RUN)
    assert bo2.pending_X.shape == (1, 1)
    xc, fc = bo2.suggest(**RUN)
    Xa = np.vstack([xa, xc])
    bo2.observe(Xa, evaluate(Xa, [fa, fc]), [fa, fc])
    np.testing.assert_array_equal(Xb, Xa)
    assert list(fb) == [fa, fc]
    assert all(np.array_equal(a, b) for a, b in zip(bo1.X, bo2.X))
    assert torch.equal(bo1._run_gen.get_state(), bo2._run_gen.get_state())
    assert bo1.pending_X.shape == bo2.pending_X.shape == (0, 1)
    assert bo1._iteration == bo2._iteration == 1


@pytest.mark.parametrize("handling", ["PoF", "EV"])
def test_constrained_loop(handling):
    """The best trace tracks only feasible top-fidelity values; the
    constraint archives stay aligned with the inputs."""
    bo = loop(constraints=[ring_con], model_C_dic=CON_SPEC, DoE_sizes=(8, 4))
    n0 = [len(x) for x in bo.X]
    trace = bo.run(2, constraint_handling=handling, verbose=False, **RUN)
    assert_accounts(bo, n0, trace, 2)
    feas = bo.C[-1].max(axis=1) <= 0
    if feas.any():
        assert trace[-1] == pytest.approx(float(bo.Y[-1][feas].min()))
    for f in range(2):
        np.testing.assert_array_equal(bo.C[f], ring_con(bo.X[f])[:, None])
    assert float(bo.x_best[0]) >= 0.55 or not feas.any()


def test_x_best_is_feasible():
    X = [np.asarray([[0.1], [0.4], [0.6], [0.9]]),
         np.asarray([[0.2], [0.5], [0.8]])]
    Y = [forrester_low(X[0]), np.asarray([[3.0], [-1.0], [2.0]])]
    bo = MF_BO(fidelities=FIDS, X=X, Y=Y, constraints=[ring_con], seed=0,
               **ON_CPU)
    # the unconstrained argmin (y = -1 at x = 0.5) is infeasible
    assert float(bo.x_best[0]) == pytest.approx(0.8)
    assert bo.best_trace[0] == pytest.approx(2.0)


def park_vd_low(x2d):
    x = np.asarray(x2d, dtype=float)
    return (np.sin(3.0 * x[:, :1]) + 0.5 * x[:, 1:2]).reshape(-1, 1)


def park_vd_high(x4d):
    x = np.asarray(x4d, dtype=float)
    return (np.sin(3.0 * x[:, :1]) + 0.5 * x[:, 1:2]
            + 0.25 * x[:, 2:3] * x[:, 3:4]).reshape(-1, 1)


def test_em_surrogate_on_variant_dimensions():
    """{'type': 'em'}: a 2-D low and a 4-D high fidelity; the low one is
    queried through the projection."""
    rng = np.random.default_rng(0)
    X = [rng.uniform(0, 1, (10, 2)), rng.uniform(0, 1, (5, 4))]
    bo = MF_BO(fidelities=[park_vd_low, park_vd_high], X=X,
               Y=[park_vd_low(X[0]), park_vd_high(X[1])],
               model_dic={"type": "em", "num_samples": 3,
                          "schedule": (15, 5, 10)},
               projections=[lambda x: np.asarray(x)[:, :2]], seed=0,
               gamma=0.05, **ON_CPU)
    assert bo.d == 4
    n0 = [len(x) for x in bo.X]
    trace = bo.run(1, popsize_DE=12, iterations_DE=10, num_samples=8,
                   verbose=False)
    for f, dim in ((0, 2), (1, 4)):
        assert bo.X[f].shape[1] == dim
        assert len(bo.X[f]) == n0[f] + bo.fidelity_choices.count(f)
    assert len(trace) == 2 and all(np.isfinite(trace))


@pytest.mark.parametrize("case", ["variant dims", "constraints", "3 fidelities",
                                  "no projections"])
def test_em_validation(case):
    rng = np.random.default_rng(1)
    X = [rng.uniform(0, 1, (6, 2)), rng.uniform(0, 1, (3, 4))]
    kw = dict(fidelities=[park_vd_low, park_vd_high], X=X,
              Y=[np.zeros((6, 1)), np.zeros((3, 1))], seed=0, **ON_CPU)
    if case == "variant dims":
        with pytest.raises(ValueError, match="'em'"):
            MF_BO(model_dic={"type": "ar1"}, **kw)
    elif case == "constraints":
        with pytest.raises(ValueError, match="constraints"):
            MF_BO(model_dic={"type": "em"},
                  constraints=[lambda x: -np.ones(len(x))],
                  projections=[lambda x: np.asarray(x)[:, :2]], **kw)
    elif case == "3 fidelities":
        with pytest.raises(ValueError, match="exactly 2 fidelities"):
            loop({"type": "em"}, fidelities=FIDS + [forrester_high],
                 DoE_sizes=(6, 4, 3))
    else:
        bo = MF_BO(model_dic={"type": "em"}, **kw)
        Ys_n, _, _ = bo._normalized_Y()
        with pytest.raises(ValueError, match="projections"):
            bo.make_model(Ys_n, seed=0)


def test_mf_dgp_loop_and_warm_lie():
    """The MF-DGP surrogate: suggest() fits it; a lie's warm refit starts
    from the trained parameters (the staged trainer would re-initialize q
    and shrink q_sqrt ~100x), so q_sqrt keeps its scale, and the lie row
    lands in the surrogate's data only; then the observation accounts."""
    bo = loop(VARIATIONAL, DoE_sizes=(8, 4))
    n0 = [len(x) for x in bo.X]
    x, f = bo.suggest(verbose=False, **RUN)
    st = bo._bstate
    layer = st["model"].params.layers[0]
    q0 = float(torch.linalg.norm(layer.q_sqrt.detach()))
    q_mu = layer.q_mu.detach().clone()
    bo._lie_at(st, np.asarray([[0.4]]), 1, "believer", lie_train_iterations=2)
    q1 = float(torch.linalg.norm(layer.q_sqrt.detach()))
    assert q1 > 0.5 * q0, (q0, q1)
    assert not torch.equal(layer.q_mu, q_mu)   # the refit ran
    assert st["model"]._X[1].shape[0] == len(bo.X[1]) + 1
    bo.observe(x, evaluate(x, [f]), f)
    assert_accounts(bo, n0, bo.best_trace, 1)
    assert bo._bstate is None and len(bo.pending_X) == 0


def test_resolve_pending_is_fidelity_aware():
    """One x pending at two fidelities: an observation pops only its own
    (row, fidelity) entry."""
    bo = loop()
    bo.pending_X = np.asarray([[0.5], [0.5]])
    bo.pending_f = np.asarray([0, 1])
    bo.observe(np.asarray([[0.5]]), np.asarray([[1.0]]), 1)
    assert bo.pending_X.shape == (1, 1) and list(bo.pending_f) == [0]


@pytest.mark.parametrize("IC", ["WB2", "WB2S"])
def test_wb2_criteria_with_the_ar1_surrogate(IC):
    bo = loop(seed=5)
    x, f = bo.suggest(IC=IC, popsize_DE=12, iterations_DE=10, num_samples=8)
    assert x.shape == (1, 1) and 0.0 <= x.item() <= 1.0 and f in (0, 1)
    assert type(bo._bstate["ic"]).__name__ == IC
    with pytest.raises(ValueError, match="unknown IC"):
        bo.suggest(IC="LCB", **RUN)


def test_default_surrogate_and_device_rule(monkeypatch):
    """The default is the exact AR(1) form; with no card and no device,
    construction raises instead of running on the CPU."""
    assert DEFAULT_MODEL_DIC["type"] == "ar1"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MF_BO(fidelities=FIDS, DoE_sizes=(6, 3), d=1, seed=0)
    bo = MF_BO(fidelities=FIDS, DoE_sizes=(6, 3), d=1, seed=0, device="cpu")
    assert bo.device == torch.device("cpu") and bo.dtype == torch.float32
