"""The port's multi-objective BO loop (``dgp_tpu_torch/bo/mo_bo.py``) on CPU
tensors in float64, at tiny budgets (the GPR pair and the constraint GPRs:
20 Adam steps; the coupled MO-DGP: loop 1, 2 samples, schedule (5, 0, 0);
the DGP pair: (10, 5); DE 10 x 10, S 20): the invariants
``tests/test_mo_bo.py`` holds ``dgp_tpu``'s loop to. The two packages draw
other random numbers, so the trajectories differ and are not compared;
``test_torch_mo_bo.py`` holds MO_BO's steps to ``dgp_tpu`` one by one. No
JAX here."""

import functools
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
# the first torch.optim.Adam imports torch._dynamo (~1.5 s): import it with
# the rest
import torch._dynamo  # noqa: F401

from dgp_tpu_torch.bo import ehvi as tehvi
from dgp_tpu_torch.bo import mo_bo as mo_bo_mod
from dgp_tpu_torch.bo.mo_bo import DEFAULT_MODEL_DIC, MO_BO
from dgp_tpu_torch.bo.problems import get
from dgp_tpu_torch.bo.so_bo import _safe_std, make_single_model, normalize
from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

ON_CPU = dict(device="cpu", dtype=torch.float64)
GPR = {"type": "independent", "num_layers": 0, "kernels": "rbf",
       "iterations": 20}
CON = {"kernels": "rbf", "iterations": 20}
# restarts=1: at this schedule "auto" would escalate to best-of-4
COUPLED = {"loop": 1, "num_samples": 2, "schedule": (5, 0, 0),
           "restarts": 1}
RUN = dict(S=20, popsize_DE=10, iterations_DE=10, verbose=False)
ASK = {k: v for k, v in RUN.items() if k != "verbose"}


def loop(problem="multi_obj_1D_4", model_dic=GPR, **kw):
    kw.setdefault("model_C_dic", CON)
    return MO_BO(problem=get(problem), model_dic=model_dic, **kw, **ON_CPU)


def objectives(problem, X):
    return [np.asarray([np.reshape(problem.fun(x)[i], ()) for x in X])
            for i in (0, 1)]


def monotone(trace):
    return all(b >= a - 1e-12 for a, b in zip(trace, trace[1:]))


def in_box(bo):
    return all(np.all(x >= 0.0) and np.all(x <= 1.0) for x in bo.added_points)


@functools.lru_cache(maxsize=None)
def resumed(name):
    """A loop of the surrogate ``name`` ("gpr" or "coupled"; DoE 10, seed 0)
    that takes one infill, is saved, then takes a batch of two; and the loop
    loaded from that save, with what it restored before it ran, after the
    same batch. One run shared by the tests that read it."""
    spec = {"gpr": GPR, "coupled": COUPLED}[name]
    bo = loop(model_dic=spec, DoE_size=10, seed=0)
    n0 = len(bo.X)
    bo.run(1, **RUN)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mo_bo.npz")
        bo.save(path)
        assert not os.path.exists(path + ".tmp")
        bo2 = MO_BO.load(path, get("multi_obj_1D_4"), **ON_CPU)
    restored = dict(iteration=bo2._iteration, rows=len(bo2.X),
                    model_dic=bo2.model_dic)
    trace = list(bo.run(1, batch_size=2, **RUN))
    trace2 = list(bo2.run(1, batch_size=2, **RUN))
    return SimpleNamespace(bo=bo, n0=n0, trace=trace, bo2=bo2, trace2=trace2,
                           restored=restored, spec=spec)


def test_coupled_infills_grow_hypervolume():
    r = resumed("coupled")
    bo, n0 = r.bo, r.n0
    assert len(bo.X) == n0 + 3 and len(bo.F[0]) == n0 + 3
    assert len(r.trace) == 4 and monotone(r.trace) and in_box(bo)
    Xnd, Fnd = bo.pareto()
    assert Xnd.shape[1] == 1 and Fnd.shape[1] == 2 and len(Xnd) >= 1


@pytest.mark.parametrize("approx", ["Gaussian", "KDE"])
def test_estimators_and_known_doe(approx):
    problem = get("multi_obj_1D_2")
    X = np.random.default_rng(3).uniform(0.05, 0.95, (8, 1))
    bo = loop("multi_obj_1D_2", X=X, F=[f[:, None] for f in
                                        objectives(problem, X)], seed=1)
    trace = bo.run(1, approximation=approx, **RUN)
    assert np.isfinite(trace[-1]) and trace[-1] >= trace[0] - 1e-12


@pytest.mark.parametrize("name", ["gpr", "coupled"])
def test_save_load_exact_resume(name):
    """Same key and data: the continuation (a batch of two) reproduces
    exactly, the spec restored from the checkpoint itself."""
    r = resumed(name)
    assert r.restored == dict(iteration=1, rows=r.n0 + 1, model_dic=r.spec)
    assert r.trace2 == r.trace
    np.testing.assert_array_equal(r.bo2.X, r.bo.X)
    np.testing.assert_array_equal(r.bo2.F[1], r.bo.F[1])


def test_search_box_covers_domain(monkeypatch):
    """The EHVI search runs over the domain mapped through the input
    normalization, and the pick denormalizes back to the domain point."""
    bo = loop(DoE_size=10, seed=0)
    mu, sd = bo.X.mean(0), _safe_std(bo.X)
    target, captured = 0.02, {}

    def fake_optimize(model, YND, **kw):
        captured["bounds"] = kw["bounds"]
        return ((target - mu) / sd)[None, :]

    monkeypatch.setattr(mo_bo_mod, "optimize_EHVI", fake_optimize)
    bo.run(1, **RUN)
    lw, up = captured["bounds"]
    np.testing.assert_allclose(lw, (0.0 - mu) / sd)
    np.testing.assert_allclose(up, (1.0 - mu) / sd)
    np.testing.assert_allclose(bo.X[-1], [target], atol=1e-12)


def test_multidim_problem():
    """d = 3 (kursawe): search and denormalization per column."""
    bo = loop("kursawe", DoE_size=12, seed=2)
    trace = bo.run(1, **RUN)
    assert bo.X.shape == (13, 3)
    assert np.isfinite(trace[-1]) and trace[-1] >= trace[0] - 1e-12


def test_independent_gpr_surrogates():
    r = resumed("gpr")
    model = r.bo.make_model(*r.bo._normalized()[:2], seed=0)
    assert [m.name for m in model] == ["gpr", "gpr"]
    assert model[0].device == torch.device("cpu")
    assert monotone(r.trace) and in_box(r.bo)
    assert r.bo2.model_dic == GPR and r.bo2.hv_trace == r.bo.hv_trace


def test_default_model_dic_is_independent_gpr():
    bo = MO_BO(problem=get("multi_obj_1D_4"), DoE_size=10, seed=0, **ON_CPU)
    assert bo.model_dic == DEFAULT_MODEL_DIC
    assert DEFAULT_MODEL_DIC["iterations"] == 2000
    assert [m.name for m in bo.make_model(*bo._normalized()[:2], 0)] == [
        "gpr", "gpr"]
    legacy = loop(model_dic={"loop": 1, "num_samples": 3}, DoE_size=10,
                  seed=0)
    assert isinstance(legacy.make_model(*legacy._normalized()[:2], 0),
                      MultiObjDeepGP)


def test_independent_dgp_surrogates():
    """num_layers >= 1: two DGPs; a batch of two takes the lie's warm
    refit."""
    spec = {"type": "independent", "num_layers": 1, "num_units": 1,
            "kernels": "rbf", "num_samples": 2, "schedule": (10, 5, 0)}
    bo = loop("multi_obj_1D_2", model_dic=spec, DoE_size=8, seed=1)
    model = bo.make_model(*bo._normalized()[:2], seed=0)
    assert [m.name for m in model] == ["dgp", "dgp"]
    trace = bo.run(1, batch_size=2, lie_train_iterations=5, **RUN)
    assert len(trace) == 3 and np.isfinite(trace[-1])
    assert trace[-1] >= trace[0] - 1e-12


def test_unknown_model_type():
    bo = loop(model_dic={"type": "nope"}, DoE_size=8, seed=0)
    with pytest.raises(ValueError, match="unknown model_dic type"):
        bo.run(1, **RUN)


def test_default_auto_restarts(monkeypatch):
    """Without 'restarts' the driver passes restarts='auto' on."""
    seen = {}
    monkeypatch.setattr(MultiObjDeepGP, "_restart_score",
                        lambda self, crit, key: seen.setdefault("scored", 1.0))
    orig = MultiObjDeepGP.optimize_nat_adam

    def spy(self, *a, **kw):
        seen["restarts"] = kw.get("restarts")
        return orig(self, *a, **kw)

    monkeypatch.setattr(MultiObjDeepGP, "optimize_nat_adam", spy)
    spec = {k: v for k, v in COUPLED.items() if k != "restarts"}
    bo = loop(model_dic=spec, DoE_size=10, seed=0)
    trace = bo.run(1, **RUN)
    assert seen["restarts"] == "auto" and seen["scored"] == 1.0
    assert np.isfinite(trace[-1])


def test_constrained_problems_registry():
    bnh = get("bnh")
    assert bnh.n_con == 2 and bnh.dim == 2
    assert all(v <= 0 for v in bnh.con(np.array([0.2, 0.2])))
    assert bnh.con(np.array([0.0, 1.0]))[0] > 0
    srn = get("srn")
    assert srn.n_con == 2 and srn.con(np.array([1.0, 0.0]))[0] > 0
    assert all(v <= 0 for v in srn.con(np.array([0.4, 0.6])))
    assert get("multi_obj_1D_4").n_con == 0


def test_pof_pure_orders_feasibility():
    """A GPR on g(x) = x - 0.5: PoF ~ 1 deep in the feasible half, ~ 0 deep
    in the infeasible half, uncertain at the boundary."""
    X = np.linspace(0, 1, 24)[:, None]
    c = X - 0.5
    m = make_single_model({"num_layers": 0, "kernels": "rbf"}, X,
                          normalize(c), n_bucket=8, **ON_CPU)
    m.optimize_adam(iterations=100, lr=0.01)
    zero_n = torch.tensor([(0.0 - c.mean()) / c.std()], dtype=torch.float64)
    pof = tehvi._pof_pure(((m.params, m.train_data),), zero_n,
                          torch.tensor([[0.05], [0.5], [0.95]],
                                       dtype=torch.float64)).detach().numpy()
    assert pof[0] > 0.95 and pof[2] < 0.05 and 0.2 < pof[1] < 0.8


def test_constrained_loop_bnh(tmp_path):
    bo = loop("bnh", DoE_size=12, seed=0)
    assert bo.n_con == 2 and bo.C.shape == (12, 2)
    trace = bo.run(2, **RUN)
    assert len(bo.X) == 14 and bo.C.shape == (14, 2)
    assert monotone(trace) and np.isfinite(bo.C).all()
    for x in bo.pareto()[0]:
        assert all(v <= 0 for v in get("bnh").con(x))
    path = str(tmp_path / "mo_bo_bnh.npz")
    bo.save(path)
    bo2 = MO_BO.load(path, get("bnh"), **ON_CPU)
    assert np.allclose(bo2.C, bo.C) and bo2.model_C_dic == bo.model_C_dic
    assert bo2.hv_trace == bo.hv_trace


def test_pof_bootstrap_without_feasible_point():
    problem = get("srn")
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.uniform(0.95, 1.0, 8),
                         rng.uniform(0.0, 0.05, 8)])
    F = [f[:, None] for f in objectives(problem, X)]
    bo = loop("srn", X=X, F=F, seed=0)
    assert (bo.C[:, 0] > 0).all() and bo.hv_trace[0] == 0.0
    trace = bo.run(1, **RUN)
    assert len(bo.X) == 9 and bo.C.shape == (9, 2) and np.isfinite(trace[-1])


def test_validation_errors(monkeypatch):
    with pytest.raises(ValueError):
        MO_BO(**ON_CPU)
    with pytest.raises(ValueError):
        MO_BO(problem=get("multi_obj_1D_4"), **ON_CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MO_BO(problem=get("multi_obj_1D_4"), DoE_size=4)


def test_batch_infill_spreads_and_grows():
    bo = loop(DoE_size=10, seed=0)
    n0 = len(bo.X)
    trace = bo.run(2, batch_size=3, **RUN)
    assert len(bo.X) == n0 + 6 and len(trace) == 7 and monotone(trace)
    batch = np.vstack(bo.added_points[-3:])
    for i in range(3):
        for j in range(i + 1, 3):
            assert abs(batch[i, 0] - batch[j, 0]) > 1e-5


def test_batch_lies_never_reach_archive():
    problem = get("multi_obj_1D_4")
    bo = loop(DoE_size=8, seed=2)
    bo.run(1, batch_size=2, **RUN)
    f = objectives(problem, bo.X)
    np.testing.assert_allclose(bo.F[0][:, 0], f[0], rtol=1e-12)
    np.testing.assert_allclose(bo.F[1][:, 0], f[1], rtol=1e-12)


def test_batch_coupled_surrogate_front_only():
    r = resumed("coupled")
    batch = np.vstack(r.bo.added_points[-2:])
    assert len(r.bo.added_points) == 3 and batch.shape == (2, 1)
    assert np.isfinite(r.trace[-2:]).all() and in_box(r.bo)


def test_batch_constrained():
    bo = loop("bnh", DoE_size=12, seed=3)
    bo.run(1, batch_size=2, **RUN)
    assert len(bo.X) == 14 and bo.C.shape == (14, bo.n_con)
    assert np.all(np.isfinite(bo.hv_trace))


def test_suggest_observe_matches_run_exactly():
    problem = get("multi_obj_1D_4")
    bo1 = loop(DoE_size=8, seed=5)
    bo1.run(2, batch_size=2, **RUN)
    bo2 = loop(DoE_size=8, seed=5)
    for _ in range(2):
        X_new = bo2.suggest(batch_size=2, **ASK)
        assert X_new.shape == (2, 1)
        bo2.observe(X_new, objectives(problem, X_new))
    np.testing.assert_array_equal(bo1.X, bo2.X)
    np.testing.assert_array_equal(bo1.F[0], bo2.F[0])
    assert bo1.hv_trace == bo2.hv_trace
    assert bo1._run_key == bo2._run_key and bo1._iteration == bo2._iteration


def test_observe_accepts_stacked_f():
    bo = loop(DoE_size=8, seed=6)
    n0 = len(bo.X)
    trace = bo.observe(np.asarray([[0.3], [0.7]]),
                       np.asarray([[0.1, 0.2], [0.3, 0.4]]))
    assert len(bo.X) == n0 + 2 and len(trace) == 3
    np.testing.assert_allclose(bo.F[0][-2:, 0], [0.1, 0.3])
    np.testing.assert_allclose(bo.F[1][-2:, 0], [0.2, 0.4])


def test_observe_constrained_requires_c():
    bo = loop("bnh", DoE_size=10, seed=0)
    with pytest.raises(ValueError, match="constraint values"):
        bo.observe(np.asarray([[0.5, 0.5]]), np.asarray([[1.0, 2.0]]))


def test_async_suggests_match_batch_infill():
    """suggest(1); suggest(1); observe(both) walks the batch_size=2
    trajectory exactly."""
    problem = get("multi_obj_1D_4")
    bo1 = loop(DoE_size=8, seed=5)
    X_b = bo1.suggest(batch_size=2, **ASK)
    bo1.observe(X_b, objectives(problem, X_b))
    bo2 = loop(DoE_size=8, seed=5)
    xa = bo2.suggest(batch_size=1, **ASK)
    assert bo2.pending.shape == (1, 1)
    xb = bo2.suggest(batch_size=1, **ASK)
    X_a = np.vstack([xa, xb])
    bo2.observe(X_a, objectives(problem, X_a))
    np.testing.assert_array_equal(X_b, X_a)
    np.testing.assert_array_equal(bo1.X, bo2.X)
    assert bo1.hv_trace == bo2.hv_trace and bo1._run_key == bo2._run_key
    assert bo1.pending.shape == bo2.pending.shape == (0, 1)


def test_pending_persists_and_conditions():
    problem = get("multi_obj_1D_4")
    bo = loop(DoE_size=8, seed=2)
    n0 = len(bo.X)
    x1 = bo.suggest(batch_size=1, **ASK)
    rows0 = bo._bstate["model"][0].data[0].shape[0]
    x2 = bo.suggest(batch_size=1, **ASK)
    assert bo._bstate["model"][0].data[0].shape[0] == rows0 + 1
    assert len(bo._bstate["F_fant"][0]) == n0 + 1
    assert bo.pending.shape == (2, 1)
    bo.observe(x1, [np.reshape(problem.fun(x1[0])[i], (1,)) for i in (0, 1)])
    assert bo.pending.shape == (1, 1)
    np.testing.assert_allclose(bo.pending, x2, atol=1e-12)
    bo.suggest(batch_size=1, **ASK)
    assert len(bo._bstate["F_fant"][0]) == len(bo.F[0]) + 1


def test_pending_roundtrips_save_load(tmp_path):
    problem = get("multi_obj_1D_4")
    bo = loop(DoE_size=8, seed=3)
    x1 = bo.suggest(batch_size=2, **ASK)
    path = str(tmp_path / "pending.npz")
    bo.save(path)
    assert not os.path.exists(path + ".tmp")
    bo2 = MO_BO.load(path, problem, **ON_CPU)
    np.testing.assert_array_equal(bo2.pending, x1)
    bo2.suggest(batch_size=1, **ASK)
    assert len(bo2._bstate["F_fant"][0]) == len(bo2.F[0]) + 2
    assert bo2.pending.shape == (3, 1)
    bo2.clear_pending()
    assert bo2.pending.shape == (0, 1)


def test_pending_constrained_problem():
    problem = get("bnh")
    bo = loop("bnh", DoE_size=10, seed=1)
    x1 = bo.suggest(batch_size=1, **ASK)
    x2 = bo.suggest(batch_size=1, **ASK)
    assert bo.pending.shape == (2, 2)
    assert len(bo._bstate["C_fant"]) == len(bo.C) + 1
    X_obs = np.vstack([x1, x2])
    C_obs = np.asarray([problem.con(x) for x in X_obs], dtype=float)
    bo.observe(X_obs, objectives(problem, X_obs), C_obs)
    assert bo.pending.shape == (0, 2) and len(bo.X) == 12


def test_ehvi_mc_agrees_with_exact_ehvi():
    """The m-objective Monte-Carlo evaluator against the exact 2-D
    estimator on a GPR pair (one front, one corner), to MC tolerance; the
    exact estimator against a brute-force MC hypervolume gain."""
    bo = loop(DoE_size=10, seed=0)
    Xn, Fn = bo._normalized()[:2]
    model = bo.make_model(Xn, Fn, 0)
    bo._train_model(model, None, None)
    F = np.hstack(Fn)
    nd = tehvi.NDC(Fn, -np.ones((len(F), 1)), obj1_ascending=False)
    ref = F.max(axis=0) + 0.5
    YND = tehvi.Y_ND(Fn, nd, nadir=ref, ideal=F.min(axis=0) - 5.0)
    Xc = np.linspace(Xn.min(), Xn.max(), 3)[:, None]
    exact = tehvi.EHVI(model, Xc, YND).numpy().ravel()
    mc = tehvi.ehvi_mc(model, F[nd], ref, Xc, key=1, S=250)
    np.testing.assert_allclose(mc, exact, rtol=0.2, atol=2e-3)
    assert np.all(exact >= 0)
