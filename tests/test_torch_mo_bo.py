"""Port parity: the multi-objective BO driver (``dgp_tpu_torch/bo/mo_bo.py``)
against ``dgp_tpu``'s ``MO_BO``, in float64 on CPU, on the same problems
and DoEs, without training a surrogate or compiling a JAX program: the
DoE, the hypervolume trace and the Pareto set; the padded inducing rows of
the coupled surrogate, bit for bit; the frozen batch state (normalization,
the mapped box and hypervolume corners, the fantasy archive); the padded
fronts and search boxes every pick of a batch (believer lies and a pending
row included) hands to ``optimize_EHVI``, and the picks; the constraint
surrogates' targets and feasibility thresholds; ``DEFAULT_MODEL_DIC``;
the bookkeeping of ``observe``. Both packages' surrogate construction,
training, believer means and EHVI search are replaced by the same stubs,
so only MO_BO's own arithmetic is compared, exactly."""

import numpy as np
import pytest
import torch

from dgp_tpu.bo import mo_bo as jmo_bo
from dgp_tpu.bo import so_bo as jso
from dgp_tpu.bo.problems import get as jget
from dgp_tpu_torch.bo import mo_bo as tmo_bo
from dgp_tpu_torch.bo.problems import get as tget

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

ON_CPU = dict(device="cpu", dtype=torch.float64)
GPR_PAIR = {"type": "independent", "num_layers": 0, "kernels": "rbf",
            "iterations": 10}
COUPLED = {"loop": 1, "num_samples": 3, "schedule": (5, 0, 0), "restarts": 1}


def pair(problem="multi_obj_1D_4", **kw):
    """(dgp_tpu's MO_BO, the port's) on the same arguments."""
    return (jmo_bo.MO_BO(problem=jget(problem), **kw),
            tmo_bo.MO_BO(problem=tget(problem), **kw, **ON_CPU))


def assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class Stub:
    """A surrogate that trains nothing: ``data`` in its package's form."""

    def __init__(self, name, X, Y, as_data):
        self.name, self._as = name, as_data
        self.data = (as_data(X), as_data(Y))

    def optimize_adam(self, **kw):
        pass


def believer(x_n):
    """The stubbed believer outcome at x_n: the same numbers in both
    packages."""
    v = float(np.asarray(x_n).sum())
    return [np.sin(3 * v), np.cos(2 * v) - 0.5]


def stub_package(mp, bo, mod, so_mod, as_data, captured):
    """Replace ``bo``'s surrogate construction and training, its believer
    means and ``optimize_EHVI`` in ``mod`` by stubs that record what they
    are given; ``optimize_EHVI`` picks the mapped box's point at a fixed
    fraction per pick."""
    mp.setattr(bo, "make_model",
               lambda Xn, Fn, seed: [Stub("gpr", Xn, f, as_data) for f in Fn])
    mp.setattr(bo, "_train_model", lambda model, sched, restarts: None)
    mp.setattr(bo, "_fantasy_objectives", lambda model, x_n: believer(x_n))

    def make_single_model(spec, X, Y, **kw):
        captured.setdefault("con targets", []).append(np.array(Y))
        return Stub("gpr", X, Y, as_data)

    def fantasy_mean(m, x_n, S=64):
        return np.asarray([[believer(x_n)[0] - 0.2]])

    def optimize_EHVI(model, YND, bounds, key, model_C, zero_c, **kw):
        captured.setdefault("calls", []).append(dict(
            YND=None if YND is None else [np.array(y) for y in YND],
            bounds=[np.array(b) for b in bounds],
            zero_c=None if zero_c is None else np.array(zero_c),
            kw=dict(kw)))
        frac = 0.15 + 0.3 * len(captured["calls"])
        lw, up = (np.asarray(b, dtype=float) for b in bounds)
        return (lw + frac * (up - lw))[None, :]

    mp.setattr(mod, "make_single_model", make_single_model)
    mp.setattr(so_mod, "fantasy_mean", fantasy_mean)
    mp.setattr(mod, "fantasy_mean", fantasy_mean, raising=False)
    mp.setattr(mod, "optimize_EHVI", optimize_EHVI)


def stubbed_pair(mp, problem="multi_obj_1D_4", **kw):
    ref, port = pair(problem, **kw)
    captured = ({}, {})
    stub_package(mp, ref, jmo_bo, jso, np.asarray, captured[0])
    stub_package(mp, port, tmo_bo, tmo_bo,
                 lambda a: torch.as_tensor(np.asarray(a), **ON_CPU),
                 captured[1])
    return ref, port, captured


@pytest.mark.parametrize("problem,size,seed", [
    ("multi_obj_1D_4", 10, 0), ("kursawe", 12, 2), ("bnh", 12, 1)])
def test_doe_trace_and_pareto_set_equal(problem, size, seed):
    ref, port = pair(problem, DoE_size=size, seed=seed)
    assert_same([ref.X, ref.F, ref.C, ref.hv_trace],
                [port.X, port.F, port.C, port.hv_trace])
    assert_same(ref.pareto(), port.pareto())
    assert_same(ref._normalized(), port._normalized())


@pytest.mark.parametrize("n_bucket", [None, 8, 16])
@pytest.mark.parametrize("seed", [None, 3])
def test_bucketed_inducing_bit_equal(n_bucket, seed):
    ref, port = pair(DoE_size=10, seed=seed, n_bucket=n_bucket,
                     model_dic=COUPLED)
    Xn, Fn = ref._normalized()[:2]
    Z = port._bucketed_inducing(Xn, Fn)
    assert_same(ref._bucketed_inducing(Xn, Fn), Z)
    if n_bucket:
        assert [z.shape[0] for z in Z] == [16, 16]


def test_default_model_dic_and_coupled_spec():
    assert tmo_bo.DEFAULT_MODEL_DIC == jmo_bo.DEFAULT_MODEL_DIC
    ref, port = pair(DoE_size=8, seed=0)
    assert port.model_dic == ref.model_dic == tmo_bo.DEFAULT_MODEL_DIC
    model = port.make_model(*port._normalized()[:2], seed=0)
    assert [m.name for m in model] == ["gpr", "gpr"]
    coupled = tmo_bo.MO_BO(problem=tget("multi_obj_1D_4"), DoE_size=10,
                           model_dic=COUPLED, seed=0, **ON_CPU)
    model = coupled.make_model(*coupled._normalized()[:2], seed=0)
    assert model.name == "mo_dgp" and model.loop == 1
    assert [z.shape[0] for z in model.Z] == [16, 16]
    with pytest.raises(ValueError, match="unknown model_dic type"):
        tmo_bo.MO_BO(problem=tget("multi_obj_1D_4"), DoE_size=8,
                     model_dic={"type": "nope"}, **ON_CPU).make_model(
            *port._normalized()[:2], seed=0)


@pytest.mark.parametrize("problem,size", [("multi_obj_1D_4", 9),
                                          ("bnh", 12)])
def test_batch_state_equal(monkeypatch, problem, size):
    ref, port, _ = stubbed_pair(monkeypatch, problem, DoE_size=size, seed=4)
    st_ref, st_port = ref._fresh_batch_state(0), port._fresh_batch_state(0)
    keys = ["mu", "sd", "nadir", "ideal", "lw_n", "up_n", "F_fant", "C_fant",
            "zero_n"]
    assert_same({k: st_ref[k] for k in keys}, {k: st_port[k] for k in keys})
    assert (st_port["model_C"] is None) == (problem != "bnh")


def test_constraint_targets_and_thresholds(monkeypatch):
    """_make_train_con_models: each constraint column normalized, and the
    image of 0 under that normalization, bit for bit."""
    ref, port, captured = stubbed_pair(monkeypatch, "bnh", DoE_size=11,
                                       seed=2, model_C_dic={"iterations": 5})
    Xn = ref._normalized()[0]
    (mc_ref, z_ref), (mc_port, z_port) = (
        bo._make_train_con_models(Xn) for bo in (ref, port))
    assert len(mc_port) == 2 and len(z_port) == 2
    assert_same(z_ref, z_port)
    assert_same(captured[0]["con targets"], captured[1]["con targets"])
    bad = tmo_bo.MO_BO(problem=tget("bnh"), DoE_size=6, seed=0,
                       model_C_dic={"num_layers": 1}, **ON_CPU)
    with pytest.raises(ValueError, match="exact GPRs"):
        bad._make_train_con_models(Xn[:6])


@pytest.mark.parametrize("problem,size", [("multi_obj_1D_4", 10),
                                          ("bnh", 12), ("kursawe", 9)])
def test_batch_fronts_boxes_and_picks_equal(monkeypatch, problem, size):
    """A batch of three with one pending row: the padded front, the search
    box and the thresholds of every pick, and the raw picks, as the
    reference's driver computes them."""
    ref, port, captured = stubbed_pair(monkeypatch, problem, DoE_size=size,
                                       seed=5, n_bucket=8)
    pending = np.full((1, ref.d), 0.37)
    ref.pending, port.pending = pending.copy(), pending.copy()
    kw = dict(batch_size=3, approximation="KDE", S=7, popsize_DE=4,
              iterations_DE=2)
    picks = [bo._propose(**kw) for bo in (ref, port)]
    assert_same(picks[0], picks[1])
    assert len(captured[1]["calls"]) == 3
    for c in captured:
        for call in c["calls"]:
            call["kw"].pop("method", None)
    assert_same(captured[0]["calls"], captured[1]["calls"])
    # the front grew by the pending row's and two picks' believer outcomes
    assert_same(ref._bstate["F_fant"], port._bstate["F_fant"])
    assert len(port._bstate["F_fant"][0]) == size + 3
    assert all(len(c["YND"][0]) % 8 == 0 for c in captured[1]["calls"])


def test_pof_bootstrap_hands_no_front(monkeypatch):
    """An all-infeasible archive has no front: optimize_EHVI gets
    YND=None and the thresholds (the PoF-only bootstrap), in both."""
    problem = tget("srn")
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.uniform(0.95, 1.0, 8),
                         rng.uniform(0.0, 0.05, 8)])
    F_rows = [problem.fun(x) for x in X]
    F = [np.asarray([r[i] for r in F_rows], dtype=float).reshape(-1, 1)
         for i in (0, 1)]
    ref, port, captured = stubbed_pair(monkeypatch, "srn", X=X, F=F, seed=0)
    assert port.hv_trace == ref.hv_trace == [0.0]
    for bo in (ref, port):
        bo._propose(batch_size=1)
    assert captured[1]["calls"][0]["YND"] is None
    assert_same(captured[0]["calls"], captured[1]["calls"])


def test_observe_bookkeeping_equal():
    ref, port = pair("bnh", DoE_size=10, seed=6)
    X_new = np.asarray([[0.3, 0.2], [0.7, 0.9]])
    F_new = np.asarray([[10.0, 30.0], [60.0, 5.0]])
    C_new = np.asarray([bnh_con for bnh_con in
                        (tget("bnh").con(x) for x in X_new)])
    ref.pending = port.pending = X_new[:1].copy()
    traces = [bo.observe(X_new, F_new, C_new) for bo in (ref, port)]
    assert_same(traces[0], traces[1])
    assert_same([ref.X, ref.F, ref.C, ref.pending, ref._iteration],
                [port.X, port.F, port.C, port.pending, port._iteration])
    with pytest.raises(ValueError, match="constraint values"):
        port.observe(X_new, F_new)
