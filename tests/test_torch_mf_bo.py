"""Port parity: the multi-fidelity BO driver (``dgp_tpu_torch/bo/mf_bo.py``)
against ``dgp_tpu``'s ``MF_BO`` in float64 on CPU, on the same numpy
archives and the same surrogate parameters (``convert``), without running
either package's loop: the DoE bit for bit; the pooled normalization, the
best feasible value and ``x_best``, with and without a constraint; the
fidelity rule's choices and sigma over a grid (three gammas, and the
duplicate guard fed pending queries) on an AR(1) surrogate; a believer lie
at the lowest and at the top fidelity (its value, the surrogate's posterior
after it, the in-batch incumbent) and a constraint GPR's lie and
feasibility verdict; the bookkeeping of a fixed sequence of ``observe``
calls; and the constructor's and ``observe``'s ``ValueError``\\s, all to
1e-10. The surrogates carry fixed parameters off their init, so no
reference engine is traced; the reference's jitted AR(1) posterior
compiles once per fidelity at one row."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgp_tpu.bo import acquisition as jacq
from dgp_tpu.bo import mf_bo as jmf
from dgp_tpu.bo import so_bo as jso
from dgp_tpu.models.dgp import moment_matched as j_moment_matched
from dgp_tpu_torch import convert
from dgp_tpu_torch.bo import acquisition as tacq
from dgp_tpu_torch.bo import mf_bo as tmf
from dgp_tpu_torch.bo import so_bo as tso
from dgp_tpu_torch.utils.test_functions import forrester_high, forrester_low

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
ON_CPU = dict(device="cpu", dtype=F64)
TOL = 1e-10


def mid(x):
    return 0.5 * (forrester_low(x) + forrester_high(x))


def ring_con(x):
    """Feasible iff x >= 0.55 (the Forrester optimum x* = 0.757 stays)."""
    return 0.55 - np.asarray(x)[:, 0]


FIDS = {2: [forrester_low, forrester_high],
        3: [forrester_low, mid, forrester_high]}
# DoE sizes inside one bucket of 8 after a lie row: the reference's jitted
# posterior keeps its padded shapes
DOE = {2: (8, 4), 3: (6, 5, 3)}


def pair(n_fid=3, seed=1, **kw):
    """(dgp_tpu's MF_BO, the port's) on the same arguments."""
    kw = dict(fidelities=FIDS[n_fid], DoE_sizes=DOE[n_fid], d=1, seed=seed,
              **kw)
    return jmf.MF_BO(**kw), tmf.MF_BO(**kw, **ON_CPU)


def off_init(params):
    """The parameters moved off the canonical init (each leaf its own
    shift), so the posterior is not a symmetric special case."""
    leaves, treedef = jax.tree.flatten(params)
    return jax.tree.unflatten(
        treedef, [x + 0.2 * (i + 1) * (-1) ** i for i, x in enumerate(leaves)])


def surrogates(ref_bo, port_bo):
    """The AR(1) surrogate of both drivers on their normalized archives, the
    port's carrying the reference's (off-init) parameters."""
    Ys_n, _, _ = ref_bo._normalized_Y()
    ref = ref_bo.make_model(Ys_n, seed=0)
    ref.params = off_init(ref.params)
    port = port_bo.make_model(Ys_n, seed=0)
    port.params = convert.ar1_from_numpy(
        convert.numpy_tree_from_reference(ref.params), "cpu", F64)
    return ref, port


def constraint_gprs(ref_bo, port_bo):
    """One constraint GPR in both packages on the pooled archive (the
    drivers' spec and normalization), at the same off-init parameters, and
    the feasibility threshold in normalized units."""
    X_all = np.vstack(ref_bo.X)
    c = np.vstack(ref_bo.C)
    spec = {"num_layers": 0, "kernels": "rbf"}
    ref = jso.make_single_model(spec, X_all, jso.normalize(c), n_bucket=8,
                                seed=ref_bo._seed)
    ref.params = off_init(ref.params)
    port = tso.make_single_model(spec, X_all, tso.normalize(c), n_bucket=8,
                                 seed=port_bo._seed, **ON_CPU)
    port.params = convert.gpr_from_numpy(
        convert.numpy_tree_from_reference(ref.params), "cpu", F64)
    zero_n = float((0.0 - c.mean()) / jmf._col_std(c))
    assert zero_n == float((0.0 - c.mean()) / tmf._col_std(c))
    return ref, port, np.asarray([zero_n])


def ref_sigma(model, x, f, S=100):
    """dgp_tpu's fidelity-rule std at x (the formula of its
    ``_select_fidelity``)."""
    m_s, v_s = model.predict_f(x, S=S, fidelity=f)
    _, var = j_moment_matched(m_s, v_s)
    return float(np.sqrt(max(float(np.max(var)), 0.0)))


def as_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def assert_close(got, want, tol=TOL):
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(as_np(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


GRID = np.linspace(0.0, 1.0, 13)[:, None]


# -- DoE and bookkeeping -----------------------------------------------------------


@pytest.mark.parametrize("n_fid", [2, 3])
@pytest.mark.parametrize("seed", [0, 5])
def test_doe_is_bit_equal(n_fid, seed):
    ref, port = pair(n_fid, seed)
    assert port.costs == ref.costs and port.d == ref.d == 1
    for f in range(n_fid):
        np.testing.assert_array_equal(port.X[f], ref.X[f])
        np.testing.assert_array_equal(port.Y[f], ref.Y[f])
        np.testing.assert_array_equal(port._Z0[f], ref._Z0[f])
    assert port.best_trace == ref.best_trace


@pytest.mark.parametrize("constrained", [False, True])
def test_normalization_best_and_x_best(constrained):
    kw = {"constraints": [ring_con]} if constrained else {}
    ref, port = pair(2, 3, **kw)
    ys_r, mu_r, sd_r = ref._normalized_Y()
    ys_p, mu_p, sd_p = port._normalized_Y()
    assert_close(mu_p, mu_r)
    assert_close(sd_p, sd_r)
    for a, b in zip(ys_p, ys_r):
        assert_close(a, b)
    assert_close(port._best_feasible(), ref._best_feasible())
    np.testing.assert_array_equal(port.x_best, ref.x_best)
    if constrained:
        for a, b in zip(port.C, ref.C):
            np.testing.assert_array_equal(a, b)


def test_best_and_x_best_while_none_is_feasible():
    """No feasible top-fidelity row: the top-fidelity maximum, and the
    unconstrained argmin for x_best, in both."""
    X = [np.asarray([[0.1], [0.4], [0.6], [0.9]]),
         np.asarray([[0.2], [0.3], [0.5]])]
    Y = [forrester_low(X[0]), np.asarray([[3.0], [-1.0], [2.0]])]
    kw = dict(fidelities=FIDS[2], X=X, Y=Y, constraints=[ring_con], seed=0)
    ref, port = jmf.MF_BO(**kw), tmf.MF_BO(**kw, **ON_CPU)
    assert port._best_feasible() == ref._best_feasible() == 3.0
    np.testing.assert_array_equal(port.x_best, ref.x_best)


# -- the fidelity rule --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rule_models():
    """Both drivers and surrogates at 3 fidelities; the reference's
    posterior program of each fidelity, at one row, compiled in a thread of
    its own (XLA compiles a program on one core and releases the GIL)."""
    ref_bo, port_bo = pair(3, 1)
    ref, port = surrogates(ref_bo, port_bo)
    with ThreadPoolExecutor(3) as pool:
        for done in [pool.submit(ref.predict_f, GRID[:1], 1, t)
                     for t in range(3)]:
            done.result()
    return ref_bo, port_bo, ref, port


def test_fidelity_sigma_matches_over_a_grid():
    ref_bo, port_bo, ref, port = rule_models()
    for f in (0, 1):
        got = [port_bo._fidelity_sigma(port, x[None], f) for x in GRID]
        want = [ref_sigma(ref, x[None], f) for x in GRID]
        assert_close(got, want)
        assert max(want) > 1e-3   # not a degenerate posterior


@pytest.mark.parametrize("gamma", [0.0, 0.3, 1e9])
def test_fidelity_choice_matches_over_a_grid(gamma):
    ref_bo, port_bo, ref, port = rule_models()
    ref_bo.gamma = port_bo.gamma = gamma
    got = [port_bo._select_fidelity(port, x[None]) for x in GRID]
    want = [ref_bo._select_fidelity(ref, x[None]) for x in GRID]
    assert got == want
    if gamma == 1e9:
        assert set(got) == {2}


def test_duplicate_guard_sees_extra_queries():
    """At gamma = 0 a fresh point goes to fidelity 0, a point pending at
    fidelity 0 to 1, and one pending at 0 and 1 to 2, in both."""
    ref_bo, port_bo, ref, port = rule_models()
    ref_bo.gamma = port_bo.gamma = 0.0
    x = np.asarray([[0.4321]])
    cases = [(), [(x, 0)], [(x, 0), (x + 2e-4, 1)], [(x + 0.1, 0)]]
    got = [port_bo._select_fidelity(port, x, extra_queries=e) for e in cases]
    want = [ref_bo._select_fidelity(ref, x, extra_queries=e) for e in cases]
    assert got == want == [0, 1, 2, 0]
    # an archive row is a duplicate too
    x_dup = ref_bo.X[0][2:3] + 1e-5
    assert (port_bo._select_fidelity(port, x_dup)
            == ref_bo._select_fidelity(ref, x_dup) == 1)


# -- believer lies --------------------------------------------------------------------


def batch_states(ref_bo, port_bo, ref, port, model_C=None):
    """The drivers' batch state on the given surrogates (EI incumbent of
    the real archives)."""
    _, mu, sd = ref_bo._normalized_Y()
    y_min = (ref_bo._best_feasible() - mu) / sd
    common = dict(mu=mu, sd=sd, zero_n=None if model_C is None
                  else model_C[2])
    st_ref = dict(common, model=ref, ic=jacq.EI(y_min, 1),
                  model_C=None if model_C is None else [model_C[0]])
    st_port = dict(common, model=port, ic=tacq.EI(y_min, 1),
                   model_C=None if model_C is None else [model_C[1]])
    return st_ref, st_port


ROWS = np.asarray([[0.05], [0.62], [0.98]])


@pytest.mark.parametrize("f", [0, 2])
def test_believer_lie_conditions_the_surrogate(f):
    """A lie at ``f``: its value, the posterior of every fidelity after it
    (row by row), the data row appended, and the incumbent (a top-fidelity
    lie below it lowers it)."""
    ref_bo, port_bo = pair(3, 1)
    ref, port = surrogates(ref_bo, port_bo)
    st_ref, st_port = batch_states(ref_bo, port_bo, ref, port)
    x = np.asarray([[0.7412]])
    assert_close(port_bo._lie_value(st_port, x, f, "believer"),
                 ref_bo._lie_value(st_ref, x, f, "believer"))
    ref_bo._lie_at(st_ref, x, f, "believer", None)
    port_bo._lie_at(st_port, x, f, "believer", None)
    assert port.data[0][f].shape[0] == len(port_bo.X[f]) + 1
    assert_close(port.data[1][f], ref.data[1][f])
    for t in range(3):
        for row in ROWS:
            got = port.predict_f(row[None], fidelity=t)
            want = ref.predict_f(row[None], fidelity=t)
            for a, b in zip(got, want):
                assert_close(a, b)
    assert_close(st_port["ic"].y_min, float(st_ref["ic"].y_min))
    if f == 2:
        assert st_port["ic"].y_min < (ref_bo._best_feasible()
                                      - st_ref["mu"]) / st_ref["sd"]


@pytest.mark.parametrize("lie", ["min", "max"])
def test_constant_liar_value(lie):
    ref_bo, port_bo, ref, port = rule_models()
    st_ref, st_port = batch_states(ref_bo, port_bo, ref, port)
    for f in range(3):
        assert_close(port_bo._lie_value(st_port, None, f, lie),
                     ref_bo._lie_value(st_ref, None, f, lie))


@pytest.mark.parametrize("x", [0.8123, 0.3123])
def test_constraint_gpr_lie_and_feasibility(x):
    """A top-fidelity lie on a constrained problem: the constraint GPR's
    believer value, its data after the lie, and the feasibility verdict
    (the incumbent drops only for a predicted-feasible lie)."""
    ref_bo, port_bo = pair(3, 1, constraints=[ring_con])
    ref, port = surrogates(ref_bo, port_bo)
    gprs = constraint_gprs(ref_bo, port_bo)
    st_ref, st_port = batch_states(ref_bo, port_bo, ref, port, gprs)
    x = np.asarray([[x]])
    c_ref, c_port = jso.fantasy_mean(gprs[0], x), tso.fantasy_mean(gprs[1], x)
    assert_close(c_port, c_ref)
    feasible = bool(c_ref[0, 0] <= gprs[2][0])
    assert feasible == (x[0, 0] > 0.55)   # the GPR reads the constraint right
    y0 = st_port["ic"].y_min
    lie = port_bo._lie_value(st_port, x, 2, "believer")
    ref_bo._lie_at(st_ref, x, 2, "believer", None)
    port_bo._lie_at(st_port, x, 2, "believer", None)
    for a, b in zip(gprs[1].data, gprs[0].data):
        assert_close(a, b)
    assert_close(st_port["ic"].y_min, float(st_ref["ic"].y_min))
    assert (st_port["ic"].y_min < y0) == (feasible and lie < y0)


# -- observe and the pending registry ---------------------------------------------


@pytest.mark.parametrize("constrained", [False, True])
def test_observe_sequence_bookkeeping(constrained):
    """Pending points at mixed fidelities, then observations one and two
    rows at a time, some pending and some not: the archives, the pending
    registry and the traces after each call."""
    kw = {"constraints": [ring_con]} if constrained else {}
    ref, port = pair(3, 2, **kw)
    pend_X = np.asarray([[0.5], [0.5], [0.21], [0.9]])
    pend_f = np.asarray([0, 2, 1, 2])
    for bo in (ref, port):
        bo.pending_X, bo.pending_f = pend_X.copy(), pend_f.copy()
    steps = [(np.asarray([[0.5]]), 2), (np.asarray([[0.21], [0.33]]), [1, 0]),
             (np.asarray([[0.9], [0.7]]), [2, 2]), (np.asarray([[0.5]]), 0)]
    for x, f in steps:
        y = np.sin(7 * x) - x
        c = ring_con(x)[:, None] if constrained else None
        got, want = port.observe(x, y, f, c), ref.observe(x, y, f, c)
        assert got == want
        np.testing.assert_array_equal(port.pending_X, ref.pending_X)
        np.testing.assert_array_equal(port.pending_f, ref.pending_f)
    assert len(port.pending_X) == 0
    for f in range(3):
        np.testing.assert_array_equal(port.X[f], ref.X[f])
        np.testing.assert_array_equal(port.Y[f], ref.Y[f])
        if constrained:
            np.testing.assert_array_equal(port.C[f], ref.C[f])
    assert port.cost_trace == ref.cost_trace
    assert port.best_trace == ref.best_trace
    assert port.fidelity_choices == ref.fidelity_choices
    assert port._iteration == ref._iteration == len(steps)
    np.testing.assert_array_equal(port.x_best, ref.x_best)


# -- validation -----------------------------------------------------------------------


def _vd(n):
    rng = np.random.default_rng(n)
    return [rng.uniform(0, 1, (6, 2)), rng.uniform(0, 1, (3, 4))]


INVALID = {
    "one fidelity": (dict(fidelities=FIDS[2][1:], DoE_sizes=(4,), d=1),
                     "fidelities"),
    "no DoE": (dict(fidelities=FIDS[2]), "DoE_sizes"),
    "descending costs": (dict(fidelities=FIDS[2], costs=[1.0, 0.1],
                              DoE_sizes=(4, 2), d=1), "ascending"),
    "DoE sizes": (dict(fidelities=FIDS[2], DoE_sizes=(4,), d=1),
                  "one DoE size"),
    "projections": (dict(fidelities=FIDS[3], DoE_sizes=(6, 4, 3), d=1,
                         projections=[lambda x: x]), "projections"),
    "em with 3 fidelities": (dict(fidelities=FIDS[3], DoE_sizes=(6, 4, 3),
                                  d=1, model_dic={"type": "em"}), "'em'"),
    "variant dims without em": (dict(
        fidelities=FIDS[2], X=_vd(0), Y=[np.zeros((6, 1)), np.zeros((3, 1))],
        model_dic={"type": "ar1"}), "'em'"),
    "variant dims with constraints": (dict(
        fidelities=FIDS[2], X=_vd(1), Y=[np.zeros((6, 1)), np.zeros((3, 1))],
        model_dic={"type": "em"}, constraints=[lambda x: -np.ones(len(x))],
        projections=[lambda x: np.asarray(x)[:, :2]]), "constraints"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_constructor_errors(case):
    kw, match = INVALID[case]
    with pytest.raises(ValueError, match=match) as ref_err:
        jmf.MF_BO(**kw, seed=0)
    with pytest.raises(ValueError, match=match) as port_err:
        tmf.MF_BO(**kw, seed=0, **ON_CPU)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("bad", ["fidelity 2", "fidelity -1", "count",
                                 "constraint values"])
def test_observe_errors_leave_the_archive(bad):
    kw = {"constraints": [ring_con]} if bad == "constraint values" else {}
    ref, port = pair(2, 0, **kw)
    x, y, c = np.asarray([[0.5], [0.6]]), np.asarray([[1.0], [2.0]]), None
    f = {"fidelity 2": 2, "fidelity -1": [0, -1], "count": [0, 1, 1],
         "constraint values": [0, 1]}[bad]
    errors = []
    for bo in (ref, port):
        with pytest.raises(ValueError) as err:
            bo.observe(x, y, f, c)
        errors.append(str(err.value))
        assert [len(a) for a in bo.X] == [8, 4] and bo._iteration == 0
    assert errors[0] == errors[1]


def test_incumbent_of_the_criteria():
    """_build_ic's incumbent in pooled-normalized units, for each
    criterion, and the unknown-criterion error."""
    ref_bo, port_bo = pair(2, 4)
    _, mu, sd = ref_bo._normalized_Y()
    for IC in ("EI", "WB2"):
        got = port_bo._build_ic(IC, mu, sd, None)
        want = ref_bo._build_ic(IC, mu, sd, None)
        assert type(got).__name__ == type(want).__name__ == IC
        assert_close(got.y_min, float(jnp.asarray(want.y_min)))
    with pytest.raises(ValueError, match="unknown IC"):
        port_bo._build_ic("LCB", mu, sd, None)
