"""The port's examples (``examples_torch/``) and recipes on the CPU at tiny
budgets: each section runs with ``device="cpu"`` in float64 and its own
asserts hold; serving's chunked request equals the whole one; recipe (b)
reloads bit-equal, recipe (c) resumes bit-equal, recipe (a) runs at
N = 4,096 and B = 256; and each fresh example model's ``monitor.summary``
rows are those of dgp_tpu's model built from the same inputs. No JAX
training loop runs: the reference only builds models."""

import numpy as np
import pytest
import scipy.stats  # noqa: F401  (calculate_metrics imports it: ~3 s)
import torch
import torch._dynamo  # noqa: F401  (the first torch.optim.Adam imports it)

import chip_smoke
import dgp_tpu
from dgp_tpu.layers.initializations import init_layers_linear as j_init
from dgp_tpu.models.dgp import DGP as JDGP
from dgp_tpu.ops import kernels as JK
from dgp_tpu.ops.likelihoods import Bernoulli as JBernoulli
from dgp_tpu.utils import monitor as jmon
from dgp_tpu_torch.utils import monitor as tmon
from compat_torch import benchmark_mf
from examples_torch import (ask_tell, classification, mf_bo, mo_bo,
                            quickstart, recipes, serving)

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_monitor import reference_params

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
GPR_DIC = {"type": "independent", "num_layers": 0, "kernels": "rbf",
           "iterations": 20}
AR1_DIC = {"type": "ar1", "n_starts": 2, "iterations": 20}
DE = dict(popsize_DE=8, iterations_DE=3)


def finite(losses):
    return bool(torch.isfinite(torch.as_tensor(losses)).all())


@pytest.mark.parametrize("main", [
    quickstart.main, serving.main, ask_tell.main, classification.main,
    mf_bo.main, mo_bo.main, recipes.main, benchmark_mf.main],
    ids=lambda f: f.__module__.split(".")[-1])
def test_without_a_card_or_cpu_each_raises(main, monkeypatch):
    """No silent CPU fallback: without a card and without device="cpu"
    (the scripts' --cpu) each entry point raises before it trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main()


def test_quickstart_sections():
    model, losses, rmse = quickstart.dgp_regression(iterations=(3, 3),
                                                    samples=5, **CPU)
    assert losses.shape == (6,) and finite(losses) and np.isfinite(rmse)
    _, losses, metrics = quickstart.multi_fidelity(iterations=(2, 2, 2), **CPU)
    assert finite(losses) and np.isfinite(metrics["r2"])
    bo = quickstart.bayesian_optimization(infills=1, train_iterations=10,
                                          **DE, **CPU)
    assert len(bo.Ymin) == 2 and np.all(np.diff(bo.Ymin) <= 0)
    _, losses, ehvi = quickstart.multi_objective(iterations=2, S=20, **CPU)
    assert finite(losses) and ehvi.shape == (2,) and np.isfinite(ehvi).all()


def test_serving_reloads_and_chunks():
    trained, served = serving.train_and_reload(iterations=3, **CPU)
    for a, b in zip(trained.params.parameters(), served.params.parameters()):
        assert torch.equal(a, b)
    with serving.process_group("cpu") as mesh, chip_smoke.zero_normals():
        (m, v), (m2, v2) = serving.requests(served, mesh, samples=3,
                                            chunk_size=256)
    assert m.shape == m2.shape == (3, 1003, 1)
    for whole, chunked in ((m, m2), (v, v2)):
        scale = float(whole.abs().max())
        assert float((whole - chunked).abs().max()) <= 1e-6 * scale


def test_ask_tell_batches_and_pending():
    bo = ask_tell.batches(rounds=2, batch_size=3, train_iterations=10, **DE,
                          **CPU)
    assert bo.X.shape == (8 + 6, 2) and np.all(np.diff(bo.Ymin) <= 1e-12)
    assert ask_tell.asynchronous(bo, train_iterations=10, **DE) == [2, 1, 0]


def test_classification():
    acc, logd, losses = classification.main(iterations=5, samples=5, **CPU)
    assert 0.0 <= acc <= 1.0 and np.isfinite(logd) and finite(losses)


def test_mf_bo_sections():
    bo = mf_bo.main(infills=2, num_samples=5, model_dic=AR1_DIC, **DE, **CPU)
    assert len(bo.best_trace) == 3 and len(bo.fidelity_choices) == 2
    bo = mf_bo.constrained_demo(infills=1, num_samples=5, model_dic=AR1_DIC,
                                model_C_dic={"kernels": "rbf",
                                             "iterations": 10}, **DE, **CPU)
    assert bo.n_con == 1 and len(bo.best_trace) == 2
    bo = mf_bo.variant_dims_demo(infills=1, schedule=(2, 1, 1),
                                 num_samples=3, **DE, **CPU)
    assert [x.shape[1] for x in bo.X] == [2, 4]


def test_mo_bo_sections():
    bo = mo_bo.main(infills=1, S=10, model_dic=GPR_DIC, **DE, **CPU)
    assert len(bo.hv_trace) == 2 and bo.hv_trace[1] >= bo.hv_trace[0]
    bo = mo_bo.coupled(schedule=(2, 0, 0), S=10, **DE, **CPU)
    assert len(bo.hv_trace) == 2


def test_recipe_a_minibatched_on_a_mesh():
    with serving.process_group("cpu") as mesh:
        for M, iterations in ((128, (1, 1)), (256, (1, 0))):
            model, losses, _ = recipes.minibatched_training(
                mesh, N=4_096, M=M, B=256, iterations=iterations, **CPU)
            assert model.mesh is mesh and model.minibatch_size == 256
            assert losses.shape == (sum(iterations),) and finite(losses)


def test_recipe_b_reloads_the_checkpoint_bit_equal(monkeypatch, tmp_path):
    """The parameters of the one in-phase checkpoint (after step 2 of 4)
    are what the fresh model holds after the load, bit for bit."""
    model = recipes.large_model(N=512, B=64, **CPU)
    fresh = recipes.large_model(N=512, B=64, **CPU)
    loaded = {}
    load = recipes.checkpoint.load
    monkeypatch.setattr(recipes.checkpoint, "load", lambda path, like: (
        load(path, like), loaded.update({k: v.clone() for k, v in
                                         like.state_dict().items()}))[0])
    with chip_smoke.checkpoint_snapshots() as snapshots:
        path, losses = recipes.checkpointed_training(
            model, fresh, iterations=4, every=2, more=2,
            path=str(tmp_path / "run.npz"))
    assert [done for done, _ in snapshots] == [2] and finite(losses)
    assert loaded.keys() == snapshots[0][1].keys()
    for k, v in snapshots[0][1].items():
        assert torch.equal(loaded[k], v), k


def test_recipe_c_resumes_bit_equal():
    resumed, whole = recipes.bo_resume(train_iterations=10, **DE, **CPU)
    np.testing.assert_array_equal(resumed.X, whole.X)
    np.testing.assert_array_equal(np.asarray(resumed.Ymin, float),
                                  np.asarray(whole.Ymin, float))
    for a, b in zip(resumed.model_Y.params.parameters(),
                    whole.model_Y.params.parameters()):
        assert torch.equal(a, b)


def j_rbf(n_dims, **kw):
    return JK.RBF.create(lengthscales=[kw.pop("lengthscale", 1.0)] * n_dims,
                         **kw)


def reference_models():
    """{name: (the port's fresh example model, dgp_tpu's model from the
    same inputs, or None where it is held through reference_params)}."""
    X, Y, Z = quickstart.regression_data()
    Xs, Ys, _ = serving.data()
    Xc, Yc = classification.make_data()
    Xl, Yl = recipes.large_data(256, 0)
    Zl = Xl[np.random.default_rng(2).choice(256, 128, replace=False)]
    return {
        "quickstart DGP": (lambda: quickstart.regression_model(**CPU),
                           lambda: JDGP(X, Y, Z, [j_rbf(1) for _ in range(3)],
                                        [1, 1], num_samples=10)),
        "serving": (lambda: serving.model(**CPU),
                    lambda: JDGP(Xs, Ys, Xs[:16].copy(),
                                 [j_rbf(2), j_rbf(1)], [1], num_samples=5)),
        "classification": (
            lambda: classification.model(**CPU),
            lambda: JDGP.from_layers(
                Xc, Yc, j_init(Xc, Yc, Xc[::4].copy(),
                               [j_rbf(2, lengthscale=0.5, variance=1.0)] * 2,
                               [2]),
                likelihood=JBernoulli(), num_samples=5)),
        "recipes": (lambda: recipes.large_model(256, 128, 64, **CPU),
                    lambda: JDGP(Xl, Yl, Zl, [j_rbf(8, variance=1.0)] * 2,
                                 [8], num_samples=10, white=True,
                                 minibatch_size=64)),
        "quickstart MF-DGP": (lambda: quickstart.mf_model(**CPU), None),
        "quickstart MO-DGP": (lambda: quickstart.mo_model(**CPU), None),
    }


@pytest.mark.parametrize("name", list(reference_models()))
def test_summary_rows_match_the_reference_model(name):
    """Row for row, as printed (values to the printed digits). The MF and
    MO models' rows are held through reference_params (the JAX package's
    dataclasses holding the port's arrays): their constructors are held to
    dgp_tpu's in f64 by test_torch_mf_dgp.py and test_torch_mo_dgp.py, and
    building them in JAX costs seconds each."""
    port, reference = reference_models()[name]
    model = port()
    want = reference().params if reference else reference_params(model.params)
    assert tmon.summary(model, print_fn=None) == jmon.summary(
        want, print_fn=None)
    assert dgp_tpu.summary is not None
