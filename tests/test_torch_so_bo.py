"""The single-objective BO driver of the port (``dgp_tpu_torch/bo/so_bo.py``)
with GPR surrogates on CPU tensors: a shortened run of the nb_dgp_BO
problem, held to the bands ``tests/test_bo.py`` holds ``dgp_tpu``'s runs to
(the two packages draw other random numbers, so the trajectories
themselves differ); the ask/tell interface against ``run``, save/load
against an uninterrupted run, batch infill. The DGP surrogate's runs are
in ``test_torch_so_bo_dgp.py``."""

import numpy as np
import pytest
import torch

from dgp_tpu_torch.bo.so_bo import SO_BO

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
GP = {"num_layers": 0, "kernels": "rbf"}
ON_CPU = dict(device="cpu", dtype=F64)


class _Constrained:
    """nb_dgp_BO: min (x-0.5)^2 s.t. step(x-0.25) <= 0; optimum 0.0625."""

    constraint = True
    dim = 1

    def fun(self, x):
        return [(x - 0.5) ** 2, np.where(x > 0.25, 1.0, 0.0)]


class _Unconstrained:
    constraint = False
    dim = 1

    def fun(self, x):
        return [(x - 0.3) ** 2]


def assert_ymin_band(bo, infills, below=None):
    ymin = np.asarray(bo.Ymin, dtype=float)
    assert ymin.shape == (infills + 1,) and np.all(np.isfinite(ymin))
    assert np.all(np.diff(ymin) <= 1e-12)        # non-increasing
    assert ymin[-1] >= 0.0625 - 1e-6             # the optimum is a floor
    if below is not None:
        assert ymin[-1] < below


def test_so_bo_end_to_end_gpr():
    """GPR objective and constraint, EV handling (as tests/test_bo.py)."""
    bo = SO_BO(problem=_Constrained(), DoE_size=6, model_Y_dic=GP,
               model_C_dic=GP, seed=3, **ON_CPU)
    bo.run(4, IC="EI", constraint_handling="EV", train_iterations=200,
           popsize_DE=40, popstd_DE=3.0, iterations_DE=50, IC_method="DE",
           verbose=False)
    assert_ymin_band(bo, 4, below=0.2)
    assert bo.X.shape == (10, 1) and bo.model_Y.data[0].shape == (10, 1)


def test_suggest_observe_matches_run_exactly():
    """suggest() + observe() with externally computed values reproduce
    run()'s trajectory bit for bit: the same seed stream, infill counter
    and archive bookkeeping, through batch infill with believer lies."""
    kw = dict(IC="EI", train_iterations=60, popsize_DE=20, iterations_DE=20,
              IC_method="DE")
    bo1 = SO_BO(problem=_Unconstrained(), DoE_size=6, model_Y_dic=GP, seed=7,
                **ON_CPU)
    bo1.run(2, batch_size=2, verbose=False, **kw)
    bo2 = SO_BO(problem=_Unconstrained(), DoE_size=6, model_Y_dic=GP, seed=7,
                **ON_CPU)
    for _ in range(2):
        X_new = bo2.suggest(batch_size=2, **kw)
        assert X_new.shape == (2, 1) and len(bo2.pending) == 2
        bo2.observe(X_new, (X_new - 0.3) ** 2)
        assert len(bo2.pending) == 0
    np.testing.assert_array_equal(bo1.X, bo2.X)
    np.testing.assert_array_equal(bo1.Y, bo2.Y)
    np.testing.assert_array_equal(np.asarray(bo1.Ymin), np.asarray(bo2.Ymin))
    assert torch.equal(bo1._run_gen.get_state(), bo2._run_gen.get_state())
    assert bo1._iteration == bo2._iteration == 2
    # the batch spread: the believer lie collapses EI at a picked point
    assert abs(float(bo1.X[-1, 0] - bo1.X[-2, 0])) > 1e-6


def test_save_load_resumes_exactly(tmp_path):
    """save() + load() + continue equals the uninterrupted run: archive,
    surrogate tensors, seed stream and pending rows round-trip."""
    kw = dict(model_Y_dic=GP, model_C_dic=GP, seed=3, n_bucket=8, **ON_CPU)
    run_kw = dict(IC="EI", constraint_handling="EV", train_iterations=40,
                  popsize_DE=20, iterations_DE=15, iterations_adam=10,
                  IC_method="DE+Adam", verbose=False)
    ref = SO_BO(problem=_Constrained(), DoE_size=5, **kw)
    ref.run(3, **run_kw)
    bo = SO_BO(problem=_Constrained(), DoE_size=5, **kw)
    bo.run(2, **run_kw)
    path = str(tmp_path / "bo.npz")
    bo.save(path)
    bo2 = SO_BO.load(path, _Constrained(), GP, GP, **ON_CPU)
    np.testing.assert_array_equal(bo2.X, bo.X)
    for a, b in zip(bo2.model_Y.params.parameters(),
                    bo.model_Y.params.parameters()):
        assert torch.equal(a, b)
    bo2.run(1, **run_kw)
    np.testing.assert_array_equal(bo2.X, ref.X)
    np.testing.assert_array_equal(np.asarray(bo2.Ymin), np.asarray(ref.Ymin))


def test_batch_lies_never_reach_the_archive_and_constant_liar():
    bo = SO_BO(problem=_Constrained(), DoE_size=6, model_Y_dic=GP,
               model_C_dic=GP, seed=4, **ON_CPU)
    bo.run(1, IC="EI", constraint_handling="EV", train_iterations=40,
           popsize_DE=20, iterations_DE=15, IC_method="DE", batch_size=3,
           lie="min", verbose=False)
    assert bo.X.shape == (9, 1) and len(bo.Ymin) == 4
    # the surrogates were re-pointed at the real archive after the batch
    np.testing.assert_array_equal(bo.model_Y.data[0].numpy(), bo.X_train)
    with pytest.raises(ValueError, match="unknown lie"):
        bo.run(1, IC="EI", constraint_handling="EV", train_iterations=5,
               popsize_DE=5, iterations_DE=2, IC_method="DE", batch_size=2,
               lie="nope", verbose=False)
