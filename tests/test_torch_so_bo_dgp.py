"""The single-objective BO driver of the port with the DGP surrogate (the
nb_dgp_BO constraint model: num_layers=2, three non-whitened SVGP layers) on CPU tensors: a
shortened run held to ``tests/test_bo.py``'s bands, PoF handling on the
trained surrogates, and a DGP whose Kuu cannot be factored giving a NaN
loss and the warning, as in ``dgp_tpu``."""

import numpy as np
import pytest
import torch

from dgp_tpu_torch.bo.acquisition import PoF
from dgp_tpu_torch.bo.so_bo import SO_BO, make_single_model

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_so_bo import GP, ON_CPU, _Constrained, assert_ymin_band


def test_so_bo_with_dgp_constraint_surrogate():
    """The notebook's DGP constraint model (num_layers=2, num_units=1) inside the loop with tiny budgets, EV handling and DE +
    Adam; then PoF handling on the trained surrogates, whose pick lies in
    the box."""
    spec = {"num_layers": 2, "num_units": 1, "kernels": "rbf",
            "num_samples": 3}
    bo = SO_BO(problem=_Constrained(), DoE_size=6, model_Y_dic=GP,
               model_C_dic=spec, seed=5, **ON_CPU)
    assert bo.model_C[0].name == "dgp"
    assert not bo.model_C[0].params.layers[0].white
    bo.run(1, IC="EI", constraint_handling="EV", train_iterations=20,
           popsize_DE=20, iterations_DE=10, IC_method="DE+Adam",
           iterations_adam=5, verbose=False)
    assert_ymin_band(bo, 1)
    pof = PoF(bo.feasible_0, 1)
    x = pof.optimize_with_IC(bo.IC, bo.model_Y, bo.model_C,
                             (bo.lw_n, bo.up_n), popsize_DE=20,
                             iterations_DE=10, iterations_adam=5,
                             method="DE+Adam", key=2)
    assert x.shape == (1, 1) and bo.lw_n[0] <= x[0, 0] <= bo.up_n[0]
    assert np.isfinite(pof.IC_optimized) and pof.IC_optimized <= 0


def test_dgp_elbo_with_a_failed_kuu_factor_is_nan_and_warns():
    """A Kuu whose factorization fails (here an inducing input gone NaN, as
    a diverged step leaves it): dgp_tpu's ELBO is NaN there
    (jnp.linalg.cholesky gives NaN, pinned in test_torch_cholesky.py) and
    its loops warn after the phase; the port raised from
    torch.linalg.cholesky mid-phase. Now its ELBO is NaN too, and Adam
    finishes the phase and warns, naming the first bad step."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(8, 1))
    Y = np.where(X > 0.25, 1.0, 0.0)
    spec = {"num_layers": 1, "num_units": 1, "kernels": "rbf",
            "num_samples": 2}
    model = make_single_model(spec, X, Y, **ON_CPU)
    assert np.isfinite(float(model.ELBO()))
    with torch.no_grad():
        model.params.layers[0].z[3, 0] = float("nan")
    assert np.isnan(float(model.ELBO()))
    with pytest.warns(RuntimeWarning, match="non-finite loss at step 0"):
        losses = model.optimize_adam(iterations=2, messages=0)
    assert torch.isnan(losses).all()
