"""dgp_tpu_torch quickstart: the five reference workflows in one script
(the port's counterpart of ``examples/quickstart.py``).

Each section mirrors one of the reference notebooks; the full
assertion-bearing versions live in ``compat_torch/``. Runs on the card:
``python examples_torch/quickstart.py``; ``--cpu`` runs it on the CPU
(without a card and without ``--cpu`` it raises, as the entry points do).
Every section is a function taking ``device``, ``dtype`` and its budgets
(steps, infills, DE sizes); the widths are the example's.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import dgp_tpu_torch as dgp  # noqa: E402
from dgp_tpu_torch.bo.doe import lhs  # noqa: E402
from dgp_tpu_torch.bo.ehvi import EHVI, NDC, Y_ND  # noqa: E402
from dgp_tpu_torch.ops import kernels as K  # noqa: E402


def regression_data():
    """The 1-D step function of nb_DGP_regression: (X, Y, Z)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (50, 1))
    Y = (X > 0.5).astype(float) + 0.01 * rng.normal(size=X.shape)
    Z = np.linspace(0, 1, 25)[:, None]
    return X, Y, Z


def regression_model(device=None, dtype=None):
    X, Y, Z = regression_data()
    kernels = [K.RBF.create(lengthscales=[1.0]) for _ in range(3)]
    return dgp.DGP(X, Y, Z, kernels, num_units=[1, 1], num_samples=10,
                   device=device, dtype=dtype)


def dgp_regression(iterations=(200, 400), samples=100, device=None,
                   dtype=None):
    """nb_DGP_regression: 3-layer DGP on the 1-D step function. Returns
    (model, losses, train RMSE)."""
    print("== DGP regression ==")
    X, Y, _ = regression_data()
    model = regression_model(device, dtype)
    print(f"initial ELBO: {float(model.ELBO()):.2f}")
    losses = model.optimize_nat_adam(
        iterations1=iterations[0], iterations2=iterations[1], lr_adam=0.01,
        beta_1=0.8, beta_2=0.9, ng_all=False, messages=200)
    mean, var = model.predict(X, num_samples=samples)
    rmse = float(np.sqrt(np.mean((mean - Y) ** 2)))
    print(f"train RMSE: {rmse:.4f}\n")
    return model, losses, rmse


def park_data():
    """The Park pair of nb_mfdgp_improved: 30 low- and 5 high-fidelity
    rows in 4-D."""
    from dgp_tpu_torch.utils.test_functions import park_high, park_low

    X = [lhs(4, 30, seed=1), lhs(4, 5, seed=2)]
    return X, [park_low(X[0]), park_high(X[1])]


def mf_model(device=None, dtype=None):
    X, Y = park_data()
    return dgp.MultiFidelityDeepGP(X, Y, num_samples=5, device=device,
                                   dtype=dtype)


def multi_fidelity(iterations=(100, 100, 200), device=None, dtype=None):
    """nb_mfdgp_improved: MF-DGP on the Park function. Returns (model,
    losses, metrics on 200 held-out rows)."""
    print("== Multi-fidelity DGP ==")
    from dgp_tpu_torch.utils.test_functions import calculate_metrics, park_high

    model = mf_model(device, dtype)
    losses = model.optimize_nat_adam(
        lr_adam=0.005, iterations1=iterations[0], iterations2=iterations[1],
        iterations3=iterations[2], messages=200)
    x_test = lhs(4, 200, seed=3)
    mean, var = model.predict(x_test)
    metrics = calculate_metrics(park_high(x_test), mean, var)
    print("metrics:", metrics, "\n")
    return model, losses, metrics


class Problem:
    """min (x - 0.5)^2 s.t. step(x - 0.25) <= 0 (optimum 0.0625)."""

    constraint = True
    dim = 1

    def fun(self, x):
        return [(x - 0.5) ** 2, np.where(x > 0.25, 1.0, 0.0)]


GP_SPEC = {"num_layers": 0, "kernels": "rbf"}


def bayesian_optimization(infills=3, train_iterations=200, popsize_DE=50,
                          iterations_DE=50, device=None, dtype=None):
    """nb_dgp_BO: constrained BO with EI + expected violation on exact GPR
    surrogates. Returns the loop."""
    print("== Bayesian optimization ==")
    bo = dgp.SO_BO(problem=Problem(), DoE_size=6, model_Y_dic=GP_SPEC,
                   model_C_dic=GP_SPEC, seed=1, device=device, dtype=dtype)
    bo.run(infills, IC="EI", constraint_handling="EV",
           train_iterations=train_iterations, popsize_DE=popsize_DE,
           iterations_DE=iterations_DE, IC_method="DE", verbose=False)
    print("Ymin trace:", np.round(np.asarray(bo.Ymin, float), 5),
          "(optimum 0.0625)\n")
    return bo


def mo_data():
    """multi_obj_1D_4 at 10 LHS rows: (normalized X, normalized objectives,
    raw objectives)."""
    from dgp_tpu_torch.bo.problems import multi_obj_1D_4

    problem = multi_obj_1D_4()
    X_ = lhs(1, 10, seed=0)
    F = [np.concatenate([problem.fun(x)[i] for x in X_]).reshape(-1, 1)
         for i in (0, 1)]
    Xn = (X_ - X_.mean(0)) / X_.std(0)
    Yn = [(f - f.mean(0)) / f.std(0) for f in F]
    return Xn, Yn, F


def mo_model(device=None, dtype=None):
    Xn, Yn, _ = mo_data()
    return dgp.MultiObjDeepGP([Xn, Xn.copy()], Yn, loop=2, num_samples=5,
                              device=device, dtype=dtype)


def multi_objective(iterations=100, S=500, device=None, dtype=None):
    """nb_modgp: MO-DGP + EHVI on a bi-objective problem. Returns (model,
    losses, EHVI at two points)."""
    print("== Multi-objective DGP + EHVI ==")
    _, Yn, F = mo_data()
    model = mo_model(device, dtype)
    losses = model.optimize_nat_adam(iterations1=iterations, iterations2=0,
                                     iterations3=0, messages=100)
    nd_desc = NDC(F, -np.ones((10, 1)), obj1_ascending=False)
    ynd = Y_ND(Yn, nd_desc, nadir=(4.0, 4.0), ideal=(-4.0, -4.0))
    vals = np.asarray(EHVI(model, np.array([[0.0], [0.5]]), ynd, corr=False,
                           S=S).cpu()).ravel()
    print("EHVI at [[0], [0.5]]:", np.round(vals, 4), "\n")
    return model, losses, vals


def main(device=None, dtype=None):
    dgp_regression(device=device, dtype=dtype)
    multi_fidelity(device=device, dtype=dtype)
    bayesian_optimization(device=device, dtype=dtype)
    multi_objective(device=device, dtype=dtype)
    print("quickstart: all sections completed")


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
