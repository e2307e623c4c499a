"""Multi-fidelity BO with MF_BO: cheap + expensive sources, one loop (the
port's counterpart of ``examples/mf_bo.py``).

Per infill ``MF_BO`` refits a multi-fidelity surrogate on the
per-fidelity archives, maximizes EI on the highest-fidelity posterior, and
picks the evaluation fidelity by the BOCA cost-aware rule — query the cheap
source while it is still informative at the proposal, escalate to the
expensive one once it is resolved (or already archived there).

The demo pair is the canonical Forrester functions (d=1): the
low-fidelity source is a shifted/scaled distortion whose minimum (x~0.092)
is far from the true one (f(0.757) = -6.0207).

Run: ``python examples_torch/mf_bo.py [--cpu]``.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dgp_tpu_torch.bo.mf_bo import MF_BO  # noqa: E402
from dgp_tpu_torch.utils.test_functions import (  # noqa: E402
    forrester_high, forrester_low)


def main(infills=6, popsize_DE=60, iterations_DE=60, num_samples=100,
         model_dic=None, device=None, dtype=None):
    """The default AR(1) loop and a save/load round trip. Returns the
    loop."""
    # 8 cheap + 4 expensive DoE points; costs default to (0.1, 1.0).
    # The default surrogate is exact AR(1) co-kriging. Pass a model_dic
    # without 'type' (e.g. {'num_samples': 5, 'schedule': (200, 200, 400)})
    # for the reference's MF-DGP surrogate.
    bo = MF_BO(fidelities=[forrester_low, forrester_high],
               DoE_sizes=(8, 4), d=1, model_dic=model_dic, seed=0,
               device=device, dtype=dtype)
    print(f"DoE best (high fidelity): {bo.best_trace[0]:.4f} "
          f"(optimum -6.0207 at x=0.7572)")

    trace = bo.run(infills, popsize_DE=popsize_DE,
                   iterations_DE=iterations_DE, num_samples=num_samples,
                   verbose=True)
    print(f"after {infills} infills: best {trace[0]:.4f} -> {trace[-1]:.4f}"
          f" at x={np.round(bo.x_best, 4)}; "
          f"fidelities queried {bo.fidelity_choices}, "
          f"cost spent {bo.cost_spent:.2f} "
          f"(vs {float(infills):.2f} if all were high-fidelity)")

    # checkpoint/resume round-trips archives, traces, fidelity choices,
    # the seed stream's position and the surrogate spec
    path = os.path.join(tempfile.mkdtemp(), "mf_bo_example.npz")
    bo.save(path)
    bo2 = MF_BO.load(path, [forrester_low, forrester_high], device=device,
                     dtype=dtype)
    assert bo2.best_trace == list(trace)
    assert bo2.fidelity_choices == bo.fidelity_choices
    print("save/load round-trip OK")
    return bo


def constraint(x):
    """Feasible iff x >= 0.55 (keeps the optimum x* = 0.757)."""
    return 0.55 - np.asarray(x)[:, 0]


def constrained_demo(infills=3, popsize_DE=40, iterations_DE=40,
                     num_samples=50, model_dic=None, model_C_dic=None,
                     device=None, dtype=None):
    """Constrained MF-BO: constraints live in the top-fidelity input space,
    get their own exact-GPR surrogates on the pooled archive, and the best
    trace tracks only FEASIBLE top-fidelity values. Returns the loop."""
    bo = MF_BO(fidelities=[forrester_low, forrester_high],
               DoE_sizes=(8, 4), d=1, constraints=[constraint],
               model_dic=model_dic, model_C_dic=model_C_dic, seed=0,
               device=device, dtype=dtype)
    trace = bo.run(infills, constraint_handling="PoF", popsize_DE=popsize_DE,
                   iterations_DE=iterations_DE, num_samples=num_samples,
                   verbose=True)
    print(f"constrained best (feasible, high fidelity): {trace[-1]:.4f}")
    return bo


def low2d(x):
    x = np.asarray(x, dtype=float)
    return (np.sin(3.0 * x[:, :1]) + 0.5 * x[:, 1:2]).reshape(-1, 1)


def high4d(x):
    x = np.asarray(x, dtype=float)
    return (np.sin(3.0 * x[:, :1]) + 0.5 * x[:, 1:2]
            + 0.25 * x[:, 2:3] * x[:, 3:4]).reshape(-1, 1)


def variant_dims_demo(infills=2, schedule=(50, 20, 50), popsize_DE=30,
                      iterations_DE=30, num_samples=20, device=None,
                      dtype=None):
    """The embedded-mapping ('em') surrogate makes fidelity stacks with
    DIFFERENT input dimensions BO-drivable — here a 2-D cheap source under
    a 4-D expensive one, joined by a coordinate projection. Returns the
    loop."""
    rng = np.random.default_rng(0)
    X = [rng.uniform(0, 1, (10, 2)), rng.uniform(0, 1, (5, 4))]
    bo = MF_BO(fidelities=[low2d, high4d], X=X,
               Y=[low2d(X[0]), high4d(X[1])],
               model_dic={"type": "em", "num_samples": 3,
                          "schedule": schedule},
               projections=[lambda x: np.asarray(x)[:, :2]],
               seed=0, gamma=0.05, device=device, dtype=dtype)
    trace = bo.run(infills, popsize_DE=popsize_DE,
                   iterations_DE=iterations_DE, num_samples=num_samples,
                   verbose=True)
    print(f"variant-dims best (4-D high fidelity): {trace[-1]:.4f}")
    return bo


if __name__ == "__main__":
    device = "cpu" if "--cpu" in sys.argv else None
    main(device=device)
    constrained_demo(device=device)
    variant_dims_demo(device=device)
