"""Ask/tell BO with external evaluation (the port's counterpart of
``examples/ask_tell.py``).

The reference's SO_BO owns the objective (it calls problem.fun itself).
Real deployments often cannot hand the objective to the loop — simulations
run on a cluster, experiments run in a lab. The ask/tell interface splits
the loop: ``suggest`` returns the next batch of points, you evaluate them
however you like, ``observe`` feeds the results back. A suggest/observe
loop reproduces ``run``'s trajectory bit-exactly and checkpoints with
save/load like any other SO_BO/MO_BO state.

Run: ``python examples_torch/ask_tell.py [--cpu]``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dgp_tpu_torch import SO_BO  # noqa: E402


class Branin:
    """Branin-Hoo rescaled to the unit square; global minimum 0.397887."""

    constraint = False
    dim = 2

    def fun(self, u):
        u = np.asarray(u, dtype=float).reshape(-1, 2)
        x1, x2 = 15.0 * u[:, 0] - 5.0, 15.0 * u[:, 1]
        b, c = 5.1 / (4 * np.pi ** 2), 5.0 / np.pi
        f = ((x2 - b * x1 ** 2 + c * x1 - 6.0) ** 2
             + 10.0 * (1 - 1 / (8 * np.pi)) * np.cos(x1) + 10.0)
        return [f.reshape(-1, 1)]


def external_simulator(X):
    """Stand-in for the thing the loop cannot call (a cluster job, a lab
    run). Here it is just Branin evaluated 'elsewhere'."""
    return Branin().fun(X)[0]


SPEC = {"num_layers": 0, "kernels": "rbf"}  # exact GPR surrogate


def batches(rounds=4, batch_size=3, train_iterations=500, popsize_DE=60,
            iterations_DE=80, device=None, dtype=None):
    """Synchronous ask/tell: ``rounds`` batches of ``batch_size`` points
    (Kriging-Believer spread). Returns the loop."""
    bo = SO_BO(problem=Branin(), DoE_size=8, model_Y_dic=SPEC, seed=0,
               device=device, dtype=dtype)
    for round_ in range(rounds):
        # ask
        X_new = bo.suggest(batch_size=batch_size, IC="EI",
                           train_iterations=train_iterations,
                           popsize_DE=popsize_DE, iterations_DE=iterations_DE,
                           IC_method="DE")
        # ...ship X_new to the external evaluator...
        Y_new = external_simulator(X_new)
        # tell: feed the results back
        bo.observe(X_new, Y_new)
        print(f"round {round_}: best f = {bo.Ymin[-1]:.5f} "
              f"(true min 0.397887)")

    assert np.all(np.diff(bo.Ymin) <= 1e-12)
    print("final best:", float(bo.Ymin[-1]))
    return bo


def asynchronous(bo, train_iterations=300, popsize_DE=40, iterations_DE=60):
    """Genuinely asynchronous asking: suggested points persist in
    bo.pending as believer lies until observe() resolves them, so a lab can
    keep asking while evaluations are still in flight — consecutive
    suggest() calls propose different points, and a partial observe keeps
    the rest conditioning. Returns the pending counts seen (2, 1, 0)."""
    kw = dict(IC="EI", train_iterations=train_iterations,
              popsize_DE=popsize_DE, iterations_DE=iterations_DE,
              IC_method="DE")
    xa = bo.suggest(batch_size=1, **kw)   # job A submitted...
    xb = bo.suggest(batch_size=1, **kw)   # ...ask again before A returns
    seen = [bo.pending.shape[0]]
    print("in-flight proposals:", seen[-1])  # 2
    bo.observe(xb, external_simulator(xb))  # B finished first
    seen.append(bo.pending.shape[0])
    print("still pending:", seen[-1])        # 1 (job A)
    bo.observe(xa, external_simulator(xa))
    seen.append(bo.pending.shape[0])
    assert seen == [2, 1, 0]
    print("async best:", float(bo.Ymin[-1]))
    return seen


def main(device=None, dtype=None):
    asynchronous(batches(device=device, dtype=dtype))


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
