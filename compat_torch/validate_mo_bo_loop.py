"""The complete multi-objective BO loop (nb_modgp cells 19-33) through the
PyTorch port: ``compat/validate_mo_bo_loop.py`` without JAX, on the card in
float32 unless ``--cpu`` is given.

    python3 compat_torch/validate_mo_bo_loop.py [--fast | --full] [--cpu]

Iterate three times: train the coupled MO-DGP (loop 2, 5 samples,
``restarts=1``) -> the non-dominated front and its padded YND -> maximize
exact EHVI by DE -> evaluate multi_obj_1D_4 at the pick -> append. Asserts
the dominated hypervolume (against the problem's reference box) never
decreases and ends above its start. ``--fast`` (the default) trains
(100, 0, 0) steps and searches by DE 60 x 60 at S = 200; ``--full`` trains
(200, 0, 0) and searches by DE 300 x 400 at S = 1,000. Prints the
hypervolume trace, the seconds of each iteration's training and search, and
the card's name and power limit.

Like the notebook (and the JAX script), the search runs over the unit box
in normalized input coordinates, which confines proposals to [mean,
mean + std]; the ``MO_BO`` driver searches the mapped domain box instead.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from compat_torch.validate_mf_dgp import device_line  # noqa: E402
from dgp_tpu_torch.bo.doe import lhs  # noqa: E402
from dgp_tpu_torch.bo.ehvi import HV_calcul, NDC, Y_ND, optimize_EHVI  # noqa: E402
from dgp_tpu_torch.bo.problems import multi_obj_1D_4  # noqa: E402
from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP  # noqa: E402


def main(iterations=3, fast=True, device=None):
    problem = multi_obj_1D_4()
    d = problem.dim
    X_ = lhs(d, 10 * d, seed=0)
    F = [np.concatenate([problem.fun(x)[i] for x in X_]).reshape(-1, 1)
         for i in (0, 1)]
    C_ = -np.ones((len(X_), 1))
    hv_trace = []
    its = (100, 0, 0) if fast else (200, 0, 0)
    search = (dict(popsize_DE=60, iterations_DE=60, S=200) if fast
              else dict(popsize_DE=300, iterations_DE=400, S=1000))
    model = None

    for it in range(iterations):
        ND = NDC(F, C_)
        hv = HV_calcul(ND, F, problem.bounds)
        hv_trace.append(hv)
        print(f"iter {it}: n={len(X_)} front={ND} HV={hv:.5f}")

        Xn = (X_ - X_.mean(0)) / X_.std(0)
        Yn = [(f - f.mean(0)) / f.std(0) for f in F]
        model = MultiObjDeepGP([Xn, Xn.copy()], Yn, loop=2, num_samples=5,
                               seed=it, device=device)
        t0 = time.perf_counter()
        # restarts=1: this script mirrors the bare notebook cells; the
        # "auto" escalation is held by the smoke run's mo phase
        model.optimize_nat_adam(iterations1=its[0], iterations2=its[1],
                                iterations3=its[2], messages=0, restarts=1)
        t1 = time.perf_counter()

        NDT = NDC(F, C_, obj1_ascending=False)
        b = problem.bounds
        nadir = (float((b[2] - F[0].mean()) / F[0].std()),
                 float((b[3] - F[1].mean()) / F[1].std()))
        ideal = (float((b[0] - F[0].mean()) / F[0].std()),
                 float((b[1] - F[1].mean()) / F[1].std()))
        YND = Y_ND(Yn, NDT, nadir=nadir, ideal=ideal)
        x_opt_n = optimize_EHVI(model, YND, method="DE", key=100 + it,
                                **search)
        t2 = time.perf_counter()
        x_new = np.clip(X_.std(0) * x_opt_n + X_.mean(0), 0.0, 1.0)
        f_new = [np.asarray(v).reshape(())
                 for v in problem.fun(x_new.reshape(-1))]
        print(f"  new point x={float(x_new[0, 0]):.4f} "
              f"f=({float(f_new[0]):.4f}, {float(f_new[1]):.4f}); training "
              f"{t1 - t0:.1f} s, EHVI search {t2 - t1:.1f} s")
        X_ = np.vstack([X_, x_new])
        F = [np.vstack([F[i], np.reshape(f_new[i], (1, 1))]) for i in (0, 1)]
        C_ = np.vstack([C_, [[-1.0]]])

    ND = NDC(F, C_)
    hv_final = HV_calcul(ND, F, problem.bounds)
    hv_trace.append(hv_final)
    print("HV trace:", np.round(hv_trace, 5))
    assert all(b >= a - 1e-12 for a, b in zip(hv_trace, hv_trace[1:])), \
        "hypervolume must be non-decreasing"
    assert hv_final > hv_trace[0], "EHVI iterations should grow the front"
    print(f"on {model.device} in {model.dtype} "
          f"({device_line(model.device.type)})")
    print("MO-BO loop validation: OK")


if __name__ == "__main__":
    main(fast="--full" not in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
