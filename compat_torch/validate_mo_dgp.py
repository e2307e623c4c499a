"""Scripted nb_modgp validation (MO-DGP and EHVI on multi_obj_1D_4)
through the PyTorch port: ``compat/validate_mo_dgp.py`` without JAX, on the
card in float32 unless ``--cpu`` is given.

    python3 compat_torch/validate_mo_dgp.py [--fast] [--cpu]

The notebook's setup: multi_obj_1D_4 at 10 LHS points (seed 0), x and both
objectives normalized, the default Z, loop 2, 10 samples. ``--fast`` runs
optimize_nat_adam for 200 / 0 / 0 steps with ``restarts=1`` (the published
single run) and asserts finite losses whose last-20 mean is below the
first-20 mean. The default run trains 200 / 300 / 800 steps under the
shipping ``restarts="auto"``, asserts the same of the kept run's losses and
a train r2 (200 samples, moment-matched) above 0.7 for objective 0 and 0.4
for objective 1, and prints, beside it, the r2 of a ``restarts=1`` run on
the same DoE (which is also the auto run's first candidate). Then the
Pareto half: the front of the DoE ascending by objective 1, of at least two
points, the descending sort its reverse; its hypervolume against the
problem's box (published 39.29677 on the notebook's own DoE; this LHS DoE
is the JAX package's, so the value is the JAX script's); exact EHVI of the
trained model at the normalized candidates [[0], [0.5]] (S = 500 with
``--fast``, else 10,000) finite and non-negative; and optimize_EHVI by Adam
(200 steps at S = 200 with ``--fast``, else 1,000 at 1,000) inside the unit
box. Prints the wall seconds of each training and of the EHVI steps, and
the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from compat_torch.validate_mf_dgp import device_line  # noqa: E402
from dgp_tpu_torch.bo.doe import lhs  # noqa: E402
from dgp_tpu_torch.bo.ehvi import EHVI, HV_calcul, NDC, Y_ND, optimize_EHVI  # noqa: E402
from dgp_tpu_torch.bo.problems import multi_obj_1D_4  # noqa: E402
from dgp_tpu_torch.models.dgp import moment_matched  # noqa: E402
from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP  # noqa: E402

BANDS = (0.7, 0.4)   # train r2 of objectives 0 and 1, default schedule


def doe(n=10, raw=False):
    """multi_obj_1D_4 at n LHS points (seed 0), x and both objectives
    normalized; with ``raw`` also the raw objectives [n, 2]."""
    problem = multi_obj_1D_4()
    X_ = lhs(problem.dim, n, seed=0)
    F = np.array([np.ravel(problem.fun(x)) for x in X_])
    norm = lambda a: (a - a.mean(0)) / a.std(0)
    X = norm(X_)
    out = [X, X.copy()], [norm(F[:, :1]), norm(F[:, 1:])]
    return (*out, F) if raw else out


def train(X, Y, schedule, restarts, device):
    """A fresh model trained by optimize_nat_adam: (model, losses, wall
    seconds)."""
    model = MultiObjDeepGP(X, Y, loop=2, num_samples=10, device=device)
    t0 = time.perf_counter()
    losses = model.optimize_nat_adam(lr_adam=0.01, lr_gamma=0.01, messages=100,
                                     restarts=restarts, **schedule)
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    print(f"restarts={restarts!r}: ELBO {-losses[0]:.4g} -> "
          f"{-np.mean(losses[-20:]):.4g} in {seconds:.1f} s "
          "(published init -1.744e8 on its own DoE)")
    assert np.all(np.isfinite(losses))
    # single-sample losses are noisy: compare window means
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    return model, seconds


def train_r2(model, X, Y):
    """Per-objective train r2 of the moment-matched predict_f over 200
    samples."""
    r2 = []
    for obj, Yt in enumerate(Y):
        mean, _ = moment_matched(*model.predict_f(X[obj], S=200, objective=obj))
        mean = mean.cpu().numpy()
        r2.append(1 - np.sum((mean - Yt) ** 2) / np.sum((Yt - Yt.mean()) ** 2))
    return r2


def ehvi_half(model, Y, F, fast):
    """The front, its hypervolume and EHVI of the trained model (module
    docstring)."""
    problem = multi_obj_1D_4()
    Fr = [F[:, :1], F[:, 1:]]
    C = -np.ones((len(F), 1))
    ND = NDC(Fr, C)
    NDT = NDC(Fr, C, obj1_ascending=False)
    print("front (ascending):", ND)
    assert ND == NDT[::-1] and len(ND) >= 2
    assert all(Fr[0][ND[i]] <= Fr[0][ND[i + 1]] for i in range(len(ND) - 1))
    hv = HV_calcul(ND, Fr, problem.bounds)
    print("hypervolume:", hv, "(published 39.29677 on its own DoE)")
    assert hv > 0

    b, mu, sd = problem.bounds, F.mean(0), F.std(0)
    nadir = (float((b[2] - mu[0]) / sd[0]), float((b[3] - mu[1]) / sd[1]))
    ideal = (float((b[0] - mu[0]) / sd[0]), float((b[1] - mu[1]) / sd[1]))
    YND = Y_ND(Y, NDT, nadir=nadir, ideal=ideal)
    t0 = time.perf_counter()
    vals = EHVI(model, np.array([[0.0], [0.5]]), YND, corr=False,
                approximation="None", S=500 if fast else 10000)
    vals = vals.cpu().numpy()
    t1 = time.perf_counter()
    print("EHVI at [[0],[0.5]]:", vals.ravel(),
          f"in {t1 - t0:.2f} s (published [2.5798, 2.8441] on its own "
          "DoE/model)")
    assert np.all(np.isfinite(vals)) and np.all(vals >= 0)
    x_opt = optimize_EHVI(model, YND, method="Adam",
                          iterations_adam=200 if fast else 1000,
                          S=200 if fast else 1000)
    print(f"x_opt: {x_opt} by Adam in {time.perf_counter() - t1:.1f} s")
    assert 0.0 <= float(x_opt[0, 0]) <= 1.0


def main(fast=False, device=None):
    X, Y, F = doe(raw=True)
    if fast:
        model, _ = train(X, Y, dict(iterations1=200, iterations2=0,
                                    iterations3=0), 1, device)
    else:
        schedule = dict(iterations1=200, iterations2=300, iterations3=800)
        single, _ = train(X, Y, schedule, 1, device)
        r2_single = train_r2(single, X, Y)
        model, _ = train(X, Y, schedule, "auto", device)
        r2 = train_r2(model, X, Y)
        for obj, r2_min in enumerate(BANDS):
            print(f"objective {obj} train r2: {r2[obj]:.4f} under "
                  f"restarts=\"auto\" (oracle > {r2_min}); "
                  f"{r2_single[obj]:.4f} under restarts=1")
        assert all(r > r_min for r, r_min in zip(r2, BANDS)), r2
    ehvi_half(model, Y, F, fast)
    print(f"on {model.device} in {model.dtype} "
          f"({device_line(model.device.type)})")
    print("nb_modgp validation: OK")


if __name__ == "__main__":
    main(fast="--fast" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
