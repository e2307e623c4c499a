"""Multi-repetition MF-DGP benchmark through the PyTorch port
(``compat/benchmark_mf.py`` without JAX; on the card in float32 unless
``--cpu`` is given).

Counterpart of nb_mfdgp_improved's ``do_benchmark`` (cell 4): repeat the
Park-function experiment over several DoE seeds and report mean +/- std of
r2 / rmse / mnll (the reference's 20-seed study published rep-1 as
r2/mnll/rmse = 0.98792 / 1.14255 / 0.52562, cell 11). The same seeds and
DoEs as the JAX script: 30 low-fidelity rows (LHS seed 123), 5 high
(seed 1000 + r), 1,000 test rows (seed 11000 + r), the model seeded
1000 + r. The default is the fast schedule (200 / 300 / 600 steps at
lr_adam 5e-3); ``--full`` runs 1000 / 2000 / 6000 at 1e-3.

    python3 compat_torch/benchmark_mf.py [--reps R] [--full] [--cpu]

Prints each rep's metrics and seconds, the summary, and the card's name
and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from compat_torch.validate_mf_dgp import device_line  # noqa: E402
from dgp_tpu_torch.bo.doe import lhs  # noqa: E402
from dgp_tpu_torch.models.mf_dgp import MultiFidelityDeepGP  # noqa: E402
from dgp_tpu_torch.utils.test_functions import (  # noqa: E402
    calculate_metrics,
    park_high,
    park_low,
)

FAST = dict(lr_adam=0.005, iterations1=200, iterations2=300, iterations3=600)
FULL = dict(lr_adam=0.001, iterations1=1000, iterations2=2000,
            iterations3=6000)


def one_rep(seed, fast, device=None):
    """One repetition at ``seed``: the metrics on its 1,000 test rows."""
    X = [lhs(4, 30, seed=123), lhs(4, 5, seed=seed)]
    Y = [park_low(X[0]), park_high(X[1])]
    x_test = lhs(4, 1000, seed=seed + 10_000)
    y_test = park_high(x_test)
    model = MultiFidelityDeepGP(X, Y, num_samples=10, seed=seed,
                                device=device)
    model.optimize_nat_adam(**(FAST if fast else FULL), messages=0)
    mean, var = model.predict(x_test)
    return calculate_metrics(y_test, mean, var)


def main(reps=5, fast=True, device=None):
    rows = []
    for r in range(reps):
        t0 = time.perf_counter()
        m = one_rep(1000 + r, fast, device)
        print(f"rep {r}: r2={m['r2']:.5f} rmse={m['rmse']:.5f} "
              f"mnll={m['mnll']:.5f} ({time.perf_counter() - t0:.1f} s)")
        rows.append(m)
    for k in ("r2", "rmse", "mnll"):
        vals = np.array([m[k] for m in rows])
        print(f"{k}: {vals.mean():.5f} +/- {vals.std():.5f}")
    print("(published rep-1: r2 0.98792, rmse 0.52562, mnll 1.14255)")
    print(device_line(device))
    return rows


if __name__ == "__main__":
    reps = 5
    if "--reps" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--reps") + 1])
    main(reps=reps, fast="--full" not in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
