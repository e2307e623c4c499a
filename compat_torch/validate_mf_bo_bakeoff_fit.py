"""Fit quality of the exact multi-fidelity surrogates through the PyTorch
port, on the card in float32 unless ``--cpu`` is given: AR(1) co-kriging
and NARGP on the four pairs of ``benchmarks/mf_bo_bakeoff.py`` (forrester
d = 1, park d = 4, branin_mf d = 2, borehole d = 8) at seed 0, each DoE
drawn as MF_BO draws it (lhs at seed 0 + fidelity) with Y under MF_BO's one
pooled normalization, trained at the bake-off's budget (8 starts x 2,000
Adam steps, lr 0.05, n_bucket 8), then on ``tests/test_nargp.py``'s
nonlinear pair (f_high = f_low^2) at that test's budget (8 x 1,500).

    python3 compat_torch/validate_mf_bo_bakeoff_fit.py [--cpu]

Prints, per pair and surrogate, the held-out r2 and RMSE (1,000 high-
fidelity points, lhs seed 99; the nonlinear pair's 200 at 300 samples, as
its test has them) and the seconds per fit, and the card's name and power
limit. It asserts only the nonlinear pair's band: r2(NARGP) > 0.9 and
r2(AR(1)) < 0.5.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgp_tpu_torch.bo.doe import lhs, mf_doe  # noqa: E402
from dgp_tpu_torch.models.cokriging import AR1CoKriging  # noqa: E402
from dgp_tpu_torch.models.dgp import moment_matched  # noqa: E402
from dgp_tpu_torch.models.nargp import NARGP  # noqa: E402
from dgp_tpu_torch.utils import test_functions as tf  # noqa: E402

# benchmarks/mf_bo_bakeoff.py's PROBLEMS: (fidelities, d, DoE sizes)
PAIRS = {
    "forrester": ((tf.forrester_low, tf.forrester_high), 1, (8, 4)),
    "park": ((tf.park_low, tf.park_high), 4, (24, 8)),
    "branin_mf": ((tf.branin_low, tf.branin_high), 2, (16, 6)),
    "borehole": ((tf.borehole_low, tf.borehole_high), 8, (40, 10)),
}
STARTS, ITERATIONS, LR, BUCKET, SAMPLES = 8, 2_000, 0.05, 8, 100


def device_line(device):
    if device.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fit(kind, X, Y, iterations, device):
    """A trained surrogate and its seconds of training."""
    cls = AR1CoKriging if kind == "ar1" else NARGP
    model = cls((X, Y), n_bucket=BUCKET, device=device)
    t0 = time.perf_counter()
    model.optimize(n_starts=STARTS, iterations=iterations, lr=LR, seed=0)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def scores(model, x_test, y_test, S, scale=1.0):
    """(r2, RMSE in the data's own units) of the highest fidelity's
    moment-matched latent mean."""
    m_s, v_s = model.predict_f(x_test.astype(np.float32), S=S)
    mean, _ = moment_matched(m_s.double(), v_s.double())
    err = mean.cpu().numpy() - y_test
    r2 = 1.0 - float(np.mean(err ** 2) / np.var(y_test))
    return r2, scale * float(np.sqrt(np.mean(err ** 2)))


def main(device=None):
    """``device`` None: the card (the models raise where there is none)."""
    for name, (fns, d, doe) in PAIRS.items():
        X, Y, (mu, sd) = mf_doe(fns, d, doe)
        x_test = lhs(d, 1_000, seed=99)
        y_test = (np.asarray(fns[-1](x_test), dtype=float).reshape(-1, 1)
                  - mu) / sd
        for kind in ("ar1", "nargp"):
            model, seconds = fit(kind, X, Y, ITERATIONS, device)
            r2, rmse = scores(model, x_test, y_test, SAMPLES, scale=sd)
            print(f"{name} (d {d}, DoE {doe}) {kind}: r2 {r2:.5f}, RMSE "
                  f"{rmse:.5g}, {seconds:.2f} s per fit ({STARTS} starts x "
                  f"{ITERATIONS} steps), joint NLL {model._nll:.4f}",
                  flush=True)

    X, Y, _ = mf_doe((tf.nonlinear_low, tf.nonlinear_high), 1, (30, 10),
                     normalize=False)
    x_test = lhs(1, 200, seed=99)
    r2 = {}
    for kind in ("nargp", "ar1"):
        model, seconds = fit(kind, X, Y, 1_500, device)
        r2[kind], rmse = scores(model, x_test, tf.nonlinear_high(x_test), 300)
        print(f"nonlinear (f_high = f_low^2, DoE (30, 10)) {kind}: r2 "
              f"{r2[kind]:.5f}, RMSE {rmse:.5g}, {seconds:.2f} s per fit "
              f"({STARTS} starts x 1500 steps)", flush=True)
    print(f"on {model.device} in {model.dtype} "
          f"({device_line(model.device)})")
    assert r2["nargp"] > 0.9 and r2["ar1"] < 0.5, r2
    print("nonlinear pair band (r2 NARGP > 0.9, AR(1) < 0.5): OK")


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
