"""Scripted nb_mfdgp_improved validation (MF-DGP on Park) through the
PyTorch port: ``compat/validate_mf_dgp.py`` without JAX, on the card in
float32 unless ``--cpu`` is given.

    python3 compat_torch/validate_mf_dgp.py [--fast] [--cpu]

The full schedule (natural gradients, 1000 / 2000 / 6000 steps,
lr_adam=1e-3) asserts r2 >= 0.95 on a fresh LHS (the reference notebook
reaches r2 / rmse / mnll = 0.98467 / 0.59607 / 1.06168); ``--fast`` runs
300 / 400 / 800 steps at lr_adam=5e-3 and asserts r2 >= 0.85. Prints the
metrics, the wall seconds of training and prediction, and the card's name
and power limit.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dgp_tpu_torch.bo.doe import lhs  # noqa: E402
from dgp_tpu_torch.models.mf_dgp import MultiFidelityDeepGP  # noqa: E402
from dgp_tpu_torch.utils.test_functions import (  # noqa: E402
    calculate_metrics,
    park_high,
    park_low,
)


def device_line(device):
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(fast=False, device=None):
    X = [lhs(4, 30, seed=123), lhs(4, 5, seed=124)]
    Y = [park_low(X[0]), park_high(X[1])]
    x_test = lhs(4, 1000, seed=125)
    y_test = park_high(x_test)

    t0 = time.perf_counter()
    model = MultiFidelityDeepGP(X, Y, num_samples=10, device=device)
    if fast:
        model.optimize_nat_adam(lr_adam=0.005, iterations1=300,
                                iterations2=400, iterations3=800, messages=500)
        threshold = 0.85
    else:
        model.optimize_nat_adam(lr_adam=0.001, iterations1=1000,
                                iterations2=2000, iterations3=6000,
                                messages=500)
        threshold = 0.95
    mean, var = model.predict(x_test)
    seconds = time.perf_counter() - t0
    metrics = calculate_metrics(y_test, mean, var)
    print("metrics:", metrics,
          "(published r2/rmse/mnll: 0.98467/0.59607/1.06168)")
    print(f"wall {seconds:.1f} s for training and prediction on "
          f"{model.device} in {model.dtype} ({device_line(model.device.type)})")
    assert metrics["r2"] > threshold, metrics
    print("nb_mfdgp_improved parity: OK")


if __name__ == "__main__":
    main(fast="--fast" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
