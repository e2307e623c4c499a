"""Scripted nb_mfdgpem validation (MF-DGP-EM on Park_VD) through the
PyTorch port: ``compat/validate_mf_dgp_em.py`` without JAX, on the card in
float32 unless ``--cpu`` is given.

    python3 compat_torch/validate_mf_dgp_em.py [--fast] [--cpu]

Park_VD: a 2-D low fidelity of 30 points (LHS seed 123), a 4-D high
fidelity of 6 (LHS seed 0), X_red the first two columns of the high
fidelity's inputs, 100 samples. The full schedule (natural gradients,
0 / 3000 / 15000 steps) asserts r2 > 0.8 (the reference notebook reaches
r2 / rmse / mnll = 0.89265 / 1.49782 / 2.07844); ``--fast`` runs
0 / 400 / 800 steps and asserts r2 > 0.5. Prints the metrics, the wall
seconds of training and prediction, and the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from compat_torch.validate_mf_dgp import device_line  # noqa: E402
from dgp_tpu_torch.bo.doe import lhs  # noqa: E402
from dgp_tpu_torch.models.mf_dgp_em import MultiFidelityDeepGP_EM  # noqa: E402
from dgp_tpu_torch.utils.test_functions import (  # noqa: E402
    calculate_metrics,
    park_vd_high,
    park_vd_low,
)


def main(fast=False, device=None):
    X = [lhs(2, 30, seed=123), lhs(4, 6, seed=0)]
    Y = [park_vd_low(X[0]), park_vd_high(X[1])]
    X_red = [X[1][:, :2]]
    x_test = lhs(4, 1000, seed=321)
    y_test = park_vd_high(x_test)

    t0 = time.perf_counter()
    model = MultiFidelityDeepGP_EM(X, Y, X_red, num_samples=100, device=device)
    if fast:
        model.optimize_nat_adam(iterations1=0, iterations2=400,
                                iterations3=800, messages=400)
        threshold = 0.5
    else:
        model.optimize_nat_adam(iterations1=0, iterations2=3000,
                                iterations3=15000, messages=1000)
        threshold = 0.8
    mean, var = model.predict(x_test)
    seconds = time.perf_counter() - t0
    metrics = calculate_metrics(y_test, mean, var)
    print("metrics:", metrics,
          "(published r2/rmse/mnll: 0.89265/1.49782/2.07844)")
    print(f"wall {seconds:.1f} s for training and prediction on "
          f"{model.device} in {model.dtype} ({device_line(model.device.type)})")
    assert metrics["r2"] > threshold, metrics
    print("nb_mfdgpem parity: OK")


if __name__ == "__main__":
    main(fast="--fast" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
