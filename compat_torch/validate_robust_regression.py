"""Student-t robust regression validation through the PyTorch port: the
oracle of ``tests/test_likelihoods.py::
test_student_t_dgp_robust_regression_end_to_end`` at its full budget,
without JAX, on the card in float32 unless ``--cpu`` (or ``--f64``,
float64) is given.

    python3 compat_torch/validate_robust_regression.py [--cpu] [--f64]

60 rows of sin(4x) with 5 % noise and every tenth row moved by +-3 (gross
outliers); a 2-layer DGP (Z = X[::3], RBF lengthscales 0.3, hidden width
1, 4 samples) trained by optimize_nat_adam (300 + 700 steps, lr_adam 0.02,
lr_gamma 0.05, natural gradients on the last layer) once with a
``StudentT(scale 0.1)`` head and once with a ``Gaussian(0.1)`` head.
Asserts that the Student-t model fits the inliers better (inlier RMSE of
the 100-sample moment-matched mean) and below 0.42 (the JAX package
measured 0.350 against 0.446). Prints both RMSEs, the wall seconds of each
fit and the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from compat_torch.validate_mf_dgp import device_line  # noqa: E402
from dgp_tpu_torch.config import default_float, resolve_device  # noqa: E402
from dgp_tpu_torch.layers.initializations import init_layers_linear  # noqa: E402
from dgp_tpu_torch.models.dgp import DGP  # noqa: E402
from dgp_tpu_torch.ops import kernels as K  # noqa: E402
from dgp_tpu_torch.ops.likelihoods import Gaussian, StudentT  # noqa: E402

BAND = 0.42           # the Student-t model's inlier RMSE
SCHEDULE = (300, 700)


def data():
    """(X, Y, inliers): 60 rows, every tenth an outlier."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, size=(60, 1))
    Y = np.sin(4 * X) + 0.05 * rng.normal(size=X.shape)
    Y[::10] += rng.choice([-3.0, 3.0], size=Y[::10].shape)  # outliers
    inliers = np.ones(len(X), dtype=bool)
    inliers[::10] = False
    return X, Y, inliers


def model(head, device=None, dtype=None):
    """The configuration's DGP with a ``StudentT(scale 0.1)`` head
    (``head`` "t") or a ``Gaussian(0.1)`` one ("gaussian")."""
    X, Y, _ = data()
    device = resolve_device(device)
    dtype = dtype or default_float()
    f = dict(dtype=dtype, device=device)
    likelihood = (StudentT.create(scale=0.1, **f) if head == "t"
                  else Gaussian.create(0.1, **f))
    kernels = [K.RBF.create(lengthscales=[0.3], **f) for _ in range(2)]
    layers = init_layers_linear(X, Y, X[::3].copy(), kernels, [1], **f)
    return DGP.from_layers(X, Y, layers, likelihood=likelihood, num_samples=4,
                           seed=0, device=device, dtype=dtype)


def fit(head, device=None, dtype=None):
    """The inlier RMSE of one fit of :func:`model`."""
    X, Y, inliers = data()
    m = model(head, device, dtype)
    t0 = time.perf_counter()
    losses = m.optimize_nat_adam(iterations1=SCHEDULE[0],
                                 iterations2=SCHEDULE[1], lr_adam=0.02,
                                 lr_gamma=0.05, ng_all=False, messages=0)
    assert bool(torch.isfinite(losses).all()), f"{head}: non-finite loss"
    mean, _ = m.predict(X, 100)
    seconds = time.perf_counter() - t0
    rmse = float(np.sqrt(np.mean((mean[inliers] - Y[inliers]) ** 2)))
    print(f"{head} head: inlier RMSE {rmse:.4f}, loss {float(losses[0]):.3f} "
          f"-> {float(losses[-1]):.3f}, {seconds:.1f} s for "
          f"{sum(SCHEDULE)} steps and a 100-sample predict on {m.device} in "
          f"{m.dtype} ({device_line(m.device.type)})")
    return rmse


def main(device=None, dtype=None):
    rmse_t = fit("t", device=device, dtype=dtype)
    rmse_g = fit("gaussian", device=device, dtype=dtype)
    assert rmse_t < rmse_g, (rmse_t, rmse_g)
    assert rmse_t < BAND, rmse_t
    print(f"robust regression validation: OK (Student-t {rmse_t:.4f} < "
          f"Gaussian {rmse_g:.4f}; JAX package 0.350 against 0.446)")


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None,
         dtype=torch.float64 if "--f64" in sys.argv else None)
