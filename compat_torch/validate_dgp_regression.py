"""Scripted nb_DGP_regression validation through the PyTorch port:
``compat/validate_dgp_regression.py`` without JAX, on the card unless
``--cpu`` is given.

    python3 compat_torch/validate_dgp_regression.py [--fast] [--cpu] [--f64]

The notebook's data (legacy numpy seed 0: N = 50, M = 25, a step at 0.5
with 1 % noise) and a 3-layer non-whitened DGP (RBF, D = 1, 10 samples).
Asserts, as the JAX script does: 2,032 parameters and the initial ELBO
-85.98812279560475 within 1e-6, both of a float64 model (the ELBO at the
init is deterministic: every layer's marginal is its prior); then trains
the float32 model (``--f64``: float64) by optimize_nat_adam for 500 +
5,000 steps (``--fast``: 500 + 2,000; lr 0.01, betas 0.8 / 0.9, natural
gradients on the last layer) through the quadform kernels (#5, #6) and
the Cholesky-with-inverse kernel (#8), whose launches it prints, and
asserts a final ELBO > 100 (``--fast``: > 88) and a train RMSE < 0.05 of
the 100-sample moment-matched mean. Prints the wall seconds of training
and the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from compat_torch.validate_mf_dgp import device_line  # noqa: E402
from dgp_tpu_torch.config import default_float, resolve_device  # noqa: E402
from dgp_tpu_torch.models.dgp import DGP  # noqa: E402
from dgp_tpu_torch.ops import kernels as K  # noqa: E402
from dgp_tpu_torch.ops.cholesky import CholeskyInverse  # noqa: E402
from dgp_tpu_torch.ops.quadform import QuadForm  # noqa: E402

INITIAL_ELBO = -85.98812279560475


def data():
    np.random.seed(0)
    N, M = 50, 25
    X = np.random.uniform(0, 1, N)[:, None]
    Z = np.random.uniform(0, 1, M)[:, None]
    f = lambda x: 0.0 if x < 0.5 else 1.0
    Y = np.reshape([f(x) for x in X], X.shape) + np.random.randn(*X.shape) * 1e-2
    return X, Y, Z


def model(device=None, dtype=None):
    X, Y, Z = data()
    f = dict(dtype=dtype, device=device)
    kernels = [K.RBF.create(lengthscales=[1.0], variance=1.0, **f)
               for _ in range(3)]
    return DGP(X, Y, Z, kernels, [1, 1], num_samples=10, **f)


def launches():
    return (QuadForm.launches, QuadForm.backward_launches,
            CholeskyInverse.launches)


def main(fast=False, device=None, dtype=None):
    device = resolve_device(device)
    dtype = dtype or default_float()
    X, Y, _ = data()

    exact = model(device, torch.float64)
    n_params = exact.number_parameters()
    print(f"parameter count: {n_params} (oracle 2032)")
    assert n_params == 2032
    e0 = float(exact.ELBO())
    print(f"initial ELBO in float64: {e0:.11f} (oracle {INITIAL_ELBO})")
    assert abs(e0 - INITIAL_ELBO) < 1e-6

    m = model(device, dtype)
    print(f"initial ELBO in {dtype}: {float(m.ELBO()):.6f}")
    its2 = 2000 if fast else 5000
    before = launches()
    t0 = time.perf_counter()
    losses = m.optimize_nat_adam(
        iterations1=500, iterations2=its2, lr_adam=0.01, beta_1=0.8,
        beta_2=0.9, lr_gamma=0.01, ng_all=False, messages=500)
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    launched = tuple(a - b for a, b in zip(launches(), before))
    final = -float(losses[-1])
    print(f"final ELBO: {final:.2f} (oracle ~104-108 at 5000 steps); "
          f"{seconds:.1f} s for {len(losses)} steps on {m.device} in "
          f"{m.dtype}, launches #5 / #6 / #8 {launched} "
          f"({device_line(m.device.type)})")
    assert np.isfinite(losses).all()
    if m.device.type == "cuda" and dtype == torch.float32:
        assert min(launched) > 0, f"the kernels did not run: {launched}"
    assert final > (88.0 if fast else 100.0), final

    mean, var = m.predict(X, 100)
    rmse = float(np.sqrt(np.mean((mean - Y) ** 2)))
    print(f"train RMSE: {rmse:.4f}")
    assert rmse < 0.05
    print("nb_DGP_regression parity: OK")


if __name__ == "__main__":
    main(fast="--fast" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None,
         dtype=torch.float64 if "--f64" in sys.argv else None)
