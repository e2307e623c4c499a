"""Bernoulli-DGP classification validation through the PyTorch port:
``compat/validate_classification.py`` without JAX, on the card in float32
unless ``--cpu`` (or ``--f64``, float64) is given.

    python3 compat_torch/validate_classification.py [--fast] [--cpu] [--f64]

The configuration: 120 training and 200 held-out rows (seeds 0 and 1) of
two diagonal bands with ~10 % label noise, Z = X[::4] (M = 30), two RBF
layers (hidden width 2, non-whitened), the probit ``Bernoulli`` head with
Gauss-Hermite quadrature, 5 samples, Adam for 800 steps (``--fast``: 500)
at lr 0.02. Asserts, as the JAX script does: every predicted probability
in [0, 1]; accuracy >= 0.85 train and >= 0.80 test (``--fast``: 0.80 and
0.75); a held-out mean log-density above both chance (log 0.5) and the
base-rate predictor. Prints the wall seconds of training and of the
requests, and the card's name and power limit.
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
from dgp_tpu_torch.ops.likelihoods import Bernoulli  # noqa: E402


def make_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, 2))
    # two diagonal bands: a nonlinear decision boundary, ~10 % label noise
    logits = np.sin(6.0 * X[:, :1]) + 2.0 * (X[:, 1:] - 0.5)
    Y = (logits + 0.1 * rng.normal(size=logits.shape) > 0).astype(float)
    return X, Y


def classifier(X, Y, white=False, device=None, dtype=None):
    """The configuration's DGP: Z = X[::4], two RBF layers (lengthscales
    0.5), hidden width 2, the Bernoulli head, 5 samples."""
    device = resolve_device(device)
    dtype = dtype or default_float()
    f = dict(dtype=dtype, device=device)
    kernels = [K.RBF.create(variance=1.0, lengthscales=[0.5, 0.5], **f)
               for _ in range(2)]
    layers = init_layers_linear(X, Y, X[::4].copy(), kernels, [2],
                                white=white, **f)
    return DGP.from_layers(X, Y, layers, likelihood=Bernoulli(),
                           num_samples=5, seed=0, device=device, dtype=dtype)


def main(fast=False, device=None, dtype=None):
    X, Y = make_data(120, seed=0)
    Xt, Yt = make_data(200, seed=1)
    model = classifier(X, Y, device=device, dtype=dtype)
    t0 = time.perf_counter()
    losses = model.optimize_adam(iterations=500 if fast else 800, lr=0.02,
                                 messages=200)
    losses = losses.cpu().numpy()
    train_s = time.perf_counter() - t0
    assert np.isfinite(losses).all(), "non-finite training loss"

    def score(Xs, Ys, label):
        p_mean, _ = model.predict(Xs, 100)  # moment-matched P(y=1 | x)
        assert np.all(p_mean >= -1e-9) and np.all(p_mean <= 1 + 1e-9), \
            "predicted probabilities left [0, 1]"
        acc = float(np.mean((p_mean > 0.5) == (Ys > 0.5)))
        logd = float(model.predict_density(Xs, Ys, 100).mean())
        print(f"{label}: accuracy {acc:.3f}, mean log-density {logd:.3f}")
        return acc, logd

    t0 = time.perf_counter()
    acc_tr, _ = score(X, Y, "train")
    acc_te, logd_te = score(Xt, Yt, "test")
    request_s = time.perf_counter() - t0
    print(f"wall {train_s:.1f} s for {len(losses)} Adam steps (loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}), {request_s:.2f} s for two "
          f"predict and two predict_density requests, on {model.device} in "
          f"{model.dtype} ({device_line(model.device.type)})")

    # --fast stops at 500 Adam steps, before the second band is fully
    # carved: looser floors
    acc_tr_min, acc_te_min = (0.80, 0.75) if fast else (0.85, 0.80)
    assert acc_tr >= acc_tr_min, f"train accuracy {acc_tr} < {acc_tr_min}"
    assert acc_te >= acc_te_min, f"test accuracy {acc_te} < {acc_te_min}"
    # better than chance and than the base-rate (constant-p) predictor
    rate = float(Yt.mean())
    base = float(np.mean(np.log(np.where(Yt > 0.5, rate, 1.0 - rate))))
    assert logd_te > np.log(0.5), f"test log-density {logd_te} <= chance"
    assert logd_te > base, f"test log-density {logd_te} <= base rate {base}"
    print("classification validation: OK "
          f"(chance {np.log(0.5):.3f}, base-rate {base:.3f})")


if __name__ == "__main__":
    main(fast="--fast" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None,
         dtype=torch.float64 if "--f64" in sys.argv else None)
