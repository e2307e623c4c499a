"""Bernoulli-DGP binary classification end to end (the port's counterpart
of ``examples/classification.py``).

The probit Bernoulli head (``ops.likelihoods.Bernoulli``, Gauss-Hermite
quadrature) drives a 2-layer DGP classifier through the standard training
and prediction APIs. Run: ``python examples_torch/classification.py
[--cpu]``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dgp_tpu_torch.config import resolve_device  # noqa: E402
from dgp_tpu_torch.layers.initializations import init_layers_linear  # noqa: E402
from dgp_tpu_torch.models.dgp import DGP  # noqa: E402
from dgp_tpu_torch.ops import kernels as K  # noqa: E402
from dgp_tpu_torch.ops.likelihoods import Bernoulli  # noqa: E402


def make_data(n=120, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, 2))
    # two diagonal bands: nonlinear decision boundary
    logits = np.sin(6.0 * X[:, :1]) + 2.0 * (X[:, 1:] - 0.5)
    Y = (logits + 0.1 * rng.normal(size=logits.shape) > 0).astype(float)
    return X, Y


def model(device=None, dtype=None):
    """The 2-layer classifier (Z = X[::4], hidden width 2, 5 samples)."""
    X, Y = make_data()
    Z = X[::4].copy()
    kernels = [
        K.RBF.create(variance=1.0, lengthscales=[0.5, 0.5]),
        K.RBF.create(variance=1.0, lengthscales=[0.5, 0.5]),
    ]
    device = resolve_device(device)
    layers = init_layers_linear(X, Y, Z, kernels, [2], dtype=dtype,
                                device=device)
    return DGP.from_layers(X, Y, layers, likelihood=Bernoulli(),
                           num_samples=5, seed=0, device=device,
                           dtype=dtype)


def main(iterations=800, samples=100, device=None, dtype=None):
    """Train and score the classifier: (accuracy, mean log-density,
    losses)."""
    clf = model(device, dtype)
    X, Y = make_data()
    losses = clf.optimize_adam(iterations=iterations, lr=0.02, messages=200)
    p_mean, p_var = clf.predict(X, samples)  # moment-matched P(y=1 | x)
    acc = float(np.mean((p_mean > 0.5) == (np.asarray(Y) > 0.5)))
    # average predictive log-density of the held-in labels
    logd = clf.predict_density(X, Y, samples).cpu().numpy()
    print(f"final -ELBO: {float(losses[-1]):.3f}")
    print(f"train accuracy: {acc:.3f}")
    print(f"mean predictive log-density: {logd.mean():.3f}")
    return acc, float(logd.mean()), losses


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
