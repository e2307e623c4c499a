"""DGP layer-stack initialization (counterpart of
``dgp_tpu/layers/initializations.py``): per-layer mean functions are
Identity when dim_in == dim_out, a frozen Linear with the PCA projection
W = V^T[:dim_out] when stepping down, and a frozen identity+zero-padding
Linear when stepping up; X/Z are propagated through W between layers."""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_float
from ..ops.means import Identity, LinearMean, Zero
from .svgp import make_svgp_layer


def init_layers_linear(X, Y, Z, kernels, num_units, num_outputs=None,
                       mean_function=None, white=False, dtype=None,
                       device=None):
    """Build the list of SVGPLayers for a doubly-stochastic DGP.

    :param kernels: list of length len(num_units) + 1 Kernel modules.
    :param num_units: hidden-layer widths (list of int).
    """
    X = np.asarray(X)
    Y = np.asarray(Y)
    Z = np.asarray(Z)
    if len(kernels) != len(num_units) + 1:
        raise ValueError(
            f"need len(num_units)+1 = {len(num_units) + 1} kernels "
            f"(one per hidden layer plus the output layer), got {len(kernels)}"
        )
    num_outputs = num_outputs or Y.shape[1]
    dtype = dtype or default_float()

    layers = []
    dims = [X.shape[1]] + list(num_units)
    X_running, Z_running = X.copy(), Z.copy()
    for dim_in, dim_out, kern in zip(dims[:-1], dims[1:], kernels[:-1]):
        if dim_in == dim_out:
            mf = Identity()
        else:
            if dim_in > dim_out:  # stepping down: PCA projection
                _, _, V = np.linalg.svd(X_running, full_matrices=False)
                W = V[:dim_out, :].T
            else:  # stepping up: identity + zero padding
                W = np.concatenate(
                    [np.eye(dim_in), np.zeros((dim_in, dim_out - dim_in))],
                    axis=1)
            mf = LinearMean(torch.as_tensor(W, dtype=dtype, device=device))
        layers.append(make_svgp_layer(kern, Z_running, dim_out, mf,
                                      white=white, dtype=dtype, device=device))
        if dim_in != dim_out:
            Z_running = Z_running @ W
            X_running = X_running @ W

    final_mean = mean_function if mean_function is not None else Zero(num_outputs)
    layers.append(make_svgp_layer(kernels[-1], Z_running, num_outputs,
                                  final_mean, white=white, dtype=dtype,
                                  device=device))
    return layers
