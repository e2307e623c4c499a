"""The system under test: dgp_tpu_torch's DGP, built through its
constructor from the configuration, with every trained tensor then set to
the values the benchmark made (``inputs.model_values``)."""

from __future__ import annotations

import torch

from .counts.dgp import shapes
from .inputs import dtype_of, model_seed


def build_kernels(device):
    """Build the port's CUDA libraries where they are missing: its nvcc
    jobs run together, into its fixed ``build/`` inside the checkout."""
    if device.type == "cuda":
        from dgp_tpu_torch import _build

        _build.build()


def model(config, X, Y, values, seed, device):
    from dgp_tpu_torch.models.dgp import DGP
    from dgp_tpu_torch.ops import kernels as K

    dtype = dtype_of(config)
    f = dict(dtype=dtype, device=device)
    kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * d_in, **f)
               for d_in, _ in shapes(config)]
    Z = values["layers.0.z"]
    m = DGP(X.cpu().numpy(), Y.cpu().numpy(), Z.cpu().numpy(), kernels,
            config["hidden_dims"], num_samples=config["num_samples"],
            white=config["white"], seed=model_seed(seed), **f)
    with torch.no_grad():
        m.params.load_state_dict(values, strict=True)
    return m


def predict_fn(config):
    """The request path's per-chunk predict: ``predict_y`` on the chunk's
    points with the chunk's own unit normals."""
    from dgp_tpu_torch.models.dgp import predict_y

    from .inputs import split_request

    S = config["num_samples"]

    def predict(params, rows, generator):
        X, zs = split_request(config, rows)
        return predict_y(params, X, S, generator, zs=zs)

    return predict


def serve(config, traffic, m, rows, device):
    """One request through the entry a user calls: ``predict_in_chunks``
    over ``predict_y``, then ``moment_matched``; returns [R, 2 D] on the
    host (the mean, then the variance)."""
    from dgp_tpu_torch.models.dgp import moment_matched
    from dgp_tpu_torch.parallel.serving import predict_in_chunks

    with torch.no_grad():
        y_m, y_v = predict_in_chunks(predict_fn(config), m.params, rows,
                                     m.generator, traffic["chunk_size"],
                                     device=device)
        mean, var = moment_matched(y_m, y_v)
        return torch.cat([mean, var], dim=1).cpu()


def train_block(traffic, m, steps):
    """``steps`` Adam steps through the entry a user calls, ended when the
    block's losses are on the host."""
    lr, (b1, b2), eps = traffic["lr"], traffic["betas"], traffic["eps"]
    losses = m.optimize_adam(iterations=steps, lr=lr, beta_1=b1, beta_2=b2,
                             epsilon=eps, messages=0, shrink_inner=False)
    return losses.cpu()
