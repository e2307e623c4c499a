"""Sparse variational GP layers (counterpart of ``dgp_tpu/layers/svgp.py``).

A layer is an ``nn.Module`` holding the kernel, the inducing inputs and the
variational parameters under the JAX pytree's names; the math lives in plain
functions that take the inducing inputs explicitly. Sampling takes an
explicit ``torch.Generator`` (or fixed unit normals) in place of
``jax.random`` keys. Augmented layers (multi-fidelity) come with that family.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..config import default_float, default_jitter
from ..ops.conditionals import (
    conditional_diag,
    conditional_full,
    precompute_projection,
    precompute_projections,
    reparameterize,
)
from ..ops.linalg import eye_like
from ..ops.means import MeanFunction, Zero
from ..variational.gaussian import gauss_kl


class SVGPLayer(nn.Module):
    def __init__(self, kernel, z, q_mu, q_sqrt, mean_function: MeanFunction,
                 num_outputs: int, white: bool = False,
                 input_prop_dim: Optional[int] = None):
        super().__init__()
        self.kernel = kernel
        self.z = nn.Parameter(z)              # [M, Din]
        self.q_mu = nn.Parameter(q_mu)        # [M, D_out]
        self.q_sqrt = nn.Parameter(q_sqrt)    # [D_out, M, M] lower-triangular
        self.mean_function = mean_function
        self.num_outputs = num_outputs
        self.white = white
        self.input_prop_dim = input_prop_dim


def make_svgp_layer(kernel, Z, num_outputs, mean_function=None, *,
                    white=False, input_prop_dim=None, dtype=None,
                    device=None) -> SVGPLayer:
    """A layer with the reference's initialization: q_mu = 0; q_sqrt = I
    (whitened) or chol(Kuu) at the initial inducing inputs (non-whitened).
    The layer holds its own copy of ``kernel`` (the JAX layers share
    immutable values; shared modules would tie the parameters)."""
    dtype = dtype or default_float()
    Z = torch.as_tensor(Z, dtype=dtype, device=device)
    kernel = copy.deepcopy(kernel).to(device=Z.device, dtype=dtype)
    M = Z.shape[0]
    mean_function = (mean_function if mean_function is not None
                     else Zero(num_outputs))
    q_mu = torch.zeros((M, num_outputs), dtype=dtype, device=Z.device)
    eye = torch.eye(M, dtype=dtype, device=Z.device)
    with torch.no_grad():
        if white:
            Lu = eye
        else:
            Lu = torch.linalg.cholesky(kernel.K(Z) + default_jitter(dtype) * eye)
        q_sqrt = Lu[None].repeat(num_outputs, 1, 1)
    return SVGPLayer(kernel, Z, q_mu, q_sqrt, mean_function, num_outputs,
                     white=white, input_prop_dim=input_prop_dim)


def stack_projections(layers, Zs):
    """Projections for a whole layer stack in one batched precompute."""
    return precompute_projections([
        (layer.kernel, Z, layer.q_sqrt, layer.white)
        for layer, Z in zip(layers, Zs)
    ])


def conditional_snd(layer: SVGPLayer, Z, X, full_cov=False, proj=None):
    """Multisample conditional over X [S, N, Din]: the diagonal path folds S
    into the point axis; the full-cov path loops over S with the Kuu work
    hoisted.

    :return: mean [S, N, D], var [S, N, D] or [S, N, N, D]
    """
    S, N, Din = X.shape
    if proj is None:
        proj = precompute_projection(layer.kernel, Z, layer.q_sqrt, layer.white)
    if full_cov:
        outs = [conditional_full(layer.kernel, Z, layer.q_mu, layer.q_sqrt, x,
                                 white=layer.white, proj=proj) for x in X]
        mean = torch.stack([m for m, _ in outs])
        var = torch.stack([v for _, v in outs])
        mean = mean + torch.stack([layer.mean_function(x) for x in X])
        return mean, var
    X_flat = X.reshape(S * N, Din)
    mean, var = conditional_diag(
        layer.kernel, Z, layer.q_mu, layer.q_sqrt, X_flat,
        white=layer.white, proj=proj,
    )
    mean = mean + layer.mean_function(X_flat)
    D = layer.num_outputs
    return mean.reshape(S, N, D), var.reshape(S, N, D)


def sample_from_conditional(layer: SVGPLayer, Z, X, generator=None,
                            full_cov=False, z=None, proj=None):
    """Conditional + reparameterized sample + input propagation.

    :param X: [S, N, Din]
    :param generator: ``torch.Generator`` on X's device for the unit normals
    :param z: optional fixed unit normals (then ``generator`` is unused)
    :param proj: optional precomputed SVGPProjection (stack_projections)
    :return: samples [S, N, D_tot], mean [S, N, D_tot], var
    """
    mean, var = conditional_snd(layer, Z, X, full_cov=full_cov, proj=proj)
    if z is None:
        z = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    samples = reparameterize(mean, var, z, full_cov=full_cov)

    if layer.input_prop_dim:
        X_prop = X[:, :, : layer.input_prop_dim]
        samples = torch.cat([X_prop, samples], dim=2)
        mean = torch.cat([X_prop, mean], dim=2)
        if full_cov:
            zeros = torch.zeros(var.shape[:3] + (layer.input_prop_dim,),
                                dtype=var.dtype, device=var.device)
            var = torch.cat([zeros, var], dim=3)
        else:
            var = torch.cat([torch.zeros_like(X_prop), var], dim=2)
    return samples, mean, var


def layer_kl(layer: SVGPLayer, Z):
    """KL[q(u) || p(u)]."""
    if layer.white:
        return gauss_kl(layer.q_mu, layer.q_sqrt, Lu=None)
    Kuu = layer.kernel.K(Z)
    Lu = torch.linalg.cholesky(Kuu + default_jitter(Z.dtype) * eye_like(Kuu))
    return gauss_kl(layer.q_mu, layer.q_sqrt, Lu=Lu)
