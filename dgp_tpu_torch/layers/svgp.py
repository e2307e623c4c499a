"""Sparse variational GP layers (counterpart of ``dgp_tpu/layers/svgp.py``).

A layer is an ``nn.Module`` holding the kernel, the inducing inputs and the
variational parameters under the JAX pytree's names; the math lives in plain
functions that take the inducing inputs explicitly. Sampling takes an
explicit ``torch.Generator`` (or fixed unit normals) in place of
``jax.random`` keys. An augmented layer (the multi-fidelity models') holds
only the trainable left block ``z_left`` of its inducing inputs and no
``z``: the model recomputes the rest inside every loss and request and
passes the full inducing inputs in.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..config import default_float
from ..ops.conditionals import (
    conditional_diag,
    conditional_full,
    precompute_projection,
    precompute_projections,
    reparameterize,
)
from ..ops.linalg import safe_cholesky
from ..ops.means import MeanFunction, Zero
from ..variational.gaussian import gauss_kl


class SVGPLayer(nn.Module):
    def __init__(self, kernel, z, q_mu, q_sqrt, mean_function: MeanFunction,
                 num_outputs: int, white: bool = False,
                 input_prop_dim: Optional[int] = None, z_left=None):
        super().__init__()
        self.kernel = kernel
        # [M, Din]; None for augmented layers
        self.z = None if z is None else nn.Parameter(z)
        # [M, D_left]; None for plain layers
        self.z_left = None if z_left is None else nn.Parameter(z_left)
        self.q_mu = nn.Parameter(q_mu)        # [M, D_out]
        self.q_sqrt = nn.Parameter(q_sqrt)    # [D_out, M, M] lower-triangular
        self.mean_function = mean_function
        self.num_outputs = num_outputs
        self.white = white
        self.input_prop_dim = input_prop_dim

    @property
    def augmented(self) -> bool:
        return self.z_left is not None

    @property
    def num_inducing(self) -> int:
        base = self.z if self.z is not None else self.z_left
        return base.shape[0]


def make_svgp_layer(kernel, Z, num_outputs, mean_function=None, *,
                    white=False, input_prop_dim=None, augmented=False,
                    Z_full_init=None, dtype=None, device=None) -> SVGPLayer:
    """A layer with the reference's initialization: q_mu = 0; q_sqrt = I
    (whitened) or chol(Kuu) at the initial inducing inputs (non-whitened;
    kernel #7 where it applies, and NaN, not a raise, for a Kuu that is not
    positive definite, as in the JAX package). The layer holds its own copy
    of ``kernel`` (the JAX layers share immutable values; shared modules
    would tie the parameters).

    :param Z: inducing inputs [M, Din]; for an augmented layer the trainable
        left block, with the full initial [M, Din + aug] in ``Z_full_init``
        for the q_sqrt prior init.
    """
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
            Z_init = Z if Z_full_init is None else torch.as_tensor(
                Z_full_init, dtype=dtype, device=Z.device)
            Lu = safe_cholesky(kernel.K(Z_init))
        q_sqrt = Lu[None].repeat(num_outputs, 1, 1)
    return SVGPLayer(kernel, None if augmented else Z, q_mu, q_sqrt,
                     mean_function, num_outputs, white=white,
                     input_prop_dim=input_prop_dim,
                     z_left=Z if augmented else None)


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


def layer_kl(layer: SVGPLayer, Z, Lu=None):
    """KL[q(u) || p(u)]. The non-whitened prior's Kuu factor is ``Lu``
    where given (the layer's SVGPProjection.Lu, as the ELBO passes it), else
    it comes from kernel #7 where that applies; a Kuu that is not positive
    definite gives a NaN KL, never a raise."""
    if layer.white:
        return gauss_kl(layer.q_mu, layer.q_sqrt, Lu=None)
    if Lu is None:
        Lu = safe_cholesky(layer.kernel.K(Z))
    return gauss_kl(layer.q_mu, layer.q_sqrt, Lu=Lu)


def mean_propagated_sample(layer: SVGPLayer, Z, points, generator=None,
                           num_samples=50, z=None):
    """Mean over ``num_samples`` reparameterized draws of the layer at
    ``points`` [N, Din]: the building block of the augmented inducing
    points' recomputation.

    :param z: optional fixed unit normals [num_samples, N, D].
    """
    tiled = points[None].expand(num_samples, *points.shape)
    samples, _, _ = sample_from_conditional(layer, Z, tiled, generator, z=z)
    return torch.mean(samples, dim=0)
