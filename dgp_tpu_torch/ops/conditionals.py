"""Sparse-variational GP conditionals and the reparameterization trick
(counterpart of ``dgp_tpu/ops/conditionals.py``).

As in the JAX package, the shared Kuu is broadcast against the [D, M, M]
q_sqrt batch, the S-sample axis is folded into the point axis before the
conditional, and the variance is assembled from two cancellation-free
quadratic forms. Each public function runs its products as IEEE fp32
(``config.ieee_fp32``): the variance cancels, and TF32 would swamp it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import default_jitter, ieee_fp32, use_kernels
from . import conditional_fused
from .cholesky import cholesky, cholesky_inverse
from .linalg import cho_solve, eye_like
from .quadform import quadform_t2, quadform_t2_t1


class SVGPProjection(NamedTuple):
    """Per-layer quantities that depend only on (kernel, Z, q) — not on X.

    Lu and W come from one launch of kernel #8 (:func:`cholesky_inverse`)
    per (M, white) group. The whitened conditional reads W as its projector
    (A = Lu^{-1} Kuf is one product). The non-whitened one solves with Lu
    instead (f32 accuracy at ill-conditioned Kuu, see the JAX package) and
    its KL takes the same Lu; there W is read by the factorization's
    backward, where it stands in for two triangular solves. A Kuu that is
    not positive definite gives NaN, as in the JAX package, and never
    raises."""

    Lu: torch.Tensor        # [M, M] lower Cholesky of Kuu + jitter I
    Kuu: torch.Tensor       # [M, M] (jittered)
    SK: torch.Tensor        # [D, M, M] = q_sqrt q_sqrt^T - (Kuu or I)
    W: torch.Tensor         # [M, M] Lu^{-1}
    white: bool

    @property
    @ieee_fp32()
    def Pinv(self):
        """The JAX package's projector: Lu^{-1} (white) or Kuu^{-1} =
        W^T W (non-white, formed here on demand: no model path reads it)."""
        return self.W if self.white else self.W.mT @ self.W


def _jittered_kuu(kernel, Z, jitter):
    jitter = default_jitter(Z.dtype) if jitter is None else jitter
    Kuu = kernel.K(Z)
    return Kuu + jitter * eye_like(Kuu)


@ieee_fp32()
def precompute_projection(kernel, Z, q_sqrt, white: bool,
                          jitter=None) -> SVGPProjection:
    Kuu = _jittered_kuu(kernel, Z, jitter)
    Lu, W = cholesky_inverse(Kuu[None])
    return SVGPProjection(Lu=Lu[0], Kuu=Kuu, SK=_make_sk(q_sqrt, Kuu, white),
                          W=W[0], white=bool(white))


def _make_sk(q_sqrt, Kuu, white):
    q = torch.tril(q_sqrt)
    S = q @ q.transpose(-1, -2)  # [D, M, M]
    return S - (eye_like(Kuu)[None] if white else Kuu[None])


@ieee_fp32()
def precompute_projections(items, jitter=None):
    """Batched :func:`precompute_projection` over a layer stack.

    :param items: list of (kernel, Z, q_sqrt, white).
    :return: list of :class:`SVGPProjection`, one per item.

    Layers sharing (M, white) are stacked into one [G, M, M] stack, whose
    factor and its inverse come from one launch of kernel #8.
    """
    Kuus = [_jittered_kuu(kernel, Z, jitter) for kernel, Z, _, _ in items]
    groups: dict = {}
    for i, (_, Z, _, white) in enumerate(items):
        groups.setdefault((Z.shape[0], bool(white)), []).append(i)
    Lus = [None] * len(items)
    Ws = [None] * len(items)
    for idxs in groups.values():
        Ls, W = cholesky_inverse(torch.stack([Kuus[i] for i in idxs]))
        for j, i in enumerate(idxs):
            Lus[i] = Ls[j]
            Ws[i] = W[j]
    return [
        SVGPProjection(Lu=Lus[i], Kuu=Kuus[i],
                       SK=_make_sk(q_sqrt, Kuus[i], white), W=Ws[i],
                       white=bool(white))
        for i, (_, _, q_sqrt, white) in enumerate(items)
    ]


@ieee_fp32()
def conditional_diag(kernel, Z, q_mu, q_sqrt, X, *, white: bool, jitter=None,
                     proj: SVGPProjection | None = None):
    """Marginal posterior q(f(X)) per point.

    :param Z: inducing inputs [M, Din]
    :param q_mu: [M, D]
    :param q_sqrt: [D, M, M] (lower-triangular factor; tril applied here)
    :param X: [n, Din]
    :return: mean [n, D], var [n, D]  (mean excludes the mean function)

    Dispatch order as in the JAX package. A whitened f32 RBF/Matern layer
    on the card goes through the fused stationary kernel
    (``conditional_fused_rbf``). Every other whitened f32 layer on the card
    (Sum, Product, Linear, ``active_dims``) builds Kuf and Kff in PyTorch
    and goes through the Kuf-consuming fused kernel
    (``conditional_fused``), within its plan. The rest computes A, the mean
    and (non-whitened) t1 in PyTorch, and its variational quadform t2 (with
    t1 = ||A||^2 on the whitened path) through ``quadform``: the CUDA kernel
    for f32 CUDA tensors within its plan, the plain version otherwise.
    """
    if proj is None:
        proj = precompute_projection(kernel, Z, q_sqrt, white, jitter)
    Sq = torch.tril(q_sqrt).transpose(-1, -2)  # [D, M, M]
    if white and use_kernels():
        from .conditional_fused_rbf import (
            fused_conditional_white_stationary,
            fused_kind,
        )

        kind = fused_kind(kernel, Sq, X)
        if kind is not None:
            # the lengthscale scaling stays outside the kernel
            ls = kernel.lengthscales
            return fused_conditional_white_stationary(
                kind, proj.W, X / ls, Z / ls, kernel.variance, q_mu, Sq)
    Kuf = kernel.K(Z, X)                       # [M, n]
    if white and use_kernels():
        if conditional_fused.applicable(proj.W, Kuf, Sq, q_mu):
            # A and B stay on chip; dKuf and dKff flow back through
            # kernel.K and kernel.K_diag
            return conditional_fused.fused_conditional_white(
                proj.W, Kuf, q_mu, Sq, kernel.K_diag(X))
    # A (white) = Lu^{-1} Kuf as a product with the precomputed inverse W;
    # A (non-white) = Kuu^{-1} Kuf by two substitution solves (f32 accuracy
    # at ill-conditioned Kuu, see the JAX package)
    if white:
        A = proj.W @ Kuf
    else:
        A = cho_solve(proj.Lu, Kuf)
    mean = A.T @ q_mu                          # [n, D]
    #   white:      var = Kff - ||A||^2        + ||q_sqrt^T A||^2
    #   non-white:  var = Kff - sum(Kuf * A)   + ||q_sqrt^T A||^2
    if white:
        t2, t1 = quadform_t2_t1(Sq, A)         # [D, n], [n]
    else:
        t1 = torch.sum(Kuf * A, dim=0)
        t2 = quadform_t2(Sq, A)                # [D, n]
    Kff = kernel.K_diag(X)                     # [n]
    # clamp: rounding in the final subtraction can push var below 0
    var = torch.clamp_min((Kff[None, :] - t1[None, :] + t2).T, 0.0)
    return mean, var


@ieee_fp32()
def conditional_full(kernel, Z, q_mu, q_sqrt, X, *, white: bool, jitter=None,
                     proj: SVGPProjection | None = None):
    """Joint posterior over X: mean [n, D], cov [n, n, D]."""
    if proj is None:
        proj = precompute_projection(kernel, Z, q_sqrt, white, jitter)
    Kuf = kernel.K(Z, X)
    if white:
        A = proj.W @ Kuf
    else:
        A = cho_solve(proj.Lu, Kuf)
    mean = A.T @ q_mu
    B = proj.SK @ A[None]                      # [D, M, n]
    delta = A[None].transpose(-1, -2) @ B      # [D, n, n]
    Kff = kernel.K(X)                          # [n, n]
    cov = (Kff[None] + delta).permute(1, 2, 0)  # [n, n, D]
    return mean, cov


def reparameterize(mean, var, z, full_cov: bool = False, jitter=None):
    """Draw N(mean, var) samples from unit normals z.

    Diagonal: mean [..., N, D], var [..., N, D].
    Full-cov: var [..., N, N, D]; a per-(sample, output) Cholesky is taken.
    """
    jitter = default_jitter(mean.dtype) if jitter is None else jitter
    if var is None:
        return mean
    if not full_cov:
        return mean + z * torch.sqrt(torch.clamp_min(var, 0.0) + jitter)
    var_d = torch.movedim(var, -1, -3)         # [..., D, N, N]
    chol = cholesky(var_d + jitter * eye_like(var_d))
    z_d = torch.movedim(z, -1, -2)[..., None]  # [..., D, N, 1]
    f = torch.movedim(mean, -1, -2) + (chol @ z_d)[..., 0]
    return torch.movedim(f, -2, -1)
