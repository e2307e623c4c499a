"""Plain PyTorch reference of a doubly stochastic deep GP (Salimbeni and
Deisenroth, 2017): SVGP layers with RBF kernels (ARD lengthscales),
whitened or not, a Gaussian likelihood, the Monte-Carlo ELBO, the
moment-matched predictive and Adam. It imports nothing of the port.

The parameters are a dict of tensors under the names the benchmark gives
them (``layers.<i>.kernel.variance_raw``, ``.lengthscales_raw``, ``.z``,
``.q_mu``, ``.q_sqrt``; ``likelihood.variance_raw``); positive values are
stored through a softplus, as the benchmark makes them. The layer equations
are the paper's, written out directly:

    Kuu = k(Z, Z) + jitter I = Lu Lu^T,   kuf = k(Z, x)
    A   = Lu^{-1} kuf (whitened) or Kuu^{-1} kuf
    mean = A^T q_mu + m(x)
    var  = k(x, x) - ||A||^2 + ||L^T A||^2          (whitened)
         = k(x, x) - kuf^T A + ||L^T A||^2          (not whitened)

with L = tril(q_sqrt) per output, clamped at 0, and each inner layer's
sample f = mean + z sqrt(var + jitter). Layer 1 is computed once at the
distinct input rows and broadcast over the S samples.

:class:`Precision` says how it computes: :data:`F64` (float64, the
reference) or :data:`TF32` (float32 whose matrix products round their
operands to TF32's 10-bit mantissa and accumulate in float32, as the card's
TF32 tensor cores do: the lower-precision control). Factorizations and
triangular solves run in the precision's dtype.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def round_tf32(x):
    """x (float32) rounded to TF32: 10 mantissa bits, the nearest value,
    ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b):
    return torch.matmul(round_tf32(a), round_tf32(b))


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype
    matmul: Callable


F64 = Precision("float64", torch.float64, torch.matmul)
TF32 = Precision("tf32", torch.float32, _tf32_matmul)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _cast(values, prec):
    return {k: v.to(prec.dtype) for k, v in values.items()}


def rbf(X, Z, variance, lengthscales, mm):
    """k(X, Z) [n, m] of the RBF kernel."""
    Xs, Zs = X / lengthscales, Z / lengthscales
    sq = ((Xs * Xs).sum(-1)[:, None] + (Zs * Zs).sum(-1)[None, :]
          - 2.0 * mm(Xs, Zs.T))
    return variance * torch.exp(-0.5 * torch.clamp_min(sq, 0.0))


def cholesky(K):
    """Lower Cholesky factor; NaN, not an exception, where K is not
    positive definite (as the port's factorizations give)."""
    L, info = torch.linalg.cholesky_ex(K)
    return L if int(info) == 0 else torch.full_like(L, math.nan)


class Layer(NamedTuple):
    variance: torch.Tensor
    lengthscales: torch.Tensor
    z: torch.Tensor
    q_mu: torch.Tensor
    L: torch.Tensor          # tril(q_sqrt) [D, M, M]
    Lu: torch.Tensor         # chol(Kuu + jitter I)
    white: bool
    identity_mean: bool


def layers_of(p, config, prec):
    """The layers' constrained parameters and Kuu factors."""
    out = []
    jitter = config["jitter"]
    for i, mean in enumerate(config["mean_functions"]):
        pre = f"layers.{i}."
        variance = softplus(p[pre + "kernel.variance_raw"])
        ls = softplus(p[pre + "kernel.lengthscales_raw"])
        z = p[pre + "z"]
        Kuu = rbf(z, z, variance, ls, prec.matmul)
        Kuu = Kuu + jitter * torch.eye(Kuu.shape[0], dtype=Kuu.dtype,
                                       device=Kuu.device)
        out.append(Layer(variance, ls, z, p[pre + "q_mu"],
                         torch.tril(p[pre + "q_sqrt"]), cholesky(Kuu),
                         config["white"], mean == "identity"))
    return out


def conditional(layer, X, mm):
    """(mean [n, D], var [n, D]) of one layer at points X [n, Din], the
    mean function included."""
    kuf = rbf(layer.z, X, layer.variance, layer.lengthscales, mm)   # [M, n]
    if layer.white:
        A = torch.linalg.solve_triangular(layer.Lu, kuf, upper=False)
        t1 = (A * A).sum(0)
    else:
        A = torch.cholesky_solve(kuf, layer.Lu, upper=False)
        t1 = (kuf * A).sum(0)
    B = mm(layer.L.transpose(1, 2), A)                             # [D, M, n]
    t2 = (B * B).sum(1)                                            # [D, n]
    mean = mm(A.T, layer.q_mu)
    if layer.identity_mean:
        mean = mean + X
    var = torch.clamp_min(layer.variance - t1 + t2, 0.0).T
    return mean, var


def last_moments(layers, X, zs, jitter, mm):
    """(Fmean, Fvar) [S, n, D] of the last layer for inputs X [n, Din];
    ``zs[i]`` ([S, n, D_i]) are layer i's unit normals, for each layer
    before the last (the last layer's, where given, are not read)."""
    mean, var = conditional(layers[0], X, mm)
    mean, var = mean[None], var[None]
    for layer, z in zip(layers[1:], zs):
        F = mean + z * torch.sqrt(var + jitter)
        S, n, Din = F.shape
        mean, var = conditional(layer, F.reshape(S * n, Din), mm)
        mean, var = mean.reshape(S, n, -1), var.reshape(S, n, -1)
    return mean, var


def kl(layer, mm):
    """KL[q(u) || p(u)] summed over the layer's outputs."""
    D, M = layer.L.shape[0], layer.L.shape[1]
    diag = torch.diagonal(layer.L, dim1=-2, dim2=-1)
    out = -0.5 * D * M - torch.log(diag.abs()).sum()
    if layer.white:
        return out + 0.5 * (layer.L ** 2).sum() + 0.5 * (layer.q_mu ** 2).sum()
    Lu = layer.Lu
    out = out + D * torch.log(torch.diagonal(Lu)).sum()
    V = torch.linalg.solve_triangular(Lu.expand(D, M, M), layer.L, upper=False)
    out = out + 0.5 * (V ** 2).sum()
    return out + 0.5 * (layer.q_mu * torch.cholesky_solve(layer.q_mu, Lu)).sum()


def elbo(p, X, Y, zs, config, prec):
    """Monte-Carlo ELBO: sum over rows of E_S[E_q log N(y | f, s2)] minus
    the layers' KL."""
    layers = layers_of(p, config, prec)
    m, v = last_moments(layers, X, zs, config["jitter"], prec.matmul)
    s2 = softplus(p["likelihood.variance_raw"])
    ve = -HALF_LOG_2PI - 0.5 * torch.log(s2) - 0.5 * ((Y - m) ** 2 + v) / s2
    return ve.mean(0).sum() - sum(kl(layer, prec.matmul) for layer in layers)


def adam_follow(values, X, Y, step_normals, config, prec, lr, b1, b2, eps):
    """Follow Adam from ``values`` for ``len(step_normals)`` steps on -ELBO,
    step k with the inner layers' normals ``step_normals[k]``.

    :return: (losses [steps], the first step's gradients, the values after
        the last step), the tensors as dicts by name, in ``prec.dtype``.
    """
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in _cast(values, prec).items()}
    X, Y = X.to(prec.dtype), Y.to(prec.dtype)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, zs in enumerate(step_normals, start=1):
        zs = [z.to(prec.dtype) for z in zs]
        loss = -elbo(p, X, Y, zs, config, prec)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = b1 * m[k] + (1 - b1) * g
                s[k] = b2 * s[k] + (1 - b2) * g * g
                m_hat = m[k] / (1 - b1 ** step)
                s_hat = s[k] / (1 - b2 ** step)
                p[k] -= lr * m_hat / (torch.sqrt(s_hat) + eps)
    return losses, first, {k: v.detach() for k, v in p.items()}


@torch.no_grad()
def predict(values, X, zs, config, prec, block):
    """Moment-matched predictive (mean [n, D], var [n, D]) at X [n, Din]
    with the inner layers' normals ``zs`` ([S, n, D] each), in row blocks
    of ``block``."""
    p = _cast(values, prec)
    layers = layers_of(p, config, prec)
    s2 = softplus(p["likelihood.variance_raw"])
    means, variances = [], []
    for lo in range(0, X.shape[0], block):
        hi = min(lo + block, X.shape[0])
        m, v = last_moments(layers, X[lo:hi].to(prec.dtype),
                            [z[:, lo:hi].to(prec.dtype) for z in zs],
                            config["jitter"], prec.matmul)
        v = v + s2
        mean = m.mean(0)
        means.append(mean)
        variances.append((v + m * m).mean(0) - mean * mean)
    return torch.cat(means), torch.cat(variances)
