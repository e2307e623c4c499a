"""Natural gradients on Gaussian variational parameters (counterpart of
``dgp_tpu/variational/natgrad.py``).

The update follows Salimbeni et al. (2018): with xi = (q_mu, q_sqrt) the
"XiSqrtMeanVar" coordinates, eta the expectation parameters and theta the
natural parameters of N(m, S),

    theta_new = theta(xi) - gamma * dL/deta,   xi_new = xi(theta_new)

where dL/deta is obtained by differentiating the loss through the
eta -> xi map (``torch.autograd.grad``). All matrix-valued parameters are
explicitly symmetrized at map entry so that raw autodiff gradients coincide
with gradients in the vector space of symmetric matrices.

The coordinate maps take a leading batch axis over the D independent output
GPs: m [D, M], L [D, M, M] (the JAX package maps a single-output function
over that axis).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..ops.linalg import cho_solve, eye_like


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _outer(m):
    return m[..., :, None] * m[..., None, :]


def _chol(A, jitter=1e-12):
    """Cholesky of sym(A) + jitter I. A factor that fails (a matrix that is
    not positive definite) comes back as NaN, as JAX returns it, instead of
    raising: the step's guards then keep the previous value, and nothing
    here reads a device value on the host."""
    L, info = torch.linalg.cholesky_ex(_sym(A) + jitter * eye_like(A))
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, math.nan))


# -- coordinate maps (m [D, M], L [D, M, M] lower) ------------------------------

def meanvarsqrt_to_expectation(m, L):
    L = torch.tril(L)
    S = L @ L.transpose(-1, -2)
    return m, S + _outer(m)


def expectation_to_meanvarsqrt(eta1, eta2):
    S = _sym(eta2) - _outer(eta1)
    return eta1, _chol(S)


def meanvarsqrt_to_natural(m, L):
    L = torch.tril(L)
    S_inv = _sym(cho_solve(L, eye_like(L).expand(L.shape)))
    return (S_inv @ m[..., None])[..., 0], -0.5 * S_inv


def natural_to_meanvarsqrt(theta1, theta2):
    # S = 0.5 * (-theta2)^{-1}
    Lp = _chol(-theta2)
    S = _sym(0.5 * cho_solve(Lp, eye_like(Lp).expand(Lp.shape)))
    m = (S @ theta1[..., None])[..., 0]
    return m, _chol(S)


def natgrad_step_multi(qs, loss_fn, gamma: float, max_growth: float = 1e3,
                       guard_loss: bool = False, reduce_grads=None):
    """One joint natural-gradient step over several layers' (q_mu, q_sqrt):
    one loss evaluation provides dL/deta for every pair, then each pair
    takes the step theta - gamma * dL/deta.

    :param qs: list of (q_mu [M_i, D_i], q_sqrt [D_i, M_i, M_i]).
    :param loss_fn: scalar loss as a function of such a list of tensors. It
        is evaluated once, and up to twice more under ``guard_loss``; every
        evaluation must see the same Monte-Carlo draws (the caller fixes the
        unit normals or puts its generator back before each one).
    :param max_growth: reject a layer's step when it grows the parameter
        norm by more than this factor (free sanity bound). None/inf disables.
    :param guard_loss: natural-gradient steps on stiff landscapes can stay
        finite and norm-bounded yet be catastrophic. With ``guard_loss`` the
        candidate step is re-evaluated on the same draws; if the loss
        worsens more than 100x it retries once at gamma/10, and only if that
        also fails keeps the previous q for the iteration. One extra loss
        evaluation per step, and one read of its verdict on the host (a
        device sync); default off, as in the JAX package.
    :param reduce_grads: for a sharded loss, its all-reduce of the
        gradients dL/deta over the ranks (every rank then takes the same
        step; the guard reads the loss, which is already reduced).
    :return: list of updated (q_mu, q_sqrt), detached.
    """
    qs = [(m.detach(), torch.tril(L.detach())) for m, L in qs]
    # the maps run in float64 whatever the parameters' dtype: in float32,
    # eta2 - eta1 eta1^T cancels a small S (a q_sqrt scaled 1e-5 gives
    # S ~ 1e-10) against m m^T of order one, its factor fails, and every
    # step would be rejected
    wide = [(m.double(), L.double()) for m, L in qs]
    etas = []
    for m, L in wide:
        e1, e2 = meanvarsqrt_to_expectation(m.T, L)
        etas.append((e1.clone().requires_grad_(True),
                     e2.clone().requires_grad_(True)))

    with torch.enable_grad():
        new_qs = []
        for (e1, e2), (m0, L0) in zip(etas, qs):
            m, L = expectation_to_meanvarsqrt(e1, e2)
            new_qs.append((m.T.to(m0.dtype), L.to(L0.dtype)))
        loss_before = loss_fn(new_qs)
        leaves = [e for pair in etas for e in pair]
        flat = torch.autograd.grad(loss_before, leaves, allow_unused=True)
    loss_before = loss_before.detach()
    # a leaf the loss does not depend on has gradient 0
    flat = [torch.zeros_like(e) if g is None else g
            for e, g in zip(leaves, flat)]
    if reduce_grads is not None:
        flat = reduce_grads(flat)
    grads = list(zip(flat[0::2], flat[1::2]))

    @torch.no_grad()
    def attempt(gma):
        out = []
        for (m0, L0), (m, L), (g1, g2) in zip(qs, wide, grads):
            th1, th2 = meanvarsqrt_to_natural(m.T, L)
            th1 = th1 - gma * g1
            th2 = th2 - gma * _sym(g2)
            m_new, L_new = natural_to_meanvarsqrt(th1, th2)
            # Per-layer guard: a too-large step can leave the natural-
            # parameter cone (-theta2 loses positive-definiteness), which
            # _chol reports as NaN. Keep the previous value for that layer
            # and let the next iteration retry from wherever Adam moved the
            # rest of the model.
            ok = torch.isfinite(m_new).all() & torch.isfinite(L_new).all()
            if max_growth is not None and not math.isinf(max_growth):
                size_old = torch.linalg.norm(m) + torch.linalg.norm(L)
                size_new = torch.linalg.norm(m_new) + torch.linalg.norm(L_new)
                ok = ok & (size_new <= max_growth * (size_old + 1.0))
            out.append((torch.where(ok, m_new.T.to(m0.dtype), m0),
                        torch.where(ok, L_new.to(L0.dtype), L0)))
        return out

    out = attempt(gamma)
    if guard_loss:
        # Reject only two-orders-of-magnitude worsenings (exploratory
        # excursions that spike the same-draws loss a few-10x before
        # settling lower are load-bearing), and on rejection retry once at
        # gamma/10 before freezing q for the iteration.
        margin = 100.0 * loss_before.abs() + 1e4

        @torch.no_grad()
        def ok_step(candidate):
            la = loss_fn(candidate)
            return bool(torch.isfinite(la) & (la <= loss_before + margin))

        if not ok_step(out):
            small = attempt(gamma * 0.1)
            out = small if ok_step(small) else qs
    return out


def natgrad_step(
    q_mu: torch.Tensor,
    q_sqrt: torch.Tensor,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-layer convenience wrapper over :func:`natgrad_step_multi`."""
    (res,) = natgrad_step_multi(
        [(q_mu, q_sqrt)], lambda qs: loss_fn(qs[0][0], qs[0][1]), gamma
    )
    return res
