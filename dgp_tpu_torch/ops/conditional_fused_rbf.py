"""Fully fused whitened stationary-SVGP conditional: Kuf never reaches
device memory (counterpart of ``dgp_tpu/ops/conditional_fused_rbf.py``).

For each point tile the CUDA kernel (``csrc/conditional_fused_rbf.cu``,
which replaces the TPU's ``conditional_fused_rbf._fwd_kernel``) computes

    sq    = max((||x||^2 - 2 z.x) + ||z||^2, 0)
    Kuf   = k(sq)            (v*exp(-sq/2) | Matern forms on r = sqrt(sq))
    A     = Pinv @ Kuf,  mean = A^T q_mu,  t1 = ||A||^2
    B     = Sq @ A,      t2 = ||B||^2 per output
    var   = max(v - t1 + t2, 0)                      (stationary: Kff == v)

on the scaled inputs ``Xs = X / ls``, ``Zs = Z / ls`` (the lengthscale
division stays outside). It is bound by fp32 arithmetic; see the source for
the design.

The backward (it replaces the TPU's ``conditional_fused_rbf._bwd_kernel``)
runs in two CUDA phases in the same source. Phase A recomputes sq, Kuf, A
and B per point tile and chains the cotangents of (mean, var) to ``dXs``
and to the per-tile shares of ``dZs``, ``dvariance`` and ``dq_mu``, and
writes Kuf, A, dA and the masked g_var to scratch; phase B forms dPinv =
tril(dA Kuf^T) and dSq[d] = triu(2 Sq[d] A diag(gv_d) A^T) as split-K Grams.
Every sum runs in a fixed order (deterministic), and points go through in
passes of ``_launch.BACKWARD_PASS``, which bound the scratch. It assumes
what the whitened path gives it, Pinv lower- and Sq upper-triangular, and
returns dPinv and dSq on those patterns, exact zeros elsewhere: only those
entries reach a parameter. Autograd handles what surrounds the kernel: the
lengthscale scaling, the softplus of the variance, Pinv's Cholesky and
solve, and Sq's tril and transpose.

:func:`fused_conditional_plain` and :func:`fused_conditional_backward_plain`
are the same functions in plain PyTorch. The wrapper takes them only for
tensors on the CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..config import ieee_fp32
from ._launch import (backward_passes, backward_scratch, finish_gram,
                      grid_blocks, pointer, run_gram, run_kernel)
from ._launch import gram_backward as _gram_backward
# phase B's plain version, shared with the Kuf-consuming kernels
from .conditional_fused import gram_backward_plain  # noqa: F401

_LIB = "conditional_fused_rbf"
_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "dgp_fused_rbf_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _N, _I, _I, _I, _I,
                          _P],
    "dgp_fused_rbf_fwd_blocks": [_I, _I, _I, _I],
    "dgp_fused_rbf_supported": [_I, _I, _I],
    "dgp_fused_rbf_bwd_supported": [_I, _I, _I],
    "dgp_fused_rbf_bwd_blocks": [_I, _N, _I, _I, _I],
    "dgp_fused_rbf_bwd_tile": [],
    "dgp_fused_rbf_bwd_slice": [],
    "dgp_fused_rbf_bwd_a": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _N, _P, _P, _N, _I, _I, _I, _I, _I, _P],
    "dgp_fused_rbf_bwd_gram": [_P, _P, _N, _P, _N, _P, _P, _P, _N, _I, _I, _I,
                               _P],
    "dgp_fused_rbf_bwd_finish": [_P, _P, _P, _P, _I, _I, _P],
}
_PREFIX = "dgp_fused_rbf_bwd"


def supported(M, Din, D):
    """Whether the forward kernel's shared-memory plan covers these sizes.
    The plan lives in the CUDA source, so this asks the built library (and
    builds it on first use)."""
    return bool(_library().dgp_fused_rbf_supported(M, Din, D))


def backward_supported(M, Din, D):
    """Whether the backward kernel's (larger) shared-memory plan covers
    these sizes."""
    return bool(_library().dgp_fused_rbf_bwd_supported(M, Din, D))


def fused_kind(kernel, Sq, X):
    """Kernel-kind id (0=RBF, 1=Matern32, 2=Matern52) if the fused kernel
    applies, else None: a plain full-dimension stationary kernel (no
    active_dims), float32 CUDA tensors, and sizes within the kernel's
    shared-memory plan. Where a gradient will be asked for (grad mode is on
    and the points, the variational factor or a kernel hyperparameter
    require one), the sizes must be within the backward kernel's plan too:
    a forward that launched where the backward cannot would fail mid-step."""
    from .kernels import RBF, Matern32, Matern52

    kind = {RBF: 0, Matern32: 1, Matern52: 2}.get(type(kernel))
    if kind is None or kernel.active_dims is not None:
        return None
    if not (X.is_cuda and X.dtype == torch.float32
            and Sq.dtype == torch.float32):
        return None
    sizes = (Sq.shape[1], X.shape[1], Sq.shape[0])
    if not supported(*sizes):
        return None
    wants_grad = torch.is_grad_enabled() and (
        Sq.requires_grad or X.requires_grad
        or any(p.requires_grad for p in kernel.parameters()))
    if wants_grad and not backward_supported(*sizes):
        return None
    return kind


def _kuf_tile(kind, v, sqd):
    """Stationary k(sq) on scaled squared distances (Kff == v for all)."""
    if kind == 0:
        return v * torch.exp(-0.5 * sqd)
    r = torch.sqrt(sqd)
    if kind == 1:
        a = math.sqrt(3.0)
        return v * (1.0 + a * r) * torch.exp(-a * r)
    a = math.sqrt(5.0)
    return v * (1.0 + a * r + (5.0 / 3.0) * sqd) * torch.exp(-a * r)


def _dkuf_dsq(kind, v, sqd, kuf):
    """d kuf / d sq. The 1/(2r) of dr/dsq cancels analytically, so every
    branch is smooth at sq == 0 and needs no epsilon."""
    if kind == 0:
        return -0.5 * kuf
    r = torch.sqrt(sqd)
    if kind == 1:
        return -(1.5 * v) * torch.exp(-math.sqrt(3.0) * r)
    a = math.sqrt(5.0)
    return -((5.0 / 6.0) * v) * (1.0 + a * r) * torch.exp(-a * r)


def _sq_kuf_a(kind, Pinv, Xs, Zs, variance):
    xx = torch.sum(Xs * Xs, dim=1)[None, :]            # [1, n]
    zz = torch.sum(Zs * Zs, dim=1)[:, None]            # [M, 1]
    sqd = torch.clamp_min((xx - 2.0 * (Zs @ Xs.T)) + zz, 0.0)
    kuf = _kuf_tile(kind, variance, sqd)               # [M, n]
    return sqd, kuf, Pinv @ kuf


@ieee_fp32()
def fused_conditional_plain(kind, Pinv, Xs, Zs, variance, q_mu, Sq):
    """The kernel's function in plain PyTorch, on any device and dtype:
    (mean [n, D], var [n, D]). It reads what the kernel reads, Pinv's lower
    and Sq's upper triangle, which are all there is on the whitened path."""
    _, _, A = _sq_kuf_a(kind, torch.tril(Pinv), Xs, Zs, variance)
    mean = A.T @ q_mu                                  # [n, D]
    t1 = torch.sum(A * A, dim=0)                       # [n]
    B = torch.triu(Sq) @ A                             # [D, M, n]
    t2 = torch.sum(B * B, dim=1)                       # [D, n]
    var = torch.clamp_min((variance - t1) + t2, 0.0).T
    return mean, var


@ieee_fp32()
def fused_conditional_backward_plain(kind, Pinv, Xs, Zs, variance, q_mu, Sq,
                                     g_mean, g_var):
    """The backward kernel's function in plain PyTorch: the cotangents
    (dPinv, dXs, dZs, dvariance, dq_mu, dSq) of (mean, var) weighted by
    (g_mean, g_var) [n, D].

    This is the kernel's hand-derived chain written out on whole tensors,
    not autograd of :func:`fused_conditional_plain`: the gradient passes
    only where the recomputed ``(v - t1) + t2`` and ``sq`` are strictly
    positive, and the Matern chain works in sq (:func:`_dkuf_dsq`). dPinv
    and dSq are projected on the patterns of Pinv (lower) and Sq (upper),
    as the kernel returns them: only those entries reach a parameter on the
    whitened path."""
    sqd, kuf, A = _sq_kuf_a(kind, Pinv, Xs, Zs, variance)
    B = Sq @ A                                         # [D, M, n]
    t1 = torch.sum(A * A, dim=0)
    t2 = torch.sum(B * B, dim=1)                       # [D, n]
    lin = (variance - t1) + t2
    gv = g_var.T * (lin > 0.0)                         # [D, n]
    gb = (2.0 * B) * gv[:, None, :]                    # [D, M, n]
    dA = (torch.sum(Sq.transpose(1, 2) @ gb, dim=0)
          - (2.0 * A) * torch.sum(gv, dim=0)[None, :]
          + q_mu @ g_mean.T)                           # [M, n]
    dkuf = Pinv.T @ dA
    dPinv = torch.tril(dA @ kuf.T)
    dq_mu = A @ g_mean
    dSq = torch.triu(gb @ A.T)                         # [D, M, M]
    # Kuf = v f(sq) and Kff = v
    dv = torch.sum(dkuf * kuf) / variance + torch.sum(gv)
    dsqd = _dkuf_dsq(kind, variance, sqd, kuf) * dkuf * (sqd > 0.0)
    # sq = xx + zz - 2 zs @ xs
    dXs = (2.0 * Xs) * torch.sum(dsqd, dim=0)[:, None] - 2.0 * (dsqd.T @ Zs)
    dZs = (2.0 * Zs) * torch.sum(dsqd, dim=1)[:, None] - 2.0 * (dsqd @ Xs)
    return dPinv, dXs, dZs, dv.reshape(variance.shape), dq_mu, dSq


def _library():
    return _build.load(_LIB, _SIGNATURES)


def _checked(Pinv, Xs, Zs, variance, q_mu, Sq, **cotangents):
    """Device, dtype and shape checks shared by both launches; returns
    (n, Din, D, M)."""
    dev = Xs.device
    n, Din = Xs.shape
    D, M = Sq.shape[0], Sq.shape[1]
    args = dict(Pinv=Pinv, Zs=Zs, variance=variance, q_mu=q_mu, Sq=Sq,
                **cotangents)
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Xs on {dev}")
    for name, t in dict(args, Xs=Xs).items():
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; {name} is {t.dtype}")
    if (Pinv.shape != (M, M) or Zs.shape != (M, Din) or q_mu.shape != (M, D)
            or Sq.shape != (D, M, M) or variance.numel() != 1
            or any(g.shape != (n, D) for g in cotangents.values())):
        raise ValueError(
            f"shapes Pinv {tuple(Pinv.shape)}, Xs {tuple(Xs.shape)}, Zs "
            f"{tuple(Zs.shape)}, q_mu {tuple(q_mu.shape)}, Sq {tuple(Sq.shape)}"
            + "".join(f", {k} {tuple(g.shape)}" for k, g in cotangents.items())
            + " do not form one conditional")
    return n, Din, D, M


def _kernel_operands(Pinv, Xs, Zs, variance, q_mu, Sq):
    """Contiguous operands in the kernels' layouts: Pinv itself and
    Sq^T = tril(q_sqrt), which both directions stage as packed lower
    triangles (nothing above their diagonals is read)."""
    return (Pinv.contiguous(), Xs.contiguous(), Zs.contiguous(),
            variance.reshape(1).contiguous(), q_mu.contiguous(),
            Sq.transpose(1, 2).contiguous())


def _launch(kind, Pinv, Xs, Zs, variance, q_mu, Sq):
    dev = Xs.device
    n, Din, D, M = _checked(Pinv, Xs, Zs, variance, q_mu, Sq)
    mean = torch.empty((n, D), dtype=torch.float32, device=dev)
    var = torch.empty((n, D), dtype=torch.float32, device=dev)
    if n == 0:
        return mean, var
    operands = _kernel_operands(Pinv, Xs, Zs, variance, q_mu, Sq)
    lib = _library()
    blocks = grid_blocks(lib, "dgp_fused_rbf_fwd", dev, kind, M, Din, D)
    run_kernel(lib, lib.dgp_fused_rbf_fwd, dev, "fused conditional kernel launch",
               kind, *[t.data_ptr() for t in operands], mean.data_ptr(),
               var.data_ptr(), n, M, Din, D, blocks)
    FusedConditional.launches += 1
    return mean, var


def _launch_backward(kind, Pinv, Xs, Zs, variance, q_mu, Sq, g_mean, g_var):
    dev = Xs.device
    n, Din, D, M = _checked(Pinv, Xs, Zs, variance, q_mu, Sq, g_mean=g_mean,
                            g_var=g_var)
    if n == 0:
        return (torch.zeros_like(Pinv), torch.zeros_like(Xs),
                torch.zeros_like(Zs), torch.zeros_like(variance),
                torch.zeros_like(q_mu), torch.zeros_like(Sq))
    pinv, xs, zs, v, qm, sqT = _kernel_operands(Pinv, Xs, Zs, variance, q_mu,
                                                Sq)
    gm, gv = g_mean.contiguous(), g_var.contiguous()
    lib = _library()
    if not backward_supported(M, Din, D):
        raise RuntimeError(f"the fused conditional's backward kernel does not "
                           f"take kind {kind}, M={M}, Din={Din}, D={D}")
    sc = backward_scratch(lib, _PREFIX, n, M, D, M * Din + M * D + 1, True,
                          dev)
    dXs = torch.empty((n, Din), dtype=torch.float32, device=dev)
    for start, count in backward_passes(n):
        blocks = grid_blocks(lib, _PREFIX, dev, kind, count, M, Din, D)
        run_kernel(lib, lib.dgp_fused_rbf_bwd_a, dev,
                   "fused conditional backward phase A launch", kind,
                   pinv.data_ptr(), pointer(xs, start * Din), zs.data_ptr(),
                   v.data_ptr(), qm.data_ptr(), sqT.data_ptr(),
                   pointer(gm, start * D), pointer(gv, start * D),
                   pointer(dXs, start * Din), sc.a, sc.da, sc.kuf, sc.gv,
                   sc.ld, sc.tile_parts, sc.small.data_ptr(), count, M, Din,
                   D, blocks, int(start > 0))
        FusedConditional.backward_launches += 1
        run_gram(lib, _PREFIX, dev,
                 (sc.a, sc.da, sc.ld, sc.kuf, sc.ld, sc.gv), sc.gram_parts,
                 sc.gram, count, M, D, start > 0)
        FusedConditional.gram_launches += 1
    dPinv, dSq = finish_gram(lib, _PREFIX, dev, sc.gram, sqT, M, D)
    dZs, dq_mu, dv = torch.split(sc.small, [M * Din, M * D, 1])
    return (dPinv, dXs, dZs.view(M, Din), dv.view(variance.shape),
            dq_mu.view(M, D), dSq)


def gram_backward(A, dA, Kuf, gv, Sq):
    """Phase B alone on float32 CUDA tensors, in passes as the backward runs
    it: (dPinv, dSq) as :func:`gram_backward_plain` computes them."""
    return _gram_backward(_library(), _PREFIX, FusedConditional, A, gv,
                          Sq.transpose(1, 2).contiguous(), dA, Kuf)


class FusedConditional(torch.autograd.Function):
    """(mean, var) of the whitened stationary conditional and its gradient:
    the CUDA kernels for CUDA tensors, the plain versions for CPU tensors.

    The backward assumes Pinv lower- and Sq upper-triangular (the whitened
    path's Lu^{-1} and tril(q_sqrt)^T) and returns dPinv and dSq on those
    patterns, on the card and on the CPU alike.

    ``launches`` counts forward-kernel launches, ``backward_launches`` the
    backward's phase-A launches and ``gram_launches`` its phase-B launches,
    one of each per pass of points (never plain-version calls)."""

    launches = 0
    backward_launches = 0
    gram_launches = 0

    @staticmethod
    def forward(ctx, kind, Pinv, Xs, Zs, variance, q_mu, Sq):
        ctx.kind = kind
        ctx.save_for_backward(Pinv, Xs, Zs, variance, q_mu, Sq)
        if Xs.is_cuda:
            return _launch(kind, Pinv, Xs, Zs, variance, q_mu, Sq)
        if Xs.device.type != "cpu":
            raise ValueError(f"no fused conditional for device {Xs.device}")
        return fused_conditional_plain(kind, Pinv, Xs, Zs, variance, q_mu, Sq)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        saved = ctx.saved_tensors
        if saved[1].is_cuda:
            grads = _launch_backward(ctx.kind, *saved, g_mean, g_var)
        else:
            grads = fused_conditional_backward_plain(ctx.kind, *saved, g_mean,
                                                     g_var)
        return (None, *grads)


def fused_conditional_white_stationary(kind, Pinv, Xs, Zs, variance, q_mu,
                                       Sq):
    """(mean [n, D], var [n, D]) of the whitened stationary-SVGP conditional.

    :param kind: kernel id from :func:`fused_kind`
    :param Xs: points / lengthscales, [n, Din]
    :param Zs: inducing inputs / lengthscales, [M, Din]
    :param variance: kernel variance scalar (Kff == variance)
    :param Sq: transpose of tril(q_sqrt), [D, M, M]
    """
    return FusedConditional.apply(kind, Pinv, Xs, Zs, variance, q_mu, Sq)
