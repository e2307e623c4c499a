"""Fused whitened SVGP conditional from a materialized Kuf and Kff
(counterpart of ``dgp_tpu/ops/conditional_fused.py``).

For each point tile the CUDA kernel (``csrc/conditional_fused.cu``, which
replaces the TPU's ``conditional_fused._fwd_kernel``) computes

    A     = Pinv @ Kuf,  mean = A^T q_mu,  t1 = ||A||^2
    B     = Sq @ A,      t2 = ||B||^2 per output
    var   = max((Kff - t1) + t2, 0)

so neither A [M, n] nor B [D, M, n] reaches device memory. It carries every
whitened layer that the stationary kernel (``conditional_fused_rbf``) does
not take: Sum, Product and Linear kernels, and kernels with ``active_dims``.
Kuf and Kff are built by the kernel's own ``K`` / ``K_diag`` in PyTorch.

The backward (it replaces the TPU's ``conditional_fused._bwd_kernel``)
runs in two CUDA phases in the same source. Phase A recomputes A and B per
point tile, applies the clamp mask ``(Kff - t1) + t2 > 0`` and writes dKuf
and dKff, and A, dA and the masked g_var to scratch; phase B forms the sums
over all points, dPinv = tril(dA Kuf^T) and dSq[d] = triu(2 Sq[d] A diag(gv_d)
A^T), as split-K Grams summed in a fixed order (deterministic). Points go
through in passes of ``_launch.BACKWARD_PASS``, which bound the scratch.
It assumes what the whitened path gives it, Pinv lower- and Sq
upper-triangular, and returns dPinv and dSq on those patterns, exact zeros
elsewhere: the Cholesky adjoint reads only the lower triangle of dPinv, and
tril(q_sqrt) cuts the rest of dSq. Autograd carries dKuf and dKff on into
``kernel.K`` and ``kernel.K_diag``, and so to Z, X and the hyperparameters.

:func:`fused_conditional_white_plain` and
:func:`fused_conditional_white_backward_plain` are the same functions in
plain PyTorch. :class:`FusedConditionalWhite` takes them only for tensors on
the CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..config import ieee_fp32
from ._launch import (backward_passes, backward_scratch, finish_gram,
                      grid_blocks, pointer, run_gram, run_kernel)
from ._launch import gram_backward as _gram_backward

_LIB = "conditional_fused"
_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "dgp_conditional_fused_fwd": [_P, _P, _P, _P, _P, _P, _P, _N, _I, _I, _I,
                                  _P],
    "dgp_conditional_fused_fwd_blocks": [_I, _I],
    "dgp_conditional_fused_supported": [_I, _I],
    "dgp_conditional_fused_bwd_supported": [_I, _I],
    "dgp_conditional_fused_bwd_blocks": [_N, _I, _I],
    "dgp_conditional_fused_bwd_tile": [],
    "dgp_conditional_fused_bwd_slice": [],
    "dgp_conditional_fused_bwd_a": [_P, _P, _N, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _N, _P, _P, _N, _I, _I, _I, _I, _P],
    "dgp_conditional_fused_bwd_gram": [_P, _P, _N, _P, _N, _P, _P, _P, _N, _I,
                                       _I, _I, _P],
    "dgp_conditional_fused_bwd_finish": [_P, _P, _P, _P, _I, _I, _P],
}
_PREFIX = "dgp_conditional_fused_bwd"


def supported(M, D):
    """Whether the forward kernel's shared-memory plan covers these sizes.
    The plan lives in the CUDA source, so this asks the built library (and
    builds it on first use)."""
    return bool(_library().dgp_conditional_fused_supported(M, D))


def backward_supported(M, D):
    """Whether the backward kernel's (larger) shared-memory plan covers
    these sizes."""
    return bool(_library().dgp_conditional_fused_bwd_supported(M, D))


def applicable(Pinv, Kuf, Sq, q_mu):
    """Whether the kernels take this conditional: float32 CUDA tensors
    within the forward's plan and, where a gradient will be asked for (grad
    mode is on and an input requires one), within the backward's plan too:
    a forward that launched where the backward cannot would fail mid-step.
    Device and dtype are checked first, so a CPU or float64 tensor never
    builds the library."""
    tensors = (Pinv, Kuf, Sq, q_mu)
    if not all(t.is_cuda and t.dtype == torch.float32 for t in tensors):
        return False
    D, M = Sq.shape[0], Sq.shape[1]
    if not supported(M, D):
        return False
    wants_grad = torch.is_grad_enabled() and any(t.requires_grad
                                                 for t in tensors)
    return not wants_grad or backward_supported(M, D)


def _a_b(Pinv, Kuf, Sq):
    A = Pinv @ Kuf                                     # [M, n]
    B = Sq @ A                                         # [D, M, n]
    return A, B, torch.sum(A * A, dim=0), torch.sum(B * B, dim=1)


@ieee_fp32()
def fused_conditional_white_plain(Pinv, Kuf, q_mu, Sq, Kff):
    """The kernel's function in plain PyTorch, on any device and dtype:
    (mean [n, D], var [n, D]). It reads what the kernel reads, Pinv's lower
    and Sq's upper triangle, which are all there is on the whitened path."""
    A, _, t1, t2 = _a_b(torch.tril(Pinv), Kuf, torch.triu(Sq))
    mean = A.T @ q_mu
    var = torch.clamp_min((Kff - t1) + t2, 0.0).T
    return mean, var


@ieee_fp32()
def fused_conditional_white_backward_plain(Pinv, Kuf, q_mu, Sq, Kff, g_mean,
                                           g_var):
    """The backward kernel's function in plain PyTorch: the cotangents
    (dPinv, dKuf, dq_mu, dSq, dKff) of (mean, var) weighted by
    (g_mean, g_var) [n, D].

    This is the kernel's hand-derived chain written out on whole tensors,
    not autograd of :func:`fused_conditional_white_plain`: the gradient
    passes only where the recomputed ``(Kff - t1) + t2`` is strictly
    positive. dPinv and dSq are projected on the patterns of Pinv (lower)
    and Sq (upper), as the kernel returns them: only those entries reach a
    parameter on the whitened path."""
    A, B, t1, t2 = _a_b(Pinv, Kuf, Sq)
    gv = g_var.T * (((Kff - t1) + t2) > 0.0)           # [D, n]
    s = torch.sum(gv, dim=0)                           # [n]
    gb = (2.0 * B) * gv[:, None, :]                    # [D, M, n]
    dA = (torch.sum(Sq.transpose(1, 2) @ gb, dim=0)
          - (2.0 * A) * s[None, :]
          + q_mu @ g_mean.T)                           # [M, n]
    return (torch.tril(dA @ Kuf.T), Pinv.T @ dA, A @ g_mean,
            torch.triu(gb @ A.T), s)


@ieee_fp32()
def gram_backward_plain(A, dA, Kuf, gv, Sq):
    """Phase B of the whitened backward (#2 and #4) in plain PyTorch:
    (tril(dA Kuf^T), triu(2 Sq[d] A diag(gv_d) A^T)) for A, dA, Kuf [M, n],
    gv [D, n] and Sq [D, M, M]. On the whitened path these are dPinv and
    dSq, since sum_n gb_d a^T = 2 Sq[d] (A diag(gv_d) A^T)."""
    C = (A[None] * gv[:, None, :]) @ A.T               # [D, M, M]
    return torch.tril(dA @ Kuf.T), torch.triu(2.0 * (Sq @ C))


def _library():
    return _build.load(_LIB, _SIGNATURES)


def _checked(Pinv, Kuf, q_mu, Sq, Kff, **cotangents):
    """Device, dtype and shape checks shared by both launches; returns
    (D, M, n)."""
    D, M, n = Sq.shape[0], Kuf.shape[0], Kuf.shape[-1]
    args = dict(Pinv=Pinv, q_mu=q_mu, Sq=Sq, Kff=Kff, **cotangents)
    for name, t in args.items():
        if t.device != Kuf.device:
            raise ValueError(f"{name} is on {t.device}, Kuf on {Kuf.device}")
    for name, t in dict(args, Kuf=Kuf).items():
        if t.dtype != torch.float32:
            raise TypeError(f"the fused conditional takes float32; {name} is {t.dtype}")
    if (Kuf.dim() != 2 or Pinv.shape != (M, M) or q_mu.shape != (M, D)
            or Sq.shape != (D, M, M) or Kff.shape != (n,)
            or any(g.shape != (n, D) for g in cotangents.values())):
        raise ValueError(
            f"shapes Pinv {tuple(Pinv.shape)}, Kuf {tuple(Kuf.shape)}, q_mu "
            f"{tuple(q_mu.shape)}, Sq {tuple(Sq.shape)}, Kff {tuple(Kff.shape)}"
            + "".join(f", {k} {tuple(g.shape)}" for k, g in cotangents.items())
            + " do not form one conditional")
    return D, M, n


def _kernel_operands(Pinv, Kuf, q_mu, Sq, Kff):
    """Contiguous operands in the kernels' layouts: Pinv itself and
    Sq^T = tril(q_sqrt), which both directions stage as packed lower
    triangles (nothing above their diagonals is read)."""
    return (Pinv.contiguous(), Kuf.contiguous(), q_mu.contiguous(),
            Sq.transpose(1, 2).contiguous(), Kff.contiguous())


def _launch(Pinv, Kuf, q_mu, Sq, Kff):
    D, M, n = _checked(Pinv, Kuf, q_mu, Sq, Kff)
    f32 = dict(dtype=torch.float32, device=Kuf.device)
    mean = torch.empty((n, D), **f32)
    var = torch.empty((n, D), **f32)
    if n == 0:
        return mean, var
    operands = _kernel_operands(Pinv, Kuf, q_mu, Sq, Kff)
    lib = _library()
    blocks = grid_blocks(lib, "dgp_conditional_fused_fwd", Kuf.device, M, D)
    run_kernel(lib, lib.dgp_conditional_fused_fwd, Kuf.device,
               "fused whitened conditional kernel launch",
               *[t.data_ptr() for t in operands], mean.data_ptr(),
               var.data_ptr(), n, M, D, blocks)
    FusedConditionalWhite.launches += 1
    return mean, var


def _launch_backward(Pinv, Kuf, q_mu, Sq, Kff, g_mean, g_var):
    D, M, n = _checked(Pinv, Kuf, q_mu, Sq, Kff, g_mean=g_mean, g_var=g_var)
    if n == 0:
        return tuple(torch.zeros_like(t) for t in (Pinv, Kuf, q_mu, Sq, Kff))
    dev = Kuf.device
    f32 = dict(dtype=torch.float32, device=dev)
    pinv, kuf, qm, sqT, kff = _kernel_operands(Pinv, Kuf, q_mu, Sq, Kff)
    gm, gv = g_mean.contiguous(), g_var.contiguous()
    lib = _library()
    if not backward_supported(M, D):
        raise RuntimeError(f"the fused whitened conditional's backward kernel "
                           f"does not take M={M}, D={D}")
    sc = backward_scratch(lib, _PREFIX, n, M, D, M * D, False, dev)
    dKuf = torch.empty((M, n), **f32)
    dKff = torch.empty((n,), **f32)
    for start, count in backward_passes(n):
        blocks = grid_blocks(lib, _PREFIX, dev, count, M, D)
        run_kernel(lib, lib.dgp_conditional_fused_bwd_a, dev,
                   "fused whitened conditional backward phase A launch",
                   pinv.data_ptr(), pointer(kuf, start), n, qm.data_ptr(),
                   sqT.data_ptr(), pointer(kff, start), pointer(gm, start * D),
                   pointer(gv, start * D), pointer(dKuf, start),
                   pointer(dKff, start), sc.a, sc.da, sc.gv, sc.ld,
                   sc.tile_parts, sc.small.data_ptr(), count, M, D, blocks,
                   int(start > 0))
        FusedConditionalWhite.backward_launches += 1
        run_gram(lib, _PREFIX, dev,
                 (sc.a, sc.da, sc.ld, pointer(kuf, start), n, sc.gv),
                 sc.gram_parts, sc.gram, count, M, D, start > 0)
        FusedConditionalWhite.gram_launches += 1
    dPinv, dSq = finish_gram(lib, _PREFIX, dev, sc.gram, sqT, M, D)
    return dPinv, dKuf, sc.small.view(M, D), dSq, dKff


def gram_backward(A, dA, Kuf, gv, Sq):
    """Phase B alone on float32 CUDA tensors, in passes as the backward runs
    it: (dPinv, dSq) as :func:`gram_backward_plain` computes them."""
    return _gram_backward(_library(), _PREFIX, FusedConditionalWhite, A, gv,
                          Sq.transpose(1, 2).contiguous(), dA, Kuf)


class FusedConditionalWhite(torch.autograd.Function):
    """(mean, var) of the whitened conditional from Kuf and Kff, and its
    gradient: the CUDA kernels for CUDA tensors, the plain versions for CPU
    tensors.

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
    def forward(ctx, Pinv, Kuf, q_mu, Sq, Kff):
        ctx.save_for_backward(Pinv, Kuf, q_mu, Sq, Kff)
        if Kuf.is_cuda:
            return _launch(Pinv, Kuf, q_mu, Sq, Kff)
        if Kuf.device.type != "cpu":
            raise ValueError(f"no fused conditional for device {Kuf.device}")
        return fused_conditional_white_plain(Pinv, Kuf, q_mu, Sq, Kff)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        saved = ctx.saved_tensors
        if saved[1].is_cuda:
            return _launch_backward(*saved, g_mean, g_var)
        return fused_conditional_white_backward_plain(*saved, g_mean, g_var)


def fused_conditional_white(Pinv, Kuf, q_mu, Sq, Kff):
    """(mean [n, D], var [n, D]) of the whitened SVGP conditional.

    :param Pinv: Lu^{-1}, [M, M]
    :param Kuf: kernel.K(Z, X), [M, n]
    :param q_mu: [M, D]
    :param Sq: transpose of tril(q_sqrt), [D, M, M]
    :param Kff: kernel.K_diag(X), [n]
    """
    return FusedConditionalWhite.apply(Pinv, Kuf, q_mu, Sq, Kff)
