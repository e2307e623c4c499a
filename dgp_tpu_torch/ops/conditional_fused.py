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

The backward is a second CUDA kernel in the same source (it replaces the
TPU's ``conditional_fused._bwd_kernel``): per point tile it recomputes A and
B, applies the clamp mask ``(Kff - t1) + t2 > 0`` and emits the operator
cotangents. ``dKuf`` and ``dKff`` are written per tile; ``dPinv``, ``dq_mu``
and ``dSq`` are sums over all points, which a fixed number of persistent
blocks accumulate into one slab each, and a second kernel adds the slabs in
a fixed order (deterministic; the scratch is bounded by the number of
blocks, not by n). Autograd carries dKuf and dKff on into ``kernel.K`` and
``kernel.K_diag``, and so to Z, X and the hyperparameters.

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
from ._launch import persistent_grid, run_kernel, split_slab

_LIB = "conditional_fused"
_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "dgp_conditional_fused_fwd": [_P, _P, _P, _P, _P, _P, _P, _N, _I, _I, _P],
    "dgp_conditional_fused_supported": [_I, _I],
    "dgp_conditional_fused_bwd_supported": [_I, _I],
    "dgp_conditional_fused_bwd_blocks": [_N, _I, _I],
    "dgp_conditional_fused_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _N, _I, _I, _I, _P],
}


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
    (mean [n, D], var [n, D])."""
    A, _, t1, t2 = _a_b(Pinv, Kuf, Sq)
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
    positive."""
    A, B, t1, t2 = _a_b(Pinv, Kuf, Sq)
    gv = g_var.T * (((Kff - t1) + t2) > 0.0)           # [D, n]
    s = torch.sum(gv, dim=0)                           # [n]
    gb = (2.0 * B) * gv[:, None, :]                    # [D, M, n]
    dA = (torch.sum(Sq.transpose(1, 2) @ gb, dim=0)
          - (2.0 * A) * s[None, :]
          + q_mu @ g_mean.T)                           # [M, n]
    return dA @ Kuf.T, Pinv.T @ dA, A @ g_mean, gb @ A.T, s


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
    """Contiguous operands in the kernels' layouts: they stage k-major
    panels, Pinv^T and Sq^T = tril(q_sqrt)."""
    return (Pinv.T.contiguous(), Kuf.contiguous(), q_mu.contiguous(),
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
    run_kernel(lib, lib.dgp_conditional_fused_fwd, Kuf.device,
               "fused whitened conditional kernel launch",
               *[t.data_ptr() for t in operands], mean.data_ptr(),
               var.data_ptr(), n, M, D)
    FusedConditionalWhite.launches += 1
    return mean, var


def backward_slab_shapes(M, D):
    """The parts of one block's slab of partial sums, and of the summed
    output: dPinv, dSq, dq_mu."""
    return [(M, M), (D, M, M), (M, D)]


def _launch_backward(Pinv, Kuf, q_mu, Sq, Kff, g_mean, g_var):
    D, M, n = _checked(Pinv, Kuf, q_mu, Sq, Kff, g_mean=g_mean, g_var=g_var)
    if n == 0:
        return tuple(torch.zeros_like(t) for t in (Pinv, Kuf, q_mu, Sq, Kff))
    f32 = dict(dtype=torch.float32, device=Kuf.device)
    operands = _kernel_operands(Pinv, Kuf, q_mu, Sq, Kff)
    gm, gv = g_mean.contiguous(), g_var.contiguous()
    lib = _library()
    shapes = backward_slab_shapes(M, D)
    blocks, scratch, out = persistent_grid(
        lambda: lib.dgp_conditional_fused_bwd_blocks(n, M, D), Kuf.device,
        shapes, f"the fused whitened conditional's backward kernel does not "
        f"take M={M}, D={D}")
    dKuf = torch.empty((M, n), **f32)
    dKff = torch.empty((n,), **f32)
    run_kernel(lib, lib.dgp_conditional_fused_bwd, Kuf.device,
               "fused whitened conditional backward kernel launch",
               *[t.data_ptr() for t in operands], gm.data_ptr(), gv.data_ptr(),
               dKuf.data_ptr(), dKff.data_ptr(), scratch.data_ptr(),
               out.data_ptr(), n, M, D, blocks)
    FusedConditionalWhite.backward_launches += 1
    dPinv, dSq, dq_mu = split_slab(out, shapes)
    return dPinv, dKuf, dq_mu, dSq, dKff


class FusedConditionalWhite(torch.autograd.Function):
    """(mean, var) of the whitened conditional from Kuf and Kff, and its
    gradient: the CUDA kernels for CUDA tensors, the plain versions for CPU
    tensors.

    ``launches`` counts forward-kernel launches and ``backward_launches``
    backward-kernel launches (never plain-version calls)."""

    launches = 0
    backward_launches = 0

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
