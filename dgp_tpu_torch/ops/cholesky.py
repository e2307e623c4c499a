"""Batched Cholesky factor, and the factor with its inverse, of a stack of
symmetric positive-definite matrices (the port's counterpart of the TPU
kernels in ``benchmarks/chol_probe.py``):

    L = chol(A)                     kernel #7  (``_chol_kernel``)
    (L, W = L^{-1})                 kernel #8  (``_chol_inv_kernel``)

for A [G, M, M]. The CUDA kernels (``csrc/cholesky.cu``) run one block per
matrix with the matrix in shared memory; they neither raise nor read anything
back to the host. A matrix that is not positive definite comes out as
``jnp.linalg.cholesky`` and ``jsl.solve_triangular`` give it: L NaN on and
below the diagonal, W all NaN; the plain versions do the same
(``torch.linalg.cholesky_ex`` with NaN where ``info > 0``). No call here
raises on such a matrix, and none syncs the host to find out.

The gradients are the closed-form Cholesky adjoint in plain PyTorch (the
TPU kernels had no backward kernel; the probe prescribes the solve-based
gradient): with L-bar the cotangent of L (for #8 first
L-bar <- L-bar - tril(W^T W-bar W^T), W-bar that of W),

    Phi   = tril(L^T L-bar) with its diagonal halved
    A-bar = sym(L^{-T} Phi L^{-1})

where #8 multiplies by its own W and #7 takes two triangular solves.

:class:`Cholesky` and :class:`CholeskyInverse` take the plain forward only
for CPU tensors; for CUDA tensors they launch the kernel or raise. The
dispatch (:func:`cholesky`, :func:`cholesky_inverse`) takes the plain
versions, with PyTorch's own autograd, where :func:`applicable` is false:
float64, CPU tensors, or M outside the kernels' plan.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..config import ieee_fp32, use_kernels
from ._launch import run_kernel

_LIB = "cholesky"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dgp_cholesky_supported": [_I, _I],
    "dgp_cholesky": [_P, _P, _P, _I, _I, _P],
}


def supported(M, inverse=False):
    """Whether the kernel's shared-memory plan takes M x M matrices. The
    plan lives in the CUDA source, so this asks the built library (and
    builds it on first use), once for each (M, inverse)."""
    return _supported(int(M), bool(inverse))


@functools.lru_cache(maxsize=None)
def _supported(M, inverse):
    return bool(_library().dgp_cholesky_supported(M, int(inverse)))


def applicable(A, inverse=False):
    """Whether the kernel takes A: a float32 CUDA stack [G, M, M] within
    the plan. Device and dtype are asked first, so CPU and float64 tensors
    never build anything."""
    return (A.is_cuda and A.dtype == torch.float32 and A.dim() == 3
            and supported(A.shape[-1], inverse))


def _factor_plain(A):
    """(L, failed): L with NaN in the lower triangle of every matrix whose
    factorization failed (zeros above, as ``jnp.linalg.cholesky`` gives
    it), and the [..., 1, 1] mask of those matrices."""
    L, info = torch.linalg.cholesky_ex(A)
    failed = (info > 0)[..., None, None]
    return torch.tril(torch.where(failed, float("nan"), L)), failed


def cholesky_plain(A):
    """Lower Cholesky factor of a [..., M, M] stack; a matrix that is not
    positive definite gives NaN on and below the diagonal (no raise, no
    host sync)."""
    return _factor_plain(A)[0]


@ieee_fp32()
def cholesky_inverse_plain(A):
    """(L, W = L^{-1}) of a [..., M, M] stack; L as :func:`cholesky_plain`,
    W all NaN where the factorization failed."""
    L, failed = _factor_plain(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(L.shape)
    W = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, torch.where(failed, float("nan"), W)


@ieee_fp32()
def cholesky_backward(L, gL, W=None, gW=None):
    """A-bar of L = chol(A) (and W = L^{-1} when given) for the cotangents
    gL and gW (either may be None). The Cholesky adjoint, written out; W, where
    given, stands in for L^{-1} instead of two triangular solves."""
    if gL is None:
        gL = torch.zeros_like(L)
    if gW is not None:
        gL = gL - torch.tril(W.mT @ gW @ W.mT)
    phi = torch.tril(L.mT @ gL)
    phi = phi - 0.5 * torch.diag_embed(torch.diagonal(phi, dim1=-2, dim2=-1))
    if W is None:
        # L^{-T} phi, then (.) L^{-1}
        gA = torch.linalg.solve_triangular(L.mT, phi, upper=True)
        gA = torch.linalg.solve_triangular(L, gA, upper=False, left=False)
    else:
        gA = W.mT @ phi @ W
    return 0.5 * (gA + gA.mT)


def _library():
    return _build.load(_LIB, _SIGNATURES)


def _launch(A, inverse):
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"the Cholesky kernel takes a [G, M, M] stack, not "
                         f"{tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"the Cholesky kernel takes float32, not {A.dtype}")
    G, M = A.shape[0], A.shape[-1]
    L = torch.empty_like(A, memory_format=torch.contiguous_format)
    W = torch.empty_like(L) if inverse else None
    if G > 0:
        if not supported(M, inverse):
            raise RuntimeError(f"the Cholesky kernel does not take M={M}"
                               + (" with its inverse" if inverse else ""))
        Ac = A.contiguous()
        lib = _library()
        run_kernel(lib, lib.dgp_cholesky, A.device, "Cholesky kernel launch",
                   Ac.data_ptr(), L.data_ptr(),
                   None if W is None else W.data_ptr(), G, M)
        (CholeskyInverse if inverse else Cholesky).launches += 1
    return (L, W) if inverse else L


def _forward(A, inverse):
    if A.is_cuda:
        return _launch(A, inverse)
    if A.device.type != "cpu":
        raise ValueError(f"no Cholesky kernel for device {A.device}")
    return cholesky_inverse_plain(A) if inverse else cholesky_plain(A)


class Cholesky(torch.autograd.Function):
    """L of a [G, M, M] stack (kernel #7) and its gradient. ``launches``
    counts kernel launches (never plain-version calls)."""

    launches = 0

    @staticmethod
    def forward(ctx, A):
        ctx.set_materialize_grads(False)
        L = _forward(A, False)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        (L,) = ctx.saved_tensors
        if gL is None:
            return None
        return cholesky_backward(L, gL)


class CholeskyInverse(torch.autograd.Function):
    """(L, W = L^{-1}) of a [G, M, M] stack (kernel #8) and their gradient.
    ``launches`` counts kernel launches."""

    launches = 0

    @staticmethod
    def forward(ctx, A):
        ctx.set_materialize_grads(False)
        L, W = _forward(A, True)
        ctx.save_for_backward(L, W)
        return L, W

    @staticmethod
    def backward(ctx, gL, gW):
        L, W = ctx.saved_tensors
        if gL is None and gW is None:
            return None
        return cholesky_backward(L, gL, W, gW)


def _stacked(A):
    """A as a [G, M, M] stack, and the shape to give the results back in."""
    return A.reshape(-1, *A.shape[-2:]), A.shape


def cholesky(A):
    """L of a [..., M, M] stack: kernel #7 where :func:`applicable`, else
    the plain version. Never raises on a matrix that is not positive
    definite: that matrix's L is NaN."""
    stack, shape = _stacked(A)
    if use_kernels() and applicable(stack):
        return Cholesky.apply(stack).reshape(shape)
    return cholesky_plain(A)


def cholesky_inverse(A):
    """(L, W = L^{-1}) of a [..., M, M] stack: kernel #8 where
    :func:`applicable`, else the plain version; NaN as :func:`cholesky`."""
    stack, shape = _stacked(A)
    if use_kernels() and applicable(stack, inverse=True):
        L, W = CholeskyInverse.apply(stack)
        return L.reshape(shape), W.reshape(shape)
    return cholesky_inverse_plain(A)
