"""Variational quadform of the SVGP conditional variance (counterpart of
``dgp_tpu/ops/quadform_pallas.py``):

    t2[d, n] = ||Sq[d] @ A[:, n]||^2       and optionally   t1[n] = ||A[:, n]||^2

for Sq [D, M, M] and A [M, n]. On the conditional's path Sq = tril(q_sqrt)^T
is upper-triangular, and every function here reads only Sq's upper
triangle. The plain version materializes B = Sq @ A, a [D, M, n] tensor
(4.1 GB in float32 at D = 8, M = 128, n = 1e6); the CUDA kernels
(``csrc/quadform.cu``, which replace the TPU's ``quadform_pallas._fwd_kernel``
and ``_bwd_kernel``) never write it. The forward computes B tile by tile,
its products on the tensor cores in 3xTF32. The backward runs in two CUDA
phases: phase A recomputes B per point tile and chains

    gb_d   = 2 B_d * g2[d]
    dA     = sum_d Sq[d]^T gb_d  (+ 2 A * g1)

and phase B forms the sum over all points as split-K Grams summed in a
fixed order (deterministic), in passes of ``_launch.BACKWARD_PASS`` points:

    dSq[d] = triu(gb_d A^T) = triu(2 Sq[d] A diag(g2[d]) A^T)

dSq comes out on Sq's pattern, exact zeros below the diagonal, on the card
and on the CPU alike; tril(q_sqrt) cuts the rest on the path, so model
gradients are those of the full square.

:func:`quadform_t2_reference`, :func:`quadform_t2_t1_reference` and
:func:`quadform_backward_plain` are the same functions in plain PyTorch.
:class:`QuadForm` takes them only for tensors on the CPU; for CUDA tensors it
launches the kernels or raises. The dispatch (:func:`quadform_t2`,
:func:`quadform_t2_t1`) takes the plain versions where :func:`applicable` is
false: float64, CPU tensors, or sizes outside the kernels' plans.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..config import ieee_fp32, use_kernels
from ._launch import gram_backward, grid_blocks, run_kernel

_LIB = "quadform"
_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "dgp_quadform_fwd": [_P, _P, _P, _P, _N, _I, _I, _I, _P],
    "dgp_quadform_fwd_blocks": [_I, _I],
    "dgp_quadform_supported": [_I, _I],
    "dgp_quadform_bwd_supported": [_I, _I],
    "dgp_quadform_bwd_a_blocks": [_I, _I],
    "dgp_quadform_bwd_slice": [],
    "dgp_quadform_bwd_a": [_P, _P, _P, _P, _P, _N, _I, _I, _I, _P],
    "dgp_quadform_bwd_gram": [_P, _N, _P, _P, _P, _N, _I, _I, _I, _P],
    "dgp_quadform_bwd_finish": [_P, _P, _P, _I, _I, _P],
}
_PREFIX = "dgp_quadform_bwd"


def supported(M, D):
    """Whether the forward kernel's shared-memory plan covers these sizes.
    The plan lives in the CUDA source, so this asks the built library (and
    builds it on first use)."""
    return bool(_library().dgp_quadform_supported(M, D))


def backward_supported(M, D):
    """Whether the backward kernels' plans (phase A's shared memory) cover
    these sizes."""
    return bool(_library().dgp_quadform_bwd_supported(M, D))


def applicable(Sq, A):
    """Whether the kernels take (Sq, A): float32 CUDA tensors within the
    forward's plan and, where a gradient will be asked for (grad mode is on
    and Sq or A requires one), within the backward's plan too: a forward
    that launched where the backward cannot would fail mid-step."""
    if not (A.is_cuda and Sq.is_cuda and A.dtype == torch.float32
            and Sq.dtype == torch.float32):
        return False
    D, M = Sq.shape[0], Sq.shape[1]
    if not supported(M, D):
        return False
    wants_grad = torch.is_grad_enabled() and (Sq.requires_grad
                                              or A.requires_grad)
    return not wants_grad or backward_supported(M, D)


@ieee_fp32()
def quadform_t2_reference(Sq, A):
    """t2[d, n] = ||Sq[d] @ A[:, n]||^2, materializing B = Sq @ A. It reads
    what the kernel reads, Sq's upper triangle, which is all there is on
    the conditional's path."""
    B = torch.triu(Sq) @ A[None]               # [D, M, n]
    return torch.sum(B * B, dim=1)


def quadform_t2_t1_reference(Sq, A):
    """(t2 [D, n], t1 = ||A||^2 per point [n])."""
    return quadform_t2_reference(Sq, A), torch.sum(A * A, dim=0)


@ieee_fp32()
def quadform_backward_plain(Sq, A, g2, g1=None):
    """The backward kernels' function in plain PyTorch: the cotangents
    (dSq [D, M, M], dA [M, n]) of t2 weighted by g2 [D, n], and of t1 by
    g1 [n] when given. The hand-derived chain on whole tensors, not
    autograd of the reference. Like the kernels it reads Sq's upper
    triangle only and returns dSq on that pattern."""
    Sq = torch.triu(Sq)
    B = Sq @ A[None]                           # [D, M, n]
    gb = (2.0 * B) * g2[:, None, :]
    dA = torch.sum(Sq.transpose(1, 2) @ gb, dim=0)
    if g1 is not None:
        dA = dA + (2.0 * A) * g1[None, :]
    return torch.triu(gb @ A.T), dA


def _library():
    return _build.load(_LIB, _SIGNATURES)


def _checked(Sq, A, **cotangents):
    """Device, dtype and shape checks shared by both launches; returns
    (D, M, n)."""
    D, M, n = Sq.shape[0], A.shape[0], A.shape[-1]
    shapes = {"Sq": (D, M, M), "A": (M, n), "g2": (D, n), "g1": (n,)}
    for name, t in dict(Sq=Sq, **cotangents).items():
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    for name, t in dict(cotangents, Sq=Sq, A=A).items():
        if t.dtype != torch.float32:
            raise TypeError(f"the quadform kernel takes float32; {name} is {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"shapes Sq {tuple(Sq.shape)}, A {tuple(A.shape)}"
                + "".join(f", {k} {tuple(g.shape)}" for k, g in cotangents.items())
                + " do not form one quadform")
    return D, M, n


def _operands(Sq, A):
    """Contiguous operands in the kernels' layouts: Sq^T = tril(q_sqrt)
    (contiguous as the path builds it), whose lower triangle both
    directions stage as packed rows, and A."""
    return Sq.transpose(1, 2).contiguous(), A.contiguous()


def _launch(Sq, A, with_t1):
    D, M, n = _checked(Sq, A)
    f32 = dict(dtype=torch.float32, device=A.device)
    t2 = torch.empty((D, n), **f32)
    t1 = torch.empty((n,), **f32) if with_t1 else None
    if n > 0:
        sqT, Ac = _operands(Sq, A)
        lib = _library()
        blocks = grid_blocks(lib, "dgp_quadform_fwd", A.device, M, D)
        run_kernel(lib, lib.dgp_quadform_fwd, A.device, "quadform kernel launch",
                   sqT.data_ptr(), Ac.data_ptr(), t2.data_ptr(),
                   None if t1 is None else t1.data_ptr(), n, M, D, blocks)
        QuadForm.launches += 1
    return (t2, t1) if with_t1 else t2


def _launch_backward(Sq, A, g2, g1):
    cotangents = dict(g2=g2) if g1 is None else dict(g2=g2, g1=g1)
    D, M, n = _checked(Sq, A, **cotangents)
    if n == 0:
        return torch.zeros_like(Sq), torch.zeros_like(A)
    sqT, Ac = _operands(Sq, A)
    g2c = g2.contiguous()
    g1c = None if g1 is None else g1.contiguous()
    lib = _library()
    blocks = grid_blocks(lib, "dgp_quadform_bwd_a", A.device, M, D)
    if blocks < 1:
        raise RuntimeError(f"the quadform's backward kernel does not take "
                           f"M={M}, D={D}")
    dA = torch.empty((M, n), dtype=torch.float32, device=A.device)
    run_kernel(lib, lib.dgp_quadform_bwd_a, A.device,
               "quadform backward phase A launch", sqT.data_ptr(),
               Ac.data_ptr(), g2c.data_ptr(),
               None if g1c is None else g1c.data_ptr(), dA.data_ptr(), n, M,
               D, blocks)
    QuadForm.backward_launches += 1
    _, dSq = gram_backward(lib, _PREFIX, QuadForm, Ac, g2c, sqT)
    return dSq, dA


class QuadForm(torch.autograd.Function):
    """t2 (``with_t1`` False) or (t2, t1) and their gradient: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors. Both
    read Sq's upper triangle only and give dSq on that pattern.

    ``launches`` counts forward-kernel launches, ``backward_launches`` the
    backward's phase-A launches (one per call) and ``gram_launches`` its
    phase-B launches (one per pass of points); never plain-version
    calls."""

    launches = 0
    backward_launches = 0
    gram_launches = 0

    @staticmethod
    def forward(ctx, Sq, A, with_t1):
        ctx.save_for_backward(Sq, A)
        if A.is_cuda:
            return _launch(Sq, A, with_t1)
        if A.device.type != "cpu":
            raise ValueError(f"no quadform for device {A.device}")
        if with_t1:
            return quadform_t2_t1_reference(Sq, A)
        return quadform_t2_reference(Sq, A)

    @staticmethod
    def backward(ctx, g2, g1=None):
        Sq, A = ctx.saved_tensors
        if A.is_cuda:
            dSq, dA = _launch_backward(Sq, A, g2, g1)
        else:
            dSq, dA = quadform_backward_plain(Sq, A, g2, g1)
        return dSq, dA, None


def quadform_t2(Sq, A):
    """t2 [D, n]: the kernel where :func:`applicable`, else the plain
    version (the dispatch of ``quadform_pallas.quadform_t2``)."""
    if use_kernels() and applicable(Sq, A):
        return QuadForm.apply(Sq, A, False)
    return quadform_t2_reference(Sq, A)


def quadform_t2_t1(Sq, A):
    """(t2 [D, n], t1 [n]) in one pass for the whitened path, with the same
    dispatch."""
    if use_kernels() and applicable(Sq, A):
        return QuadForm.apply(Sq, A, True)
    return quadform_t2_t1_reference(Sq, A)
