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
the design. This slice ports the forward only: the backward kernel comes
with training, and until then :class:`FusedConditional`'s backward raises.

:func:`fused_conditional_plain` is the same function in plain PyTorch. The
wrapper takes it only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..config import ieee_fp32

_LIB = "conditional_fused_rbf"


def supported(M, Din, D):
    """Whether the kernel's shared-memory plan covers these sizes. The plan
    lives in the CUDA source, so this asks the built library (and builds it
    on first use)."""
    return bool(_library().dgp_fused_rbf_supported(M, Din, D))


def fused_kind(kernel, Sq, X):
    """Kernel-kind id (0=RBF, 1=Matern32, 2=Matern52) if the fused kernel
    applies, else None: a plain full-dimension stationary kernel (no
    active_dims), float32 CUDA tensors, and sizes within the kernel's
    shared-memory plan."""
    from .kernels import RBF, Matern32, Matern52

    kind = {RBF: 0, Matern32: 1, Matern52: 2}.get(type(kernel))
    if kind is None or kernel.active_dims is not None:
        return None
    if not (X.is_cuda and X.dtype == torch.float32
            and Sq.dtype == torch.float32):
        return None
    if not supported(Sq.shape[1], X.shape[1], Sq.shape[0]):
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


@ieee_fp32()
def fused_conditional_plain(kind, Pinv, Xs, Zs, variance, q_mu, Sq):
    """The kernel's function in plain PyTorch, on any device and dtype:
    (mean [n, D], var [n, D])."""
    xx = torch.sum(Xs * Xs, dim=1)[None, :]            # [1, n]
    zz = torch.sum(Zs * Zs, dim=1)[:, None]            # [M, 1]
    sqd = torch.clamp_min((xx - 2.0 * (Zs @ Xs.T)) + zz, 0.0)
    kuf = _kuf_tile(kind, variance, sqd)               # [M, n]
    A = Pinv @ kuf
    mean = A.T @ q_mu                                  # [n, D]
    t1 = torch.sum(A * A, dim=0)                       # [n]
    B = Sq @ A                                         # [D, M, n]
    t2 = torch.sum(B * B, dim=1)                       # [D, n]
    var = torch.clamp_min((variance - t1) + t2, 0.0).T
    return mean, var


def _library():
    lib = _build.load(_LIB)
    if lib.dgp_fused_rbf_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dgp_fused_rbf_fwd.argtypes = [i, p, p, p, p, p, p, p, p,
                                          ctypes.c_longlong, i, i, i, p]
        lib.dgp_fused_rbf_fwd.restype = i
        lib.dgp_fused_rbf_supported.argtypes = [i, i, i]
        lib.dgp_fused_rbf_supported.restype = i
    return lib


def _launch(kind, Pinv, Xs, Zs, variance, q_mu, Sq):
    dev = Xs.device
    n, Din = Xs.shape
    D, M = Sq.shape[0], Sq.shape[1]
    args = {"Pinv": Pinv, "Zs": Zs, "variance": variance, "q_mu": q_mu,
            "Sq": Sq}
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Xs on {dev}")
    for name, t in dict(args, Xs=Xs).items():
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; {name} is {t.dtype}")
    if (Pinv.shape != (M, M) or Zs.shape != (M, Din) or q_mu.shape != (M, D)
            or Sq.shape != (D, M, M) or variance.numel() != 1):
        raise ValueError(
            f"shapes Pinv {tuple(Pinv.shape)}, Xs {tuple(Xs.shape)}, Zs "
            f"{tuple(Zs.shape)}, q_mu {tuple(q_mu.shape)}, Sq {tuple(Sq.shape)}"
            " do not form one conditional")
    mean = torch.empty((n, D), dtype=torch.float32, device=dev)
    var = torch.empty((n, D), dtype=torch.float32, device=dev)
    if n == 0:
        return mean, var
    # the kernel stages k-major operands: Pinv^T and Sq^T = tril(q_sqrt)
    pinvT = Pinv.T.contiguous()
    sqT = Sq.transpose(1, 2).contiguous()
    xs, zs, qmu = Xs.contiguous(), Zs.contiguous(), q_mu.contiguous()
    v = variance.reshape(1).contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dgp_fused_rbf_fwd(
            kind, pinvT.data_ptr(), xs.data_ptr(), zs.data_ptr(),
            v.data_ptr(), qmu.data_ptr(), sqT.data_ptr(), mean.data_ptr(),
            var.data_ptr(), n, M, Din, D, stream)
    _build.check(lib, err, "fused conditional kernel launch")
    FusedConditional.launches += 1
    return mean, var


class FusedConditional(torch.autograd.Function):
    """(mean, var) of the whitened stationary conditional: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    ``launches`` counts kernel launches (never plain-version calls)."""

    launches = 0

    @staticmethod
    def forward(ctx, kind, Pinv, Xs, Zs, variance, q_mu, Sq):
        if Xs.is_cuda:
            return _launch(kind, Pinv, Xs, Zs, variance, q_mu, Sq)
        if Xs.device.type != "cpu":
            raise ValueError(f"no fused conditional for device {Xs.device}")
        return fused_conditional_plain(kind, Pinv, Xs, Zs, variance, q_mu, Sq)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        raise NotImplementedError(
            "the fused conditional's backward kernel is ported in the "
            "training slice")


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
