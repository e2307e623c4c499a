"""Numeric configuration and device policy of the PyTorch port.

Counterpart of ``dgp_tpu/config.py``. What carries over:

* ``default_float()`` — the working dtype when a caller gives none
  (float32, the dtype the card serves in). Nothing here ever calls
  ``torch.set_default_dtype``: every tensor is made with an explicit dtype,
  and CPU parity runs pass ``dtype=torch.float64``.
* ``default_jitter(dtype)`` — diagonal jitter before every Cholesky, 1e-6 in
  float64 and 1e-4 in float32, as in the JAX package.
* ``use_kernels()`` — the counterpart of ``set_use_pallas``: whether the
  conditional may dispatch to the hand-written CUDA kernels. A kernel still
  runs only where its gate holds (f32 CUDA tensors, supported shapes).

What does not: the MXU pass-count knobs (``quad_precision``,
``bwd_precision``) exist only for the TPU's bf16 passes.

fp32 policy: IEEE float32 everywhere, no TF32, whatever the process has
set. The port's entry points and conditionals run their PyTorch products
inside :func:`ieee_fp32`, which turns TF32 off for the call and restores the
caller's setting on exit; the port's kernels use plain fp32 FMA. The
whitened variance ``v - ||A||^2 + ||B||^2`` cancels in its first two terms,
and TF32's ~1e-3 relative error in A would swamp it.
"""

from __future__ import annotations

import contextlib

import torch

_STATE = {"use_kernels": True}


def default_float():
    return torch.float32


def default_jitter(dtype=None) -> float:
    dtype = default_float() if dtype is None else dtype
    return 1e-6 if dtype == torch.float64 else 1e-4


def use_kernels() -> bool:
    return _STATE["use_kernels"]


@contextlib.contextmanager
def kernels_scope(value: bool):
    """Set :func:`use_kernels` inside the scope, restoring it on exit: True
    (the default) lets the conditional dispatch to the CUDA kernels where
    their gates hold; False forces the plain PyTorch path."""
    old = _STATE["use_kernels"]
    _STATE["use_kernels"] = bool(value)
    try:
        yield
    finally:
        _STATE["use_kernels"] = old


# float32 matmul precision (the older setting) that agrees with each value
# of torch.backends.cuda.matmul.fp32_precision (the newer one)
_MATMUL_PRECISION = {"tf32": "high", "bf16": "medium"}


@contextlib.contextmanager
def ieee_fp32():
    """IEEE fp32 (no TF32) for PyTorch's float32 matrix products inside the
    scope; also a decorator. PyTorch keeps two settings for this, and
    reading the older one raises once they disagree, so the scope sets both
    together and on exit puts back the caller's newer setting
    (``torch.backends.cuda.matmul.fp32_precision``) with the older one made
    to agree. Both settings are process-wide, so other threads' products
    inside the scope run IEEE too. The port runs no convolutions: cuDNN's
    setting is left alone."""
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(_MATMUL_PRECISION.get(old, "highest"))
        matmul.fp32_precision = old


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card and no ``device``, raise instead of quietly
    running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
