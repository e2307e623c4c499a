"""dgp_tpu_torch — the PyTorch/CUDA port of dgp_tpu for NVIDIA Hopper.

Same module layout and names as ``dgp_tpu``; imports ``torch`` and numpy,
never JAX or the JAX package. Entry points run on the card unless the caller
passes ``device="cpu"``. The CUDA kernels (``csrc/``) build with ``nvcc`` on
first use into ``build/`` beside the package.
"""

from .config import (  # noqa: F401
    default_float,
    default_jitter,
    ieee_fp32,
    kernels_scope,
    use_kernels,
)

_EXPORTS = {
    "AR1CoKriging": ("dgp_tpu_torch.models.cokriging", "AR1CoKriging"),
    "NARGP": ("dgp_tpu_torch.models.nargp", "NARGP"),
    "MultiObjDeepGP": ("dgp_tpu_torch.models.mo_dgp", "MultiObjDeepGP"),
}


def __getattr__(name):
    """Lazy top-level exports, as ``dgp_tpu`` has them (keeps ``import
    dgp_tpu_torch`` light)."""
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'dgp_tpu_torch' has no attribute {name!r}")
