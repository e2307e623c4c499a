"""dgp_tpu_torch — the PyTorch/CUDA port of dgp_tpu for NVIDIA Hopper.

Same module layout and names as ``dgp_tpu``; imports ``torch`` and numpy,
never JAX or the JAX package. Entry points run on the card unless the caller
passes ``device="cpu"``. The CUDA kernels (``csrc/``) build with ``nvcc`` on
first use into ``build/`` beside the package.
"""

from . import config  # noqa: F401
from .config import (  # noqa: F401
    default_float,
    default_jitter,
    ieee_fp32,
    kernels_scope,
    set_default_float,
    set_default_jitter,
    use_kernels,
)

__version__ = "0.1.0"

# name -> (module, attribute); attribute None exports the module itself
_EXPORTS = {
    "DGP": ("dgp_tpu_torch.models.dgp", "DGP"),
    "GPR": ("dgp_tpu_torch.models.gpr", "GPR"),
    "MultiFidelityDeepGP": ("dgp_tpu_torch.models.mf_dgp",
                            "MultiFidelityDeepGP"),
    "MultiFidelityDeepGP_EM": ("dgp_tpu_torch.models.mf_dgp_em",
                               "MultiFidelityDeepGP_EM"),
    "MultiObjDeepGP": ("dgp_tpu_torch.models.mo_dgp", "MultiObjDeepGP"),
    "AR1CoKriging": ("dgp_tpu_torch.models.cokriging", "AR1CoKriging"),
    "NARGP": ("dgp_tpu_torch.models.nargp", "NARGP"),
    "SO_BO": ("dgp_tpu_torch.bo.so_bo", "SO_BO"),
    "MO_BO": ("dgp_tpu_torch.bo.mo_bo", "MO_BO"),
    "MF_BO": ("dgp_tpu_torch.bo.mf_bo", "MF_BO"),
    "kernels": ("dgp_tpu_torch.ops.kernels", None),
    "likelihoods": ("dgp_tpu_torch.ops.likelihoods", None),
    "summary": ("dgp_tpu_torch.utils.monitor", "summary"),
    "parallel": ("dgp_tpu_torch.parallel", None),
}


def __getattr__(name):
    """Lazy top-level exports, as ``dgp_tpu`` has them (keeps ``import
    dgp_tpu_torch`` light)."""
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        mod = importlib.import_module(module)
        return getattr(mod, attr) if attr else mod
    raise AttributeError(f"module 'dgp_tpu_torch' has no attribute {name!r}")
