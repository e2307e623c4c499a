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
