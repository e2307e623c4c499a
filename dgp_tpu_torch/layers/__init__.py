"""Sparse variational GP layers and their initialization."""

from .initializations import init_layers_linear  # noqa: F401
from .svgp import (  # noqa: F401
    SVGPLayer,
    conditional_snd,
    layer_kl,
    make_svgp_layer,
    mean_propagated_sample,
    sample_from_conditional,
)
