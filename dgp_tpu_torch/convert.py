"""Carry a ``dgp_tpu`` model's weights into the port.

:func:`numpy_tree_from_reference` reads a ``dgp_tpu`` ``DGPParams`` by
attribute name with ``np.asarray`` (it imports nothing of JAX or of the JAX
package), and :func:`dgp_from_numpy` builds the port's ``DGPParams`` from
that tree of numpy arrays, so both packages compute from the same numbers.

The tree is plain data::

    {"layers": [{"kernel": K, "z": [M, Din], "q_mu": [M, D],
                 "q_sqrt": [D, M, M], "mean_function": F,
                 "num_outputs": D, "white": bool, "input_prop_dim": int|None}],
     "likelihood": {"type": "Gaussian", "variance_raw": []}}

with K = {"type": "RBF" | "Matern32" | "Matern52", "variance_raw",
"lengthscales_raw", "active_dims"}, {"type": "Linear" | "White",
"variance_raw", "active_dims"} or {"type": "Sum" | "Product", "kernels":
[K, ...]}, and F = {"type": "Zero", "num_outputs"}, {"type": "Identity"} or
{"type": "LinearMean", "W": [Din, D]}. Raw values are the
softplus-unconstrained parameters both packages store.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers.svgp import SVGPLayer
from .models.dgp import DGPParams
from .ops import kernels as K
from .ops import likelihoods, means

_STATIONARY = ("RBF", "Matern32", "Matern52")
_VARIANCE_ONLY = ("Linear", "White")


def _dims(active_dims):
    return None if active_dims is None else [int(d) for d in active_dims]


def _kernel_tree(kern):
    name = type(kern).__name__
    if name in ("Sum", "Product"):
        return {"type": name, "kernels": [_kernel_tree(k) for k in kern.kernels]}
    tree = {"type": name, "variance_raw": np.asarray(kern.variance_raw),
            "active_dims": _dims(kern.active_dims)}
    if name in _STATIONARY:
        tree["lengthscales_raw"] = np.asarray(kern.lengthscales_raw)
    elif name not in _VARIANCE_ONLY:
        raise TypeError(f"no port of kernel {name}")
    return tree


def _mean_tree(mf):
    name = type(mf).__name__
    if name == "Zero":
        return {"type": name, "num_outputs": int(mf.num_outputs)}
    if name == "Identity":
        return {"type": name}
    if name == "LinearMean":
        return {"type": name, "W": np.asarray(mf.W)}
    raise TypeError(f"no port of mean function {name}")


def numpy_tree_from_reference(params) -> dict:
    """The tree of a ``dgp_tpu.models.dgp.DGPParams`` as numpy arrays."""
    layers = []
    for layer in params.layers:
        if getattr(layer, "augmented", False):
            raise TypeError("augmented layers are ported with the "
                            "multi-fidelity models")
        layers.append({
            "kernel": _kernel_tree(layer.kernel),
            "z": np.asarray(layer.z),
            "q_mu": np.asarray(layer.q_mu),
            "q_sqrt": np.asarray(layer.q_sqrt),
            "mean_function": _mean_tree(layer.mean_function),
            "num_outputs": int(layer.num_outputs),
            "white": bool(layer.white),
            "input_prop_dim": layer.input_prop_dim,
        })
    lik = params.likelihood
    if type(lik).__name__ != "Gaussian":
        raise TypeError(f"no port of likelihood {type(lik).__name__}")
    return {"layers": layers,
            "likelihood": {"type": "Gaussian",
                           "variance_raw": np.asarray(lik.variance_raw)}}


def _array(a, device, dtype):
    # np.array copies: arrays read from JAX are not writable
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _tensor(a, device, dtype):
    return torch.nn.Parameter(_array(a, device, dtype))


def _kernel(tree, device, dtype):
    name = tree["type"]
    if name in ("Sum", "Product"):
        parts = [_kernel(t, device, dtype) for t in tree["kernels"]]
        return getattr(K, name)(parts)
    var = _tensor(tree["variance_raw"], device, dtype)
    if name in _STATIONARY:
        return getattr(K, name)(
            var, _tensor(tree["lengthscales_raw"], device, dtype),
            tree["active_dims"])
    if name in _VARIANCE_ONLY:
        return getattr(K, name)(var, tree["active_dims"])
    raise TypeError(f"no port of kernel {name}")


def _mean_function(tree, device, dtype):
    name = tree["type"]
    if name == "Zero":
        return means.Zero(tree["num_outputs"])
    if name == "Identity":
        return means.Identity()
    if name == "LinearMean":
        return means.LinearMean(_array(tree["W"], device, dtype))
    raise TypeError(f"no port of mean function {name}")


def dgp_from_numpy(tree: dict, device, dtype) -> DGPParams:
    """The port's ``DGPParams`` from a tree of numpy arrays, on ``device``
    in ``dtype``."""
    device = torch.device(device)
    layers = [
        SVGPLayer(
            _kernel(t["kernel"], device, dtype),
            _array(t["z"], device, dtype),
            _array(t["q_mu"], device, dtype),
            _array(t["q_sqrt"], device, dtype),
            _mean_function(t["mean_function"], device, dtype),
            t["num_outputs"], white=t["white"],
            input_prop_dim=t["input_prop_dim"],
        )
        for t in tree["layers"]
    ]
    lik = tree["likelihood"]
    if lik["type"] != "Gaussian":
        raise TypeError(f"no port of likelihood {lik['type']}")
    likelihood = likelihoods.Gaussian(_tensor(lik["variance_raw"], device, dtype))
    return DGPParams(layers, likelihood)
