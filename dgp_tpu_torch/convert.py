"""Carry a ``dgp_tpu`` model's weights into the port, and the port's back
out.

:func:`numpy_tree_from_reference` reads a ``dgp_tpu`` ``DGPParams`` by
attribute name with ``np.asarray`` (it imports nothing of JAX or of the JAX
package), and :func:`dgp_from_numpy` builds the port's ``DGPParams`` from
that tree of numpy arrays, so both packages compute from the same numbers.
:func:`numpy_tree_from_port` gives the same tree for the port's own
``DGPParams``, so parameters trained in both packages can be compared. A
multi-fidelity deep GP's ``MFDGPParams`` (:func:`mf_dgp_from_numpy`), its
Embedded Mapping variant's ``MFDGPEMParams`` (:func:`mf_dgp_em_from_numpy`),
the multi-objective deep GP's ``MODGPParams`` (:func:`mo_dgp_from_numpy`,
the same tree as MF-DGP's), an exact GP's ``GPRParams`` (:func:`gpr_from_numpy`), AR(1) co-kriging's
``AR1Params`` (:func:`ar1_from_numpy`) and NARGP's tuple of per-level
``GPRParams`` (:func:`nargp_from_numpy`) go the same way.

The tree is plain data::

    {"layers": [{"kernel": K, "z": [M, Din], "q_mu": [M, D],
                 "q_sqrt": [D, M, M], "mean_function": F,
                 "num_outputs": D, "white": bool, "input_prop_dim": int|None}],
     "likelihood": L}

where an augmented layer (the multi-fidelity and multi-objective models')
holds ``"z_left": [M, D_left]`` in place of ``"z"``, and an
``MFDGPEMParams`` adds ``"layers_red"`` (a list of layers) and
``"likelihood_projection"``.

with K = {"type": "RBF" | "Matern32" | "Matern52", "variance_raw",
"lengthscales_raw", "active_dims"}, {"type": "Linear" | "White",
"variance_raw", "active_dims"} or {"type": "Sum" | "Product", "kernels":
[K, ...]}, and F = {"type": "Zero", "num_outputs"}, {"type": "Identity"} or
{"type": "LinearMean", "W": [Din, D]}, and L = {"type": "Gaussian",
"variance_raw": []}, {"type": "Bernoulli", "num_gh": int} or {"type":
"StudentT", "scale_raw": [], "df": float, "num_gh": int}. A ``GPRParams`` gives
``{"kernel": K, "likelihood": {...}}``, an ``AR1Params`` ``{"kernels":
[K, ...], "rho": [L-1], "likelihoods": [{...}, ...]}`` and NARGP's levels
``{"levels": [{"kernel": K, "likelihood": {...}}, ...]}``. Raw values are
the softplus-unconstrained parameters both packages store.

Stacked starts: the exact models' parameters stacked over a leading starts
axis (the JAX package's ``_starts``) give a tree whose every value carries
that axis, and :func:`ar1_from_numpy` / :func:`gpr_from_numpy` build from
it the stacked module that ``training.multistart_adam`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers.svgp import SVGPLayer
from .models.dgp import DGPParams
from .models.cokriging import AR1Params
from .models.gpr import GPRParams
from .models.mf_dgp import MFDGPParams
from .models.mf_dgp_em import MFDGPEMParams
from .models.mo_dgp import MODGPParams
from .ops import kernels as K
from .ops import likelihoods, means

_STATIONARY = ("RBF", "Matern32", "Matern52")
_VARIANCE_ONLY = ("Linear", "White")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _dims(active_dims):
    return None if active_dims is None else [int(d) for d in active_dims]


def _kernel_tree(kern):
    name = type(kern).__name__
    if name in ("Sum", "Product"):
        return {"type": name, "kernels": [_kernel_tree(k) for k in kern.kernels]}
    tree = {"type": name, "variance_raw": _np(kern.variance_raw),
            "active_dims": _dims(kern.active_dims)}
    if name in _STATIONARY:
        tree["lengthscales_raw"] = _np(kern.lengthscales_raw)
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
        return {"type": name, "W": _np(mf.W)}
    raise TypeError(f"no port of mean function {name}")


def _likelihood_tree(lik):
    name = type(lik).__name__
    if name == "Gaussian":
        return {"type": name, "variance_raw": _np(lik.variance_raw)}
    if name == "Bernoulli":
        return {"type": name, "num_gh": int(lik.num_gh)}
    if name == "StudentT":
        return {"type": name, "scale_raw": _np(lik.scale_raw),
                "df": float(lik.df), "num_gh": int(lik.num_gh)}
    raise TypeError(f"no port of likelihood {name}")


def numpy_tree_from_reference(params) -> dict:
    """The tree of a ``dgp_tpu.models.dgp.DGPParams`` (or of a
    ``dgp_tpu.models.mf_dgp.MFDGPParams``, a
    ``dgp_tpu.models.mf_dgp_em.MFDGPEMParams`` or a
    ``dgp_tpu.models.gpr.GPRParams``) as numpy arrays (the two packages
    name their fields alike, so the port's ``DGPParams``, ``MFDGPParams``,
    ``MFDGPEMParams`` and ``GPRParams`` read the same way:
    :func:`numpy_tree_from_port`), of a ``dgp_tpu.models.cokriging.AR1Params``
    or of a NARGP's tuple of ``GPRParams``."""
    if hasattr(params, "rho"):
        return {"kernels": [_kernel_tree(k) for k in params.kernels],
                "rho": _np(params.rho),
                "likelihoods": [_likelihood_tree(lik)
                                for lik in params.likelihoods]}
    if isinstance(params, (tuple, list, torch.nn.ModuleList)):
        return {"levels": [numpy_tree_from_reference(p) for p in params]}
    if not hasattr(params, "layers"):
        return {"kernel": _kernel_tree(params.kernel),
                "likelihood": _likelihood_tree(params.likelihood)}
    tree = {"layers": [_layer_tree(layer) for layer in params.layers],
            "likelihood": _likelihood_tree(params.likelihood)}
    if hasattr(params, "layers_red"):
        tree["layers_red"] = [_layer_tree(layer) for layer in params.layers_red]
        tree["likelihood_projection"] = _likelihood_tree(
            params.likelihood_projection)
    return tree


def _layer_tree(layer):
    z = "z_left" if getattr(layer, "augmented", False) else "z"
    return {
        "kernel": _kernel_tree(layer.kernel),
        z: _np(getattr(layer, z)),
        "q_mu": _np(layer.q_mu),
        "q_sqrt": _np(layer.q_sqrt),
        "mean_function": _mean_tree(layer.mean_function),
        "num_outputs": int(layer.num_outputs),
        "white": bool(layer.white),
        "input_prop_dim": layer.input_prop_dim,
    }


def numpy_tree_from_port(params) -> dict:
    """The tree of the port's ``DGPParams``, ``MFDGPParams``,
    ``MFDGPEMParams``, ``GPRParams``, ``AR1Params`` or NARGP levels, in the
    layout
    :func:`numpy_tree_from_reference` gives."""
    return numpy_tree_from_reference(params)


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


def _layer(t, device, dtype):
    optional = lambda name: (_array(t[name], device, dtype) if name in t
                             else None)
    return SVGPLayer(
        _kernel(t["kernel"], device, dtype),
        optional("z"),
        _array(t["q_mu"], device, dtype),
        _array(t["q_sqrt"], device, dtype),
        _mean_function(t["mean_function"], device, dtype),
        t["num_outputs"], white=t["white"],
        input_prop_dim=t["input_prop_dim"],
        z_left=optional("z_left"),
    )


def _layered(cls, tree, device, dtype):
    """``cls(layers, likelihood)`` from a tree of numpy arrays."""
    device = torch.device(device)
    return cls([_layer(t, device, dtype) for t in tree["layers"]],
               _likelihood(tree["likelihood"], device, dtype))


def dgp_from_numpy(tree: dict, device, dtype) -> DGPParams:
    """The port's ``DGPParams`` from a tree of numpy arrays, on ``device``
    in ``dtype``."""
    return _layered(DGPParams, tree, device, dtype)


def mf_dgp_from_numpy(tree: dict, device, dtype) -> MFDGPParams:
    """The port's ``MFDGPParams`` (layer 0 plain, the others augmented) from
    a tree of numpy arrays, on ``device`` in ``dtype``."""
    return _layered(MFDGPParams, tree, device, dtype)


def mo_dgp_from_numpy(tree: dict, device, dtype) -> MODGPParams:
    """The port's ``MODGPParams`` from a tree of numpy arrays (MF-DGP's
    layout: layer 0 plain, the others augmented), on ``device`` in
    ``dtype``."""
    return _layered(MODGPParams, tree, device, dtype)


def mf_dgp_em_from_numpy(tree: dict, device, dtype) -> MFDGPEMParams:
    """The port's ``MFDGPEMParams`` (fidelity layers, reduction layers and
    both likelihoods) from a tree of numpy arrays, on ``device`` in
    ``dtype``."""
    device = torch.device(device)
    return MFDGPEMParams(
        [_layer(t, device, dtype) for t in tree["layers"]],
        [_layer(t, device, dtype) for t in tree["layers_red"]],
        _likelihood(tree["likelihood"], device, dtype),
        _likelihood(tree["likelihood_projection"], device, dtype))


def _likelihood(tree, device, dtype):
    name = tree["type"]
    if name == "Gaussian":
        return likelihoods.Gaussian(_tensor(tree["variance_raw"], device, dtype))
    if name == "Bernoulli":
        return likelihoods.Bernoulli(tree["num_gh"])
    if name == "StudentT":
        return likelihoods.StudentT(_tensor(tree["scale_raw"], device, dtype),
                                    tree["df"], tree["num_gh"])
    raise TypeError(f"no port of likelihood {name}")


def gpr_from_numpy(tree: dict, device, dtype) -> GPRParams:
    """The port's ``GPRParams`` from a tree of numpy arrays (stacked over a
    leading starts axis where the tree's values are), on ``device`` in
    ``dtype``."""
    device = torch.device(device)
    return GPRParams(_kernel(tree["kernel"], device, dtype),
                     _likelihood(tree["likelihood"], device, dtype))


def ar1_from_numpy(tree: dict, device, dtype) -> AR1Params:
    """The port's ``AR1Params`` from a tree of numpy arrays (stacked over a
    leading starts axis where the tree's values are), on ``device`` in
    ``dtype``."""
    device = torch.device(device)
    return AR1Params(
        [_kernel(t, device, dtype) for t in tree["kernels"]],
        _tensor(tree["rho"], device, dtype),
        [_likelihood(t, device, dtype) for t in tree["likelihoods"]])


def nargp_from_numpy(tree: dict, device, dtype) -> torch.nn.ModuleList:
    """A NARGP's per-level ``GPRParams`` (an ``nn.ModuleList``) from a tree
    of numpy arrays, on ``device`` in ``dtype``."""
    return torch.nn.ModuleList(gpr_from_numpy(t, device, dtype)
                               for t in tree["levels"])
