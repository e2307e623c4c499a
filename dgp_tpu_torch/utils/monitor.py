"""Observability helpers (counterpart of ``dgp_tpu/utils/monitor.py``): a
tensor summary, a parameter table of any model, per-tensor gradient norms
and per-step training metrics.

Names follow the JAX package's pytree paths (``layers[0].kernel.variance``),
and rows come in its leaf order: the port's modules name their fields as
the JAX package's dataclasses do, and :data:`_FIELD_ORDER` gives the order
in which those dataclasses declare them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.transforms import positive

# the JAX package's dataclass fields, in their order of declaration:
# DGPParams (and the MF, EM and MO params) layers, layers_red, likelihood,
# likelihood_projection; AR1Params kernels, rho, likelihoods; GPRParams
# kernel, likelihood; SVGPLayer kernel, z, z_left, q_mu, q_sqrt,
# mean_function; a stationary kernel variance_raw, lengthscales_raw
_FIELD_ORDER = ("layers", "layers_red", "kernel", "kernels", "variance_raw",
                "lengthscales_raw", "z", "z_left", "q_mu", "q_sqrt",
                "mean_function", "W", "rho", "likelihoods", "likelihood",
                "likelihood_projection", "scale_raw")


def summarize_tensor(x, title: str = "") -> dict:
    """Shape / NaN / moment summary of a tensor. Returns the stats dict and
    prints a human-readable block."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    stats = {
        "title": title,
        "shape": tuple(x.shape),
        "nans": int(np.isnan(x).sum()),
        "near_zero": int((np.abs(x) < 1e-8).sum()),
        "mean": float(np.nanmean(x)) if x.size else float("nan"),
        "std": float(np.nanstd(x)) if x.size else float("nan"),
        "min": float(np.nanmin(x)) if x.size else float("nan"),
        "max": float(np.nanmax(x)) if x.size else float("nan"),
    }
    bar = "-" * 10
    print(f"{bar}{title}{bar}")
    for k in ("shape", "nans", "near_zero", "mean", "std", "min", "max"):
        print(f"{k}: {stats[k]}")
    print("-" * (20 + len(title)))
    return stats


def _rank(name):
    return _FIELD_ORDER.index(name) if name in _FIELD_ORDER else len(_FIELD_ORDER)


def named_leaves(module: nn.Module, prefix: str = ""):
    """(path, tensor) over a module's parameters and buffers in the JAX
    package's leaf order, paths as its ``keystr`` writes them (list items
    as ``[i]``, fields as ``.name``). Fields outside :data:`_FIELD_ORDER`
    follow, tensors before submodules, each in registration order."""
    entries = [(name, t) for name, t in module._parameters.items()]
    entries += [(name, t) for name, t in module._buffers.items()]
    entries += [(name, m) for name, m in module._modules.items()]
    entries.sort(key=lambda e: (_rank(e[0]), isinstance(e[1], nn.Module)))
    list_like = isinstance(module, (nn.ModuleList, nn.Sequential))
    for name, value in entries:
        if value is None:
            continue
        path = f"{prefix}[{name}]" if list_like else f"{prefix}.{name}"
        if isinstance(value, nn.Module):
            yield from named_leaves(value, path)
        else:
            yield path, value


def _leaf_transform(path: str) -> str:
    if path.endswith("_raw"):
        return "softplus"
    if path.endswith("q_sqrt"):
        return "tril"
    return "identity"


def summary(model_or_params, print_fn=print) -> list:
    """Parameter table of a model: one row per tensor (the JAX package's
    leaves, in its order), with its path, transform (``softplus`` for
    ``*_raw`` tensors, ``tril`` for ``q_sqrt``), shape, dtype, the
    *constrained* value (scalars and small vectors verbatim, min..max for
    larger arrays) and size. Returns the rows as dicts; pass
    ``print_fn=None`` to suppress printing.

    Works on the DGP, GPR, MultiFidelityDeepGP, MultiFidelityDeepGP_EM and
    MultiObjDeepGP wrappers (anything with ``.params``) and on a bare
    ``nn.Module``.
    """
    params = getattr(model_or_params, "params", model_or_params)
    rows = []
    for path, leaf in named_leaves(params):
        path = path.lstrip(".")
        transform = _leaf_transform(path)
        with torch.no_grad():
            value = positive(leaf) if transform == "softplus" else leaf
        value = value.detach().cpu().numpy()
        if value.size == 1:
            shown = f"{float(value.reshape(())):.5g}"
        elif value.size <= 4:
            shown = "[" + ", ".join(f"{v:.4g}" for v in value.ravel()) + "]"
        else:
            shown = f"[{value.min():.4g} .. {value.max():.4g}]"
        rows.append({
            "name": path.removesuffix("_raw"),
            "transform": transform,
            "shape": tuple(value.shape),
            "dtype": str(value.dtype),
            "value": shown,
            "size": int(value.size),
        })
    if print_fn is not None:
        cols = ("name", "transform", "shape", "dtype", "value")
        cells = [[str(r[c]) for c in cols] for r in rows]
        widths = [max([len(c)] + [len(row[i]) for row in cells])
                  for i, c in enumerate(cols)]
        fmt = "  ".join("{:<%d}" % w for w in widths)
        print_fn(fmt.format(*(c for c in cols)))
        print_fn(fmt.format(*("-" * w for w in widths)))
        for row in cells:
            print_fn(fmt.format(*row))
        total = sum(r["size"] for r in rows)
        print_fn(f"total parameters: {total}")
    return rows


def _gradients(grads):
    """(path, gradient) of a module's parameters (their ``.grad``, where
    set) in :func:`named_leaves` order, or the items of a mapping."""
    if isinstance(grads, nn.Module):
        return [(path, t.grad) for path, t in named_leaves(grads)
                if t.grad is not None]
    return list(grads.items())


def grad_norms(grads) -> dict:
    """Per-tensor gradient norms (tensors on the gradients' device), keyed
    by path: ``grads`` is a module whose parameters hold ``.grad`` (keys as
    the JAX package's ``keystr``, e.g. ``.layers[0].kernel.variance_raw``)
    or a mapping of names to gradients."""
    return {path: torch.linalg.vector_norm(g.detach().reshape(-1))
            for path, g in _gradients(grads)}


def training_metrics(loss, grads=None) -> dict:
    """{"elbo": -loss} and, given gradients (as :func:`grad_norms` takes
    them), "grad_norm", the norm of all of them together."""
    m = {"elbo": -loss}
    if grads is not None:
        flat = torch.cat([g.detach().reshape(-1) for _, g in _gradients(grads)])
        m["grad_norm"] = torch.linalg.vector_norm(flat)
    return m
