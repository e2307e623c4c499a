"""Batched inference (serving), counterpart of ``dgp_tpu/parallel/serving.py``.

The training side shards the ELBO (``data_parallel.py``); this module shards
*prediction*: every rank holds the same ``X``, runs the same conditional
math on its own block of rows with its own stream, and the blocks are
all-gathered, so every rank returns the full ``[S, N, D]`` that the JAX
package's global array holds. That all-gather is the one place where the
port differs from the JAX package's "no collectives": shard_map leaves the
rows sharded in one global array, while a process here holds only what it
computed. One all-gather per request (the outputs packed into one buffer);
the compute and the ``[S, N / W, D]`` intermediates split W ways.

Streams: each rank draws from its own generator (the model's, where the
model was built on the mesh: ``data_parallel.rank_generator``), so the
Monte-Carlo draws differ from (but are distributed alike to) a
single-device call. For a 1-layer stack the predictive moments do not
depend on the draws, and the sharded result equals the single-device one.
Eager PyTorch compiles nothing, so nothing is cached per mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import resolve_device
from .data_parallel import _require_1d, rank_generator
from .mesh import axis_index, axis_size, device_of


def _gather_rows(outs, group, n_dev, row_axis):
    """All-gather this rank's outputs (tensors of one dtype, their rows on
    ``row_axis``) in one packed buffer; returns the full outputs, rank
    blocks in order."""
    flat = torch.cat([o.reshape(-1) for o in outs])
    parts = [torch.empty_like(flat) for _ in range(n_dev)]
    dist.all_gather(parts, flat, group=group)
    sizes = [o.numel() for o in outs]
    blocks = [p.split(sizes) for p in parts]
    return tuple(torch.cat([b[i].view_as(o) for b in blocks], dim=row_axis)
                 for i, o in enumerate(outs))


def sharded_rowwise(mesh, fn, axis_name: str = "data", row_axis: int = 1):
    """Row-shard any ``fn(params, X, generator) -> tuple of tensors`` whose
    outputs all carry X's row count on dimension ``row_axis``
    (``predict_f``/``predict_y`` return ``[S, N, D]`` → ``row_axis=1``).

    The engine takes the full ``X`` on every rank (its row count a multiple
    of the axis size: :func:`pad_rows`), runs ``fn`` on this rank's block
    with the rank's ``generator``, and all-gathers the blocks. Generic on
    purpose: every family's predict function shards through it.

    Diagonal-variance predictions only: ``full_cov=True`` outputs carry
    *cross-row* covariances ``[..., N, N]``, which are not row-parallel —
    sharding such a fn here would return the block diagonal. Compute
    full-covariance blocks per chunk on one device instead.
    """
    _require_1d(mesh, axis_name, "sharded_rowwise")
    group = mesh.get_group(axis_name)
    n_dev, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)

    def engine(params, X, generator):
        if X.shape[0] % n_dev:
            raise ValueError(f"{X.shape[0]} rows do not split over {n_dev} "
                             f"ranks: pad them first (pad_rows)")
        b = X.shape[0] // n_dev
        with torch.no_grad():
            out = fn(params, X[idx * b:(idx + 1) * b], generator)
            return _gather_rows(tuple(out), group, n_dev, row_axis)

    return engine


def pad_rows(mesh, X, axis_name: str = "data"):
    """Zero-pad X's rows to a multiple of the axis size; returns ``(Xp,
    n_true)``. The zero rows are computed (harmlessly: prediction has no
    data term to bias) and sliced away by the caller."""
    n = X.shape[0]
    rem = (-n) % axis_size(mesh, axis_name)
    if not rem:
        return X, n
    return torch.cat([X, X.new_zeros((rem,) + tuple(X.shape[1:]))]), n


def sharded_predict_f(mesh, num_samples: int, axis_name: str = "data"):
    """Data-parallel DGP ``predict_f``: ``engine(params, X, generator) ->
    (Fmean, Fvar)`` each ``[S, N, D]``."""
    from ..models import dgp as _dgp

    return sharded_rowwise(
        mesh, lambda p, X, g: _dgp.predict_f(p, X, num_samples, g), axis_name)


def sharded_predict_y(mesh, num_samples: int, axis_name: str = "data"):
    """Data-parallel DGP ``predict_y`` (predictive mean/var through the
    likelihood); same layout as :func:`sharded_predict_f`."""
    from ..models import dgp as _dgp

    return sharded_rowwise(
        mesh, lambda p, X, g: _dgp.predict_y(p, X, num_samples, g), axis_name)


def sharded_predict_y_mf(mesh, num_samples: int, axis_name: str = "data"):
    """Data-parallel MF-DGP ``predict_y`` (the highest fidelity)."""
    from ..models import mf_dgp as _mf

    return sharded_rowwise(
        mesh, lambda p, X, g: _mf.predict_y(p, X, num_samples, g), axis_name)


def sharded_predict_y_em(mesh, num_samples: int, axis_name: str = "data"):
    """Data-parallel MF-DGP-EM ``predict_y``."""
    from ..models import mf_dgp_em as _em

    return sharded_rowwise(
        mesh, lambda p, X, g: _em.predict_y(p, X, num_samples, g), axis_name)


def sharded_predict_y_mo(mesh, num_samples: int, loop: int = 2,
                         axis_name: str = "data"):
    """Data-parallel MO-DGP predictive of the last objective."""
    from ..models import mo_dgp as _mo

    return sharded_rowwise(
        mesh, lambda p, X, g: _mo.predict_y(p, X, num_samples, g, loop=loop),
        axis_name)


def sharded_gpr_predict_y(mesh, axis_name: str = "data"):
    """Data-parallel exact-GPR ``predict_y``: ``engine((params, data), X,
    generator) -> (mean, var)`` each ``[m, D]`` (rows on axis 0).

    The training set is replicated (the exact predictive needs the whole
    Gram factor, #7 on each rank); each rank back-substitutes for its own
    rows, so the result equals the single-device one but for reduction-order
    rounding. The generator is accepted for uniformity and unused."""
    from ..models import gpr as _gpr

    def fn(params_and_data, X, generator):
        params, data = params_and_data
        return _gpr.predict_y(params, data, X)

    return sharded_rowwise(mesh, fn, axis_name, row_axis=0)


def run_sharded(engine, params, X, generator, mesh, chunk_size=None,
                row_axis: int = 1, axis_name: str = "data"):
    """Drive a :func:`sharded_rowwise` engine over any row count: pad the
    rows to a multiple of the axis size, slice the outputs back, and (with
    ``chunk_size``, which must be such a multiple) loop over chunks through
    :func:`predict_in_chunks`. Shared by every family's
    ``predict_y_sharded``."""
    if chunk_size is not None:
        if chunk_size % axis_size(mesh, axis_name):
            raise ValueError("chunk_size must be a device multiple")
        return predict_in_chunks(
            lambda p, Xc, g: run_sharded(engine, p, Xc, g, mesh, None,
                                         row_axis, axis_name),
            params, X, generator, chunk_size, device=device_of(mesh),
            row_axis=row_axis)
    Xp, n = pad_rows(mesh, torch.as_tensor(X, device=device_of(mesh)),
                     axis_name)
    return tuple(o.narrow(row_axis, 0, n)
                 for o in engine(params, Xp, generator))


def predict_y_sharded(model, engine_of, Xnew, mesh=None, chunk_size=None):
    """The wrappers' ``predict_y_sharded``: ``engine_of(mesh)``'s engine
    through :func:`run_sharded` on ``mesh`` (default: the model's), with
    the rank's stream — the model's own generator where the model was
    built on that mesh (it is the rank's already), else one derived once
    from the model's seed and the rank's coordinates and kept on the
    model. Raises ValueError without a mesh, as the JAX package does."""
    mesh = mesh if mesh is not None else model.mesh
    if mesh is None:
        raise ValueError("predict_y_sharded needs a mesh (pass mesh= or "
                         "construct the model with one)")
    if mesh is model.mesh:
        generator = model.generator
    else:
        streams = model.__dict__.setdefault("_serving_generators", {})
        if id(mesh) not in streams:
            streams[id(mesh)] = (mesh, rank_generator(mesh, model.seed,
                                                      model.device))
        generator = streams[id(mesh)][1]
    return run_sharded(engine_of(mesh), model.params, model._as_input(Xnew),
                       generator, mesh, chunk_size)


def predict_in_chunks(predict, params, X, generator, chunk_size: int,
                      device=None, row_axis: int = 1):
    """Loop over fixed-size row chunks for prediction sets too large to hold
    the ``[S, N, D]`` intermediates on the device at once.

    Each chunk of X (which may stay on the host, e.g. a numpy array) is
    moved to ``device`` (the card unless given) and passed to
    ``predict(params, Xc, generator)``, which returns a tuple of tensors
    with the chunk's rows on ``row_axis``; the outputs are concatenated back
    to X's row count. Unlike the JAX loop, the tail chunk is not padded:
    eager PyTorch has no compiled program whose shape would need to stay
    fixed. The chunks draw their normals one after another from
    ``generator``, where the JAX loop folds the chunk index into its key:
    the draws differ but are distributed alike, and a 1-layer model's
    predictive moments do not depend on them.
    """
    device = resolve_device(device)
    n = X.shape[0]
    outs = []
    for start in range(0, n, chunk_size):
        Xc = torch.as_tensor(X[start:start + chunk_size], device=device)
        outs.append(predict(params, Xc, generator))
    return tuple(torch.cat(parts, dim=row_axis) for parts in zip(*outs))
