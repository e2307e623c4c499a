"""Data-parallel ELBOs over a device mesh (counterpart of
``dgp_tpu/parallel/data_parallel.py``).

The ELBO's data terms are sums over independent rows, so they shard over
the N axis: parameters replicate, each rank evaluates its own rows, and the
partial sums reduce over the mesh. The JAX package writes each family's
ELBO again under ``shard_map`` with ``psum``; here every sharded loss is the
family's own ``elbo`` with one hook changed, its ``data_term``: the
weighted row sum and the row count of each data term go through one
all-reduce (:class:`_RowSum`) over the row axes, innermost first (and over
the sample axis before them), so the function, the order of the draws and
the KL are those of the single-device loss.

Gradients. After each gradient the loops of ``models/training.py`` and
``variational/natgrad.py`` call the loss's ``reduce_grads``
(:func:`mean_grads`: one flat all-reduce of every gradient, then / W, with
W the mesh's rank count), so every rank holds the same bits: the gradient
of the global loss. For that mean to count each row once and the KL once,
:class:`_RowSum`'s backward hands its input W times the upstream gradient
(the same on every rank: all that follows the sum is replicated), the
trap of ``torch.distributed.nn.functional.all_reduce`` turned to use, and
the KL's gradient enters the mean once per rank. Where the KL depends on
the rank's draws (MF, EM and MO recompute their augmented inducing inputs
from the rank's generator, as the JAX package folds the device index into
``kz``), the loss value is also averaged over the ranks
(:class:`_RankMean`: forward the mean, backward the identity), so every
host decision (the natural-gradient guard, the non-finite warning, the
restarts' scores) reads one value on every rank.

Streams. Each rank draws from its own ``torch.Generator``, seeded from the
model's seed and the rank's mesh coordinates (:func:`rank_seed`: the data
index first, then the sample or slice index), created once; the draws
differ from the JAX package's but are distributed alike. A minibatch draw
on a data x sample mesh is broadcast over the sample axis, so the sample
ranks of one data block evaluate the same rows, as the JAX package folds
only the row index into its draw key.

Each sharded loss takes the loops' ``(params, generator, batch)`` and, for
tests, the family's fixed unit normals (``zs`` / ``noise``: this rank's
slice of them) and, for the minibatch losses, fixed local indices.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import dgp as _dgp
from ..models import mf_dgp as _mf
from ..models import mf_dgp_em as _em
from ..models import mo_dgp as _mo
from ..models.training import pad_to_bucket
from .mesh import axis_index, axis_size, device_of, shard_batch


# -- topologies -----------------------------------------------------------------


def mesh_row_axes(mesh: DeviceMesh, axis_name: str = "data"):
    """Classify a mesh for the sharded losses.

    Returns ``(row_axes, sample_axis)``: data rows shard over the *product*
    of ``row_axes`` (mesh order, outermost first); the Monte-Carlo sample
    axis shards over ``sample_axis`` when present. Supported topologies:

    * ``(axis_name,)`` — 1-D data-parallel (make_mesh);
    * ``(axis_name, 'sample')`` / ``('sample', axis_name)`` — 2-D data x
      sample parallelism (make_mesh_2d);
    * ``('slice', axis_name)`` — hierarchical (make_mesh_multislice): rows
      shard over slices x ranks of a slice, reductions run inner axis
      first, so the outer link carries one reduced value per slice.
    """
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if names == (axis_name,):
        return (axis_name,), None
    if set(names) == {axis_name, "sample"}:
        return (axis_name,), "sample"
    if names == ("slice", axis_name):
        return names, None
    raise ValueError(
        f"unsupported mesh axes {names}: expected ({axis_name!r},), a "
        f"{{{axis_name!r}, 'sample'}} pair, or ('slice', {axis_name!r})"
    )


def _require_1d(mesh: DeviceMesh, axis_name: str, what: str):
    row_axes, sample_axis = mesh_row_axes(mesh, axis_name)
    if sample_axis is not None or len(row_axes) != 1:
        raise ValueError(
            f"{what} supports 1-D ({axis_name!r},) data meshes only; got "
            f"axes {tuple(mesh.mesh_dim_names)}"
        )


def _row_devices(mesh: DeviceMesh, row_axes) -> int:
    return math.prod(axis_size(mesh, a) for a in row_axes)


def _split_samples(mesh, num_samples, sample_axis):
    if sample_axis is None:
        return 1, num_samples
    s_dev = axis_size(mesh, sample_axis)
    if num_samples % s_dev:
        raise ValueError(
            f"num_samples={num_samples} must divide over the {s_dev}-way "
            f"sample axis"
        )
    return s_dev, num_samples // s_dev


def is_first_rank(mesh: DeviceMesh) -> bool:
    """Whether this rank sits at the mesh's origin (the one that writes
    checkpoints)."""
    return all(axis_index(mesh, a) == 0 for a in mesh.mesh_dim_names)


def from_first_rank(mesh: DeviceMesh, value, dtype=torch.float64):
    """``value`` (a Python number) as the mesh's first rank has it, on every
    rank: a host decision that reads it cannot diverge across ranks."""
    t = torch.tensor([value], dtype=dtype, device=device_of(mesh))
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t.item()


# -- per-rank streams -------------------------------------------------------------


def rank_seed(mesh: DeviceMesh, seed: int, axis_name: str = "data") -> int:
    """The seed of this rank's stream: ``seed`` folded with the rank's data
    index, then with its index on each other axis (sample or slice)."""
    from ..bo.acquisition import fold_in

    key = fold_in(seed, axis_index(mesh, axis_name))
    for a in mesh.mesh_dim_names:
        if a != axis_name:
            key = fold_in(key, axis_index(mesh, a))
    return key


def rank_generator(mesh: DeviceMesh, seed: int, device,
                   axis_name: str = "data") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        rank_seed(mesh, seed, axis_name))


# -- collectives -------------------------------------------------------------------


def _all_reduce(x, mesh, axes):
    """Sum ``x`` (in place) over the named axes, in order."""
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


class _RowSum(torch.autograd.Function):
    """Sum over the ranks of the given axes (in order). Backward: the
    upstream gradient times the mesh's rank count, so that
    :func:`mean_grads` over the ranks adds every rank's rows once."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.ranks = mesh.size()
        return _all_reduce(x.detach().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.ranks, None, None


class _RankMean(torch.autograd.Function):
    """Mean over every rank of the mesh; backward the identity (the
    gradient sites take the mean)."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = _all_reduce(x.detach().clone(), mesh,
                          reversed(mesh.mesh_dim_names))
        return out / mesh.size()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def mean_grads(mesh: DeviceMesh, grads):
    """The mean over every rank of the mesh of each gradient (None stays
    None), by one flat all-reduce per axis, innermost first; every rank
    gets the same bits."""
    present = [g for g in grads if g is not None]
    if not present:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in present])
    _all_reduce(flat, mesh, reversed(mesh.mesh_dim_names))
    flat /= mesh.size()
    parts = iter(flat.split([g.numel() for g in present]))
    return [None if g is None else next(parts).view_as(g) for g in grads]


def _sharded(loss, mesh):
    """Mark ``loss`` as a sharded loss: the training loops reduce its
    gradients with :func:`mean_grads`."""
    loss.reduce_grads = functools.partial(mean_grads, mesh)
    return loss


def _data_term(mesh, row_axes, sample_axis, integer_counts=False):
    """The elbos' ``data_term`` hook on a mesh: (the weighted row sum of
    E_S[var_exp], the row count), both summed over the sample axis and then
    the row axes, innermost first, in one all-reduce each. On a sample axis
    each rank's mean runs over its S / n_sample draws. With
    ``integer_counts`` the count is rounded to the integer it is (the
    minibatch estimator's weights n_local / b_local sum to n_local)."""
    n_s = axis_size(mesh, sample_axis) if sample_axis else 1
    axes = ((sample_axis,) if sample_axis else ()) + tuple(reversed(row_axes))

    def term(var_exp, w):
        local, count = _dgp.weighted_data_term(var_exp, w)
        count = torch.as_tensor(count, dtype=local.dtype, device=local.device)
        total, eff = _RowSum.apply(torch.stack([local / n_s, count]), mesh,
                                   axes)
        eff = eff / n_s
        return total, torch.round(eff) if integer_counts else eff

    return term


# -- minibatch draws ---------------------------------------------------------------


def _local_draw(generator, w, b_local):
    """Per-rank minibatch draw: (indices [b_local], n_local as a tensor).

    True rows form a contiguous prefix of the local block (tail padding), so
    uniform indices in [0, n_local) select only true rows; an all-padding
    rank draws row 0 and contributes zero through the n_local scale. The
    indices come from uniforms on the device, so nothing is read on the
    host."""
    n_local = torch.sum(w)
    u = torch.rand((b_local,), generator=generator, dtype=w.dtype,
                   device=w.device)
    idx = torch.floor(u * n_local).long()
    return torch.minimum(idx, (n_local - 1).clamp_min(0).long()), n_local


def _draw_rows(mesh, sample_axis, generator, w, b_local):
    """:func:`_local_draw`, with the indices of a data block's first sample
    rank on every sample rank of the block. Returns (indices, the
    estimator's row weights n_local / b_local)."""
    idx, n_local = _local_draw(generator, w, b_local)
    if sample_axis is not None:
        group = mesh.get_group(sample_axis)
        dist.broadcast(idx, src=dist.get_global_rank(group, 0), group=group)
    return idx, (n_local / b_local).expand(b_local)


def _local_batch_sizes(mesh, batch_sizes, axis_name="data"):
    n_dev = axis_size(mesh, axis_name)
    return tuple(max(1, int(b) // n_dev) for b in batch_sizes)


# -- the DGP -------------------------------------------------------------------------


def sharded_dgp_loss(mesh: DeviceMesh, num_samples: int,
                     axis_name: str = "data"):
    """-ELBO of the plain DGP on a mesh; batch = (X, Y, w, num_data), the
    rank's rows (pad_shard_batch) and the full N, so weight-decoupled
    padding keeps the value the single-device one.

    Accepts every mesh_row_axes topology: on a 2-D data x sample mesh each
    rank draws num_samples / sample_ranks paths; on a multislice mesh the
    reduction runs inner axis first."""
    row_axes, sample_axis = mesh_row_axes(mesh, axis_name)
    _, s_local = _split_samples(mesh, num_samples, sample_axis)
    term = _data_term(mesh, row_axes, sample_axis)

    def loss(params, generator, batch, zs=None):
        X, Y, w, num_data = batch
        return -_dgp.elbo(params, X, Y, s_local, generator, zs=zs,
                          num_data=num_data, row_weights=w, data_term=term)

    return _sharded(loss, mesh)


def sharded_dgp_minibatch_loss(mesh: DeviceMesh, num_samples: int,
                               batch_size: int, axis_name: str = "data"):
    """Data-parallel *minibatch* -ELBO: each data block draws
    ``batch_size // n_row_ranks`` indices uniformly (with replacement) from
    its own true rows and weighs them n_local / B_local — an unbiased
    estimator of the full data term for any padding split, with no gather
    across ranks. Requires each local block's true rows to be a contiguous
    prefix, which pad_shard_batch's tail padding guarantees. batch = (X, Y,
    w, num_data) as for sharded_dgp_loss."""
    row_axes, sample_axis = mesh_row_axes(mesh, axis_name)
    _, s_local = _split_samples(mesh, num_samples, sample_axis)
    b_local = max(1, batch_size // _row_devices(mesh, row_axes))
    term = _data_term(mesh, row_axes, sample_axis, integer_counts=True)

    def loss(params, generator, batch, zs=None, idx=None):
        X, Y, w, num_data = batch
        if idx is None:
            idx, wb = _draw_rows(mesh, sample_axis, generator, w, b_local)
        else:
            wb = (torch.sum(w) / b_local).expand(b_local)
        return -_dgp.elbo(params, X[idx], Y[idx], s_local, generator, zs=zs,
                          num_data=num_data, row_weights=wb, data_term=term)

    return _sharded(loss, mesh)


def make_data_parallel_elbo(mesh: DeviceMesh, num_samples: int,
                            num_data=None, axis_name: str = "data"):
    """elbo(params, X, Y, generator) with X/Y this rank's rows: the data
    term summed over the mesh and scaled to ``num_data`` (default: the rows
    of all ranks), minus the KL. Any mesh_row_axes topology."""
    loss = sharded_dgp_loss(mesh, num_samples, axis_name)

    def elbo(params, X, Y, generator, zs=None):
        return -loss(params, generator, (X, Y, None, num_data), zs=zs)

    return elbo


def make_data_sample_parallel_elbo(mesh: DeviceMesh, num_samples: int,
                                   num_data=None, data_axis: str = "data",
                                   sample_axis: str = "sample"):
    """The 2-D data x sample ELBO: rows shard over ``data_axis`` and the S
    Monte-Carlo paths over ``sample_axis`` (each rank draws S / n_sample
    paths for its rows)."""
    n_sample = axis_size(mesh, sample_axis)
    if num_samples % n_sample:
        raise ValueError(
            f"num_samples={num_samples} must divide over the "
            f"{n_sample}-way sample axis"
        )
    return make_data_parallel_elbo(mesh, num_samples, num_data, data_axis)


def make_multislice_elbo(mesh: DeviceMesh, num_samples: int, num_data=None,
                         slice_axis: str = "slice", data_axis: str = "data"):
    """The ELBO on a hierarchical (slice, data) mesh: rows shard over the
    product of both axes; the reduction runs within a slice first, then
    one value per slice across slices."""
    if tuple(mesh.mesh_dim_names) != (slice_axis, data_axis):
        raise ValueError(f"expected mesh axes ({slice_axis!r}, "
                         f"{data_axis!r}), got {tuple(mesh.mesh_dim_names)}")
    return make_data_parallel_elbo(mesh, num_samples, num_data, data_axis)


def make_data_parallel_loss(mesh: DeviceMesh, num_samples: int,
                            num_data=None, axis_name: str = "data"):
    """Negative data-parallel ELBO with the ``(params, generator)``
    signature of the training loops; ``make(X, Y)`` closes over this
    rank's rows. (The model wrappers take sharded_dgp_loss, whose batch is
    an argument.)"""
    pelbo = make_data_parallel_elbo(mesh, num_samples, num_data, axis_name)

    def make(X, Y):
        def loss(params, generator):
            return -pelbo(params, X, Y, generator)

        return _sharded(loss, mesh)

    return make


# -- the multi-fidelity and multi-objective families ---------------------------------


def sharded_mf_loss(mesh: DeviceMesh, num_samples: int, train_upto: int = -1,
                    axis_name: str = "data"):
    """-ELBO of MF-DGP on a 1-D mesh: every fidelity's rows shard over the
    data axis; each rank recomputes the augmented inducing inputs from its
    own stream (M x M work, replicated), and the value is the mean over
    the ranks. batch = (Xs, Ys, ws, nds) per-fidelity tuples
    (pad_shard_fidelity_batch)."""
    _require_1d(mesh, axis_name, "sharded_mf_loss")
    term = _data_term(mesh, (axis_name,), None)

    def loss(params, generator, batch, noise=None):
        Xs, Ys, ws, nds = batch
        return -_RankMean.apply(_mf.elbo(
            params, Xs, Ys, num_samples, generator,
            train_upto_fidelity=train_upto, row_weights=ws, num_data=nds,
            noise=noise, data_term=term), mesh)

    return _sharded(loss, mesh)


def sharded_mf_minibatch_loss(mesh: DeviceMesh, num_samples: int,
                              batch_sizes: tuple, train_upto: int = -1,
                              axis_name: str = "data"):
    """Per-fidelity minibatch -ELBO of MF-DGP on a 1-D mesh: each rank
    draws B_f / n_ranks rows of fidelity f from its own block and weighs
    them n_local / B_local (see sharded_dgp_minibatch_loss). batch as for
    sharded_mf_loss."""
    _require_1d(mesh, axis_name, "sharded_mf_minibatch_loss")
    b_locals = _local_batch_sizes(mesh, batch_sizes, axis_name)
    term = _data_term(mesh, (axis_name,), None, integer_counts=True)

    def loss(params, generator, batch, noise=None, idx=None):
        Xs, Ys, ws, nds = batch
        idxs, wbs = _minibatch(mesh, generator, ws, b_locals, idx)
        return -_RankMean.apply(_mf.elbo(
            params, [X[i] for X, i in zip(Xs, idxs)],
            [Y[i] for Y, i in zip(Ys, idxs)], num_samples, generator,
            train_upto_fidelity=train_upto, row_weights=wbs, num_data=nds,
            noise=noise, data_term=term), mesh)

    return _sharded(loss, mesh)


def _minibatch(mesh, generator, ws, b_locals, idx=None):
    """Per-fidelity local draws (or the given ``idx``) and their estimator
    weights."""
    if idx is not None:
        return idx, [(torch.sum(w) / b).expand(b)
                     for w, b in zip(ws, b_locals)]
    draws = [_draw_rows(mesh, None, generator, w, b)
             for w, b in zip(ws, b_locals)]
    return [d[0] for d in draws], [d[1] for d in draws]


def sharded_em_loss(mesh: DeviceMesh, num_samples: int, train_upto: int = -1,
                    axis_name: str = "data"):
    """-ELBO of MF-DGP-EM on a 1-D mesh. The X_red projection rows pair with
    the next fidelity's rows, so they shard with the same blocks and the
    same padding (models/mf_dgp_em._loss_spec). batch = (Xs, Ys, Xr, ws,
    nds)."""
    _require_1d(mesh, axis_name, "sharded_em_loss")
    term = _data_term(mesh, (axis_name,), None)

    def loss(params, generator, batch, noise=None):
        Xs, Ys, Xr, ws, nds = batch
        return -_RankMean.apply(_em.elbo(
            params, Xs, Ys, Xr, num_samples, generator,
            train_upto_fidelity=train_upto, row_weights=ws, num_data=nds,
            noise=noise, data_term=term), mesh)

    return _sharded(loss, mesh)


def sharded_em_minibatch_loss(mesh: DeviceMesh, num_samples: int,
                              batch_sizes: tuple, train_upto: int = -1,
                              axis_name: str = "data"):
    """Per-fidelity minibatch -ELBO of MF-DGP-EM on a 1-D mesh: X_red[f]'s
    rows pair with fidelity f + 1's, so the projection term reuses fidelity
    f + 1's draw. batch as for sharded_em_loss."""
    _require_1d(mesh, axis_name, "sharded_em_minibatch_loss")
    b_locals = _local_batch_sizes(mesh, batch_sizes, axis_name)
    term = _data_term(mesh, (axis_name,), None, integer_counts=True)

    def loss(params, generator, batch, noise=None, idx=None):
        Xs, Ys, Xr, ws, nds = batch
        idxs, wbs = _minibatch(mesh, generator, ws, b_locals, idx)
        return -_RankMean.apply(_em.elbo(
            params, [X[i] for X, i in zip(Xs, idxs)],
            [Y[i] for Y, i in zip(Ys, idxs)],
            [Xr[f][idxs[f + 1]] for f in range(len(Xr))], num_samples,
            generator, train_upto_fidelity=train_upto, row_weights=wbs,
            num_data=nds, noise=noise, data_term=term), mesh)

    return _sharded(loss, mesh)


def sharded_mo_loss(mesh: DeviceMesh, num_samples: int, loop: int,
                    train_upto: int = -1, axis_name: str = "data"):
    """-ELBO of MO-DGP on a 1-D mesh (per-objective row sums). batch = (Xs,
    Ys, ws, nds)."""
    _require_1d(mesh, axis_name, "sharded_mo_loss")
    term = _data_term(mesh, (axis_name,), None)

    def loss(params, generator, batch, noise=None):
        Xs, Ys, ws, nds = batch
        return -_RankMean.apply(_mo.elbo(
            params, Xs, Ys, num_samples, generator, loop=loop,
            train_upto_objective=train_upto, row_weights=ws, num_data=nds,
            noise=noise, data_term=term), mesh)

    return _sharded(loss, mesh)


def sharded_mo_minibatch_loss(mesh: DeviceMesh, num_samples: int, loop: int,
                              batch_sizes: tuple, train_upto: int = -1,
                              axis_name: str = "data"):
    """Per-objective minibatch -ELBO of MO-DGP on a 1-D mesh (local draws,
    n_local / B_local weights). batch as for sharded_mo_loss."""
    _require_1d(mesh, axis_name, "sharded_mo_minibatch_loss")
    b_locals = _local_batch_sizes(mesh, batch_sizes, axis_name)
    term = _data_term(mesh, (axis_name,), None, integer_counts=True)

    def loss(params, generator, batch, noise=None, idx=None):
        Xs, Ys, ws, nds = batch
        idxs, wbs = _minibatch(mesh, generator, ws, b_locals, idx)
        return -_RankMean.apply(_mo.elbo(
            params, [X[i] for X, i in zip(Xs, idxs)],
            [Y[i] for Y, i in zip(Ys, idxs)], num_samples, generator,
            loop=loop, train_upto_objective=train_upto, row_weights=wbs,
            num_data=nds, noise=noise, data_term=term), mesh)

    return _sharded(loss, mesh)


# -- batches ---------------------------------------------------------------------------


def pad_shard_batch(mesh: DeviceMesh, X, Y, n_bucket=None,
                    axis_name: str = "data"):
    """Pad (X, Y) rows to a multiple of lcm(row-rank count, bucket), build
    the 0/1 row-weight vector (training.pad_to_bucket), and return this
    rank's block of all three over the mesh's row axes (the data axis; for
    a multislice mesh the slice x data product), with the true N: (Xp, Yp,
    w, num_data), ready for the sharded losses. Tail padding keeps each
    block's true rows a contiguous prefix — the invariant the minibatch
    losses' local draws rely on."""
    row_axes, _ = mesh_row_axes(mesh, axis_name)
    bucket = math.lcm(_row_devices(mesh, row_axes), n_bucket or 1)
    Xp, Yp, w = pad_to_bucket(X, Y, bucket)
    Xp, Yp, w = shard_batch(mesh, Xp, Yp, w, axis_name=row_axes)
    return Xp, Yp, w, X.shape[0]


def pad_shard_fidelity_batch(mesh: DeviceMesh, Xs, Ys, n_bucket=None,
                             axis_name: str = "data"):
    """Per-fidelity pad_shard_batch: returns (Xs, Ys, ws, nds) tuples ready
    for sharded_mf_loss / sharded_mo_loss."""
    out = [pad_shard_batch(mesh, X, Y, n_bucket, axis_name)
           for X, Y in zip(Xs, Ys)]
    return tuple(tuple(col) for col in zip(*out))
