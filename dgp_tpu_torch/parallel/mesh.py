"""Device meshes over ``torch.distributed`` (counterpart of
``dgp_tpu/parallel/mesh.py``).

The scaling axis is the data axis N of the ELBO: parameters replicate, data
rows shard, and the partial sums and gradients reduce with collectives. In
PyTorch's idiom there is one process per rank: the process group is
initialised first, by ``torchrun`` or by the caller
(``torch.distributed.init_process_group``), and the functions here build
``torch.distributed.device_mesh.DeviceMesh``es over it, in the place of
``jax.sharding.Mesh``. Every rank runs the same program; where the JAX
package places a global array sharded over its devices, a rank here holds
its own block of rows (:func:`shard_batch`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device_type: Optional[str]) -> str:
    """``"cuda"`` unless the caller asks for another; with no card and no
    ``device_type``, raise, as ``config.resolve_device`` does. On the card
    each rank takes ``cuda:{local_rank % device_count}``."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' to build a CPU mesh")
        device_type = "cuda"
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return device_type


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first (torchrun, or "
                           "torch.distributed.init_process_group)")
    return dist.get_world_size()


def _mesh(shape, names, device_type):
    n = int(np.prod(shape))
    world = _world()
    if n > world:
        raise ValueError(f"requested {'x'.join(map(str, shape))} ranks, only "
                         f"{world} in the process group")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device_type: Optional[str] = None) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all by default)."""
    return _mesh((n_devices or _world(),), (axis_name,),
                 device_type)


def make_mesh_2d(data: int, sample: int,
                 axis_names: Sequence[str] = ("data", "sample"),
                 device_type: Optional[str] = None) -> DeviceMesh:
    """(data x sample) mesh for combined data- and Monte-Carlo-sample
    parallelism."""
    return _mesh((data, sample), axis_names, device_type)


def make_mesh_multislice(n_slices: Optional[int] = None,
                         per_slice: Optional[int] = None,
                         axis_names: Sequence[str] = ("slice", "data"),
                         device_type: Optional[str] = None) -> DeviceMesh:
    """Hierarchical mesh: on GPUs the outer axis spans nodes (the slow link
    between them) and the inner axis the ranks of one node (NVLink). Rank
    r sits at (r // per_slice, r % per_slice), which is torchrun's node-major
    rank order. ``per_slice`` defaults to ``LOCAL_WORLD_SIZE`` where that is
    smaller than the world, and ``n_slices`` to the rest; a single node
    emulates the topology with two slices."""
    world = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_slices is None and per_slice is None and local < world:
        per_slice = local
    if n_slices is None:
        n_slices = world // per_slice if per_slice else 2
    per_slice = per_slice or world // n_slices
    return _mesh((n_slices, per_slice), axis_names, device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on the named axis."""
    return mesh.get_local_rank(name)


def block_of(mesh: DeviceMesh, axis_name="data"):
    """(this rank's row block, the number of blocks): rows split over the
    product of the named axes, outermost first, as ``P(("slice",
    "data"))`` splits them."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    block, n = 0, 1
    for a in axes:
        block = block * axis_size(mesh, a) + axis_index(mesh, a)
        n *= axis_size(mesh, a)
    return block, n


def shard_batch(mesh: DeviceMesh, *arrays, axis_name="data"):
    """This rank's block of rows of each array (tensors, or arrays moved to
    the mesh's device). ``axis_name`` may be one mesh axis or a tuple of
    axes (``("slice", "data")``): rows then split over the product of those
    axes, outermost first. Each row count must be a multiple of the number
    of blocks (:func:`pad_to_multiple`)."""
    block, n = block_of(mesh, axis_name)
    out = []
    for a in arrays:
        a = torch.as_tensor(a, device=device_of(mesh))
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not split into {n} blocks")
        b = a.shape[0] // n
        out.append(a[block * b:(block + 1) * b])
    return tuple(out) if len(out) > 1 else out[0]


def device_of(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@torch.no_grad()
def replicate(mesh: DeviceMesh, module):
    """Broadcast the parameters and buffers of the mesh's first rank to
    every rank of the mesh, in place, so every rank starts bit-equal; one
    broadcast per tensor along each axis, outermost first."""
    tensors = [*module.parameters(), *module.buffers()]
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return module


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Zero-pad ``axis`` up to a multiple; returns (padded, original_size)."""
    n = array.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, rem)
    return np.pad(np.asarray(array), pad), n
