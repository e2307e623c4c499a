"""Serving a trained DGP: checkpoint, reload, sharded + chunked batch
predict (the port's counterpart of ``examples/serving.py``).

The production inference recipe:

1. train a small DGP and save its parameters,
2. reload them into a fresh model,
3. run data-parallel batch inference over a mesh (``predict_y_sharded``;
   rows shard over the data axis, one all-gather a request),
4. bound device memory on a large prediction set with ``chunk_size``.

The JAX example builds an 8-device mesh of virtual CPU devices. Here the
mesh is ``parallel.mesh.make_mesh()`` over the process group this script
starts itself: one rank under NCCL on the card, one rank under gloo with
``--cpu``; under ``torchrun`` the same code shards the rows over every
rank. Run: ``python examples_torch/serving.py [--cpu]``.
"""

import contextlib
import os
import socket
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dgp_tpu_torch.config import resolve_device  # noqa: E402
from dgp_tpu_torch.models.dgp import DGP, moment_matched  # noqa: E402
from dgp_tpu_torch.ops import kernels as K  # noqa: E402
from dgp_tpu_torch.parallel import make_mesh  # noqa: E402
from dgp_tpu_torch.utils.checkpoint import load, save  # noqa: E402


def free_port():
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device=None):
    """A process group of this one process (NCCL on the card, gloo on the
    CPU) unless one is up already (``torchrun``, or the caller's), and the
    1-D data mesh over it; a group started here is destroyed on exit. With
    no card and no ``device``, raise (``config.resolve_device``)."""
    on_cpu = resolve_device(device).type == "cpu"
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo" if on_cpu else "nccl",
                                init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1)
    try:
        yield make_mesh(device_type="cpu" if on_cpu else None)
    finally:
        if started:
            dist.destroy_process_group()


def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (200, 2))
    Y = np.sin(4 * X[:, :1]) + 0.5 * X[:, 1:] + 0.02 * rng.normal(size=(200, 1))
    Xq = rng.uniform(0, 1, (1003, 2))  # non-divisible rows: auto-padded
    return X, Y, Xq


def model(device=None, dtype=None):
    X, Y, _ = data()
    kernels = [K.RBF.create(lengthscales=[1.0, 1.0]),
               K.RBF.create(lengthscales=[1.0])]
    return DGP(X, Y, X[:16].copy(), kernels, [1], num_samples=5,
               device=device, dtype=dtype)


def train_and_reload(iterations=150, device=None, dtype=None):
    """Train, checkpoint and reload into a fresh model: (trained, served)."""
    trained = model(device, dtype)
    # the JAX example calls model.optimize(iterations=150, lr=0.02,
    # messages=0), which its DGP does not have (it stops there with an
    # AttributeError); optimize_adam takes the same arguments
    trained.optimize_adam(iterations=iterations, lr=0.02, messages=0)
    path = os.path.join(tempfile.mkdtemp(), "dgp.npz")
    save(path, trained.params)
    served = model(device, dtype)
    load(path, served.params)
    return trained, served


def requests(served, mesh, samples=50, chunk_size=256):
    """The sharded request of the 1,003 query rows, whole and in chunks of
    ``chunk_size``: ((mean, var), (mean, var)), each [S, 1003, 1]."""
    _, _, Xq = data()
    whole = served.predict_y_sharded(Xq, num_samples=samples, mesh=mesh)
    chunked = served.predict_y_sharded(Xq, num_samples=samples, mesh=mesh,
                                       chunk_size=chunk_size)
    return whole, chunked


def main(iterations=150, samples=50, chunk_size=256, device=None, dtype=None):
    _, served = train_and_reload(iterations, device, dtype)
    _, _, Xq = data()
    with process_group(device) as mesh:
        (y_m, y_v), (y_m2, y_v2) = requests(served, mesh, samples, chunk_size)
    mean, var = moment_matched(y_m, y_v)
    truth = np.sin(4 * Xq[:, 0]) + 0.5 * Xq[:, 1]
    rmse = float(np.sqrt(np.mean((mean[:, 0].cpu().numpy() - truth) ** 2)))
    print(f"sharded predict: {mean.shape[0]} rows, rmse vs truth {rmse:.3f}")
    assert y_m2.shape == y_m.shape
    print(f"chunked predict: {y_m2.shape[1]} rows in ceil(1003/{chunk_size}) "
          f"chunks, var range [{float(y_v2.min()):.4f}, "
          f"{float(y_v2.max()):.4f}]")
    return rmse


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
