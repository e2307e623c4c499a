"""The README's production recipes on the port:

(a) minibatched large-N training on a mesh: ``benchmarks/large_scale.py``'s
    N = 1,000,000 rows in 8-D (its data function and seeds), a whitened
    2-layer RBF DGP of hidden width 8 at S = 10, each step drawing 10,000
    rows (``minibatch_size``) on ``parallel.mesh.make_mesh()``. At M = 128
    a step runs kernels #1/#2 over B·S = 100,000 rows; at the benchmark's
    own M = 256 every kernel's plan refuses the shapes and the step takes
    the eager PyTorch route (the JAX package gates its kernels at M ≤ 128
    too);
(b) in-phase checkpointing: ``optimize_nat_adam(..., checkpoint_path=,
    checkpoint_every=)``, the file loaded into a fresh model, which trains
    on;
(c) exact SO_BO resume: ``save`` after two infills, ``SO_BO.load``, one
    more infill, equal to the uninterrupted three-infill run.

Run: ``python examples_torch/recipes.py [--cpu]`` (the CPU run cuts N to
4,096 and B to 256). The mesh is this process alone (one card, or gloo
with ``--cpu``; see ``serving.py``); under ``torchrun`` the same code shards
the rows over every rank.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import dgp_tpu_torch as dgp  # noqa: E402
from dgp_tpu_torch.config import resolve_device  # noqa: E402
from dgp_tpu_torch.ops import kernels as K  # noqa: E402
from dgp_tpu_torch.utils import checkpoint  # noqa: E402
from examples_torch.ask_tell import SPEC, Branin  # noqa: E402
from examples_torch.serving import process_group  # noqa: E402

DIN, HIDDEN, S = 8, 8, 10


def large_data(n, seed):
    """``benchmarks/large_scale.py``'s rows: X uniform on [0, 1]^8, Y a
    smooth function of four coordinates plus noise of 0.05."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(n, DIN)).astype(np.float32)
    f = (np.sin(3 * X[:, :1]) * np.cos(2 * X[:, 1:2])
         + 0.5 * (X[:, 2:3] - 0.5) ** 2 + 0.3 * np.tanh(4 * X[:, 3:4]))
    Y = f + 0.05 * rng.normal(size=(n, 1)).astype(np.float32)
    return X, Y


def large_model(N=1_000_000, M=128, B=10_000, mesh=None, device=None,
                dtype=None):
    """The whitened RBF [8] model on N rows, Z drawn from X (seed 2), with
    ``minibatch_size`` B on ``mesh``."""
    X, Y = large_data(N, 0)
    Z = X[np.random.default_rng(2).choice(N, M, replace=False)].copy()
    kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * DIN),
               K.RBF.create(variance=1.0, lengthscales=[1.0] * HIDDEN)]
    return dgp.DGP(X, Y, Z, kernels, [HIDDEN], num_samples=S, white=True,
                   mesh=mesh, minibatch_size=B, device=device, dtype=dtype)


def minibatched_training(mesh, N=1_000_000, M=128, B=10_000,
                         iterations=(1000, 5000), device=None, dtype=None):
    """(a): build on ``mesh`` and train by ``optimize_nat_adam``. Returns
    (model, losses, seconds of the training)."""
    model = large_model(N, M, B, mesh, device, dtype)
    t0 = time.perf_counter()
    losses = model.optimize_nat_adam(iterations1=iterations[0],
                                     iterations2=iterations[1], messages=0)
    seconds = time.perf_counter() - t0
    print(f"(a) N={N:,} M={M} B={B:,}: {sum(iterations)} steps in "
          f"{seconds:.1f} s, loss {float(losses[0]):.1f} -> "
          f"{float(losses[-1]):.1f}")
    return model, losses, seconds


def checkpointed_training(model, fresh, iterations=100, every=50,
                          more=50, path=None):
    """(b): train ``model`` for ``iterations`` natural-gradient steps with a
    checkpoint every ``every`` steps (not after the last), load the last
    checkpoint into ``fresh`` (built as ``model`` was) and train it on for
    ``more`` steps. Returns (the checkpoint's path, the fresh model's
    losses)."""
    path = path or os.path.join(tempfile.mkdtemp(), "run.npz")
    model.optimize_nat_adam(iterations1=0, iterations2=iterations,
                            checkpoint_path=path, checkpoint_every=every,
                            messages=0)
    checkpoint.load(path, fresh.params)
    losses = fresh.optimize_nat_adam(iterations1=0, iterations2=more,
                                     messages=0, shrink_inner=False)
    print(f"(b) checkpoint every {every} of {iterations} steps reloaded; "
          f"{more} more steps, loss {float(losses[0]):.1f} -> "
          f"{float(losses[-1]):.1f}")
    return path, losses


def bo_resume(infills=(2, 1), train_iterations=500, popsize_DE=60,
              iterations_DE=80, device=None, dtype=None):
    """(c): Branin SO_BO on an exact GPR, ``infills[0]`` infills, save,
    load and ``infills[1]`` more, beside the uninterrupted run. Returns
    (the resumed loop, the uninterrupted one)."""
    kw = dict(IC="EI", train_iterations=train_iterations,
              popsize_DE=popsize_DE, iterations_DE=iterations_DE,
              IC_method="DE", verbose=False)
    make = lambda: dgp.SO_BO(problem=Branin(), DoE_size=8,  # noqa: E731
                             model_Y_dic=SPEC, seed=0, device=device,
                             dtype=dtype)
    whole = make()
    whole.run(sum(infills), **kw)
    bo = make()
    bo.run(infills[0], **kw)
    path = os.path.join(tempfile.mkdtemp(), "bo_state.npz")
    bo.save(path)
    bo2 = dgp.SO_BO.load(path, Branin(), SPEC, device=device,
                         dtype=dtype)
    bo2.run(infills[1], **kw)
    assert np.array_equal(bo2.X, whole.X)
    assert np.array_equal(np.asarray(bo2.Ymin, float),
                          np.asarray(whole.Ymin, float))
    print(f"(c) SO_BO resumed after {infills[0]} infills equals the "
          f"uninterrupted run: Ymin {float(bo2.Ymin[-1]):.5f}")
    return bo2, whole


def main(device=None, dtype=None):
    cpu = resolve_device(device).type == "cpu"
    N, B = (4_096, 256) if cpu else (1_000_000, 10_000)
    with process_group(device) as mesh:
        model, _, _ = minibatched_training(mesh, N=N, B=B, device=device,
                                           dtype=dtype)
        minibatched_training(mesh, N=N, M=256, B=B, iterations=(20, 10),
                             device=device, dtype=dtype)
        fresh = large_model(N, 128, B, mesh, device, dtype)
        checkpointed_training(model, fresh)
    bo_resume(device=device, dtype=dtype)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
