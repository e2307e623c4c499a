"""Design of experiments: Latin hypercube sampling (counterpart of
``dgp_tpu/bo/doe.py``; numpy only, so this is the same code, kept here so
that the port imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np


def lhs(dim: int, n: int, seed=None) -> np.ndarray:
    """Latin hypercube in [0, 1]^dim: one point per stratum per dimension."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, dim))
    for j in range(dim):
        perm = rng.permutation(n)
        out[:, j] = (perm + rng.uniform(size=n)) / n
    return out


def doe(problem, doe_size: int, seed=None):
    """Sample a problem over an LHS design.

    :return: (X, Y, C) for constrained problems, else (X, Y).
    """
    X = lhs(problem.dim, doe_size, seed=seed)
    if getattr(problem, "constraint", False):
        Y, C = problem.fun(X)
        return X, Y, C
    Y = problem.fun(X)[0]
    return X, Y


def mf_doe(fns, dim: int, sizes, normalize=True):
    """A multi-fidelity DoE as MF_BO draws it (``dgp_tpu/bo/mf_bo.py``):
    fidelity f's ``sizes[f]`` points by :func:`lhs` at seed f, its values
    ``fns[f](X) -> [n, 1]``, with ``normalize`` all fidelities' Y under one
    pooled normalization.

    :return: (X list, Y list, (mu, sd)); (0, 1) without ``normalize``.
    """
    X = [lhs(dim, n, seed=f) for f, n in enumerate(sizes)]
    Y = [np.asarray(fn(x), dtype=float).reshape(-1, 1)
         for fn, x in zip(fns, X)]
    mu, sd = 0.0, 1.0
    if normalize:
        pooled = np.vstack(Y)
        mu, sd = float(pooled.mean()), float(pooled.std() or 1.0)
    return X, [(y - mu) / sd for y in Y], (mu, sd)
