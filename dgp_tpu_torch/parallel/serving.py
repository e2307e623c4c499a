"""Batched inference (serving), counterpart of ``dgp_tpu/parallel/serving.py``.

This slice ports the single-device chunked loop. Row sharding across cards
(``sharded_rowwise``, ``predict_y_sharded``) comes with the
``torch.distributed`` slice.
"""

from __future__ import annotations

import torch

from ..config import resolve_device


def predict_in_chunks(predict, params, X, generator, chunk_size: int,
                      device=None):
    """Loop over fixed-size row chunks for prediction sets too large to hold
    the ``[S, N, D]`` intermediates on the device at once.

    Each chunk of X (which may stay on the host, e.g. a numpy array) is
    moved to ``device`` (the card unless given) and passed to
    ``predict(params, Xc, generator)``, which returns a tuple of ``[S, N, D]``
    tensors; the outputs are concatenated back to X's row count.
    Unlike the JAX loop, the tail chunk is not padded: eager PyTorch has no
    compiled program whose shape would need to stay fixed. The chunks draw
    their normals one after another from ``generator``, where the JAX loop
    folds the chunk index into its key: the draws differ but are distributed
    alike, and a 1-layer model's predictive moments do not depend on them.
    """
    device = resolve_device(device)
    n = X.shape[0]
    outs = []
    for start in range(0, n, chunk_size):
        Xc = torch.as_tensor(X[start:start + chunk_size], device=device)
        outs.append(predict(params, Xc, generator))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
