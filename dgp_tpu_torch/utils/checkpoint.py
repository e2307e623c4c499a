"""Checkpoint / resume for model parameters (counterpart of
``dgp_tpu/utils/checkpoint.py``): a flat ``.npz`` of the module's tensors
(parameters and buffers) under their names, in ``state_dict`` order."""

from __future__ import annotations

import os

import numpy as np
import torch


def save(path: str, params) -> None:
    """Write ``params`` (an ``nn.Module``) to ``path`` atomically: a reader
    sees the previous file or the new one, never a partial write."""
    arrays = {name: t.detach().cpu().numpy()
              for name, t in params.state_dict().items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load(path: str, like):
    """Restore parameters saved by :func:`save` into the module ``like``
    (in place, on its device and in its dtypes); returns ``like``."""
    with np.load(path) as data:
        state = like.state_dict()
        if set(data.files) != set(state):
            raise ValueError(
                f"checkpoint holds {sorted(data.files)}, "
                f"expected {sorted(state)}")
        with torch.no_grad():
            for name, t in state.items():
                if data[name].shape != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint {name} has shape {data[name].shape}, "
                        f"expected {tuple(t.shape)}")
                t.copy_(torch.as_tensor(data[name]))
    return like
