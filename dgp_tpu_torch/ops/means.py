"""Mean functions: Zero / Identity / fixed Linear (counterpart of
``dgp_tpu/ops/means.py``). The Linear weight is a buffer: every training
phase of the reference keeps mean functions frozen."""

from __future__ import annotations

import torch
from torch import nn


class MeanFunction(nn.Module):
    def forward(self, X):
        raise NotImplementedError


class Zero(MeanFunction):
    def __init__(self, num_outputs: int = 1):
        super().__init__()
        self.num_outputs = num_outputs

    def forward(self, X):
        return torch.zeros((X.shape[0], self.num_outputs), dtype=X.dtype,
                           device=X.device)


class Identity(MeanFunction):
    def forward(self, X):
        return X


class LinearMean(MeanFunction):
    """f(X) = X @ W (no bias; the reference never uses one)."""

    def __init__(self, W):
        super().__init__()
        self.register_buffer("W", W)  # [D_in, D_out]

    def forward(self, X):
        return X @ self.W
