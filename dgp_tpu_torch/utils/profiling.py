"""Profiling helpers (counterpart of ``dgp_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block of code, and a steps/sec timer for a
step function."""

from __future__ import annotations

import contextlib
import time

import torch
from torch import nn


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed computation (host operations, and
    the card's kernels where there is one) into ``log_dir`` as a
    ``*.pt.trace.json`` file, which TensorBoard's profiler plugin and
    Perfetto read."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _cuda_devices(carry, seen=None):
    """The CUDA devices of the tensors in ``carry`` (a tensor, a module, or
    tuples, lists and dicts of them)."""
    seen = set() if seen is None else seen
    if isinstance(carry, torch.Tensor):
        if carry.is_cuda:
            seen.add(carry.device)
    elif isinstance(carry, nn.Module):
        for t in carry.state_dict().values():
            _cuda_devices(t, seen)
    elif isinstance(carry, dict):
        for v in carry.values():
            _cuda_devices(v, seen)
    elif isinstance(carry, (tuple, list)):
        for v in carry:
            _cuda_devices(v, seen)
    return seen


def _wait(carry):
    for device in _cuda_devices(carry):
        torch.cuda.synchronize(device)


def steps_per_sec(step_fn, carry, steps: int = 20, warmup: int = 3):
    """Time a ``carry = step_fn(carry)`` loop; returns (steps/sec, final
    carry). Where the carry holds tensors on the card, the card is
    synchronized before and after the timed steps."""
    for _ in range(warmup):
        carry = step_fn(carry)
    _wait(carry)
    t0 = time.perf_counter()
    for _ in range(steps):
        carry = step_fn(carry)
    _wait(carry)
    return steps / (time.perf_counter() - t0), carry
