"""Runs of the harness on the CPU, its look for a card skipped, with the
timed path broken underneath: each fault that a cell can have turns
``correct`` false, where the same run without it reads true.

Training runs use a one-layer model: on the CPU the port's two-layer DGP
gives its layers one shared tensor of inducing inputs (PERF.md, Open
questions), so every two-layer training run there reads false; on the card
the copy to the device keeps them apart."""

import contextlib

import pytest
import torch

from gpbench.tests.smallcells import one_thread, small  # noqa: F401
from gpbench import faults, harness

CPU = torch.device("cpu")
ONE_LAYER = dict(hidden_dims=[], mean_functions=["zero"])


def run(cell, fault=None, seed=21):
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        return harness.run(cell, seed, 0.3, False, CPU, 0.0)


@pytest.mark.parametrize("name", ["white_rbf.train", "nonwhite_rbf.train"])
def test_training_faults(name, one_thread):
    cell = small(name, **ONE_LAYER)
    assert run(cell)["correct"]
    for fault in ("frozen_step", "half_batch"):
        result = run(cell, fault)
        assert not result["correct"], fault


@pytest.mark.parametrize("name", ["white_rbf.serve", "nonwhite_rbf.serve"])
def test_serving_faults(name, one_thread):
    cell = small(name)
    assert run(cell)["correct"]
    result = run(cell, "altered_answer")
    assert not result["correct"]
    assert result["check"]["mean_gap"]["value"] >= 0.4
