"""A training cell's end-to-end metric is the device's busy time a step,
read from a record of the whole untraced window; its host rate is a
per-layer metric of the traced run, whose window nothing records."""

import torch

from gpbench.tests.smallcells import one_thread, small  # noqa: F401
from gpbench import harness

CPU = torch.device("cpu")


def test_training_metrics(one_thread):
    cell = small("white_rbf.train", hidden_dims=[], mean_functions=["zero"])
    plain = harness.run(cell, 31, 0.3, False, CPU, 0.0)
    assert set(plain["metrics"]) == {"train_device_ms_per_step", "setup_s"}
    ms = plain["metrics"]["train_device_ms_per_step"]["value"]
    assert 0.0 < ms
    # busy time never exceeds the window: at most its length a step
    assert ms * plain["attempted"] <= 1e3 * 0.3 * 5
    traced = harness.run(cell, 31, 0.3, True, CPU, 0.0)
    assert "train_device_ms_per_step" not in traced["metrics"]
    assert "train.steps_per_s" not in traced["metrics"]   # not on a card
    assert traced["correct"]
