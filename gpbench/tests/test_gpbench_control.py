"""The lower-precision control, at a size the CPU holds: the reference
computed in TF32 (its products' operands rounded to 10 mantissa bits, as
the card's tensor cores take them), put in the program's place, fails at
least one of each cell's numbers against the cell's own limits. On the
card ``calibrate.py --control`` reads it at the cells' full sizes."""

import pytest
import torch

from gpbench.tests.smallcells import one_thread, small  # noqa: F401
from gpbench import check, harness


@pytest.mark.parametrize("name", ["white_rbf.train", "nonwhite_rbf.train",
                                  "white_rbf.serve", "nonwhite_rbf.serve"])
def test_control_is_not_correct(name, one_thread):
    cell = small(name, num_data=1000, num_inducing=128)
    for seed in (31, 32, 33):
        numbers = harness.control_numbers(cell, seed, torch.device("cpu"))
        correct, shown = check.verdict(numbers, cell.limits)
        assert not correct, shown
