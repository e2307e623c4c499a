"""Percent: the bounds of kernel #5's and #6's launches in the traced block (gpbench/counts/k5.py, k6.py) over their device time, phase B included."""

from gpbench import readings


def read(reading):
    return readings.roofline(reading, "train", ("k5", "k6"))
