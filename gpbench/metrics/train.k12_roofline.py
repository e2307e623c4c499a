"""Percent: the bounds of kernel #1's and #2's launches in the traced block (gpbench/counts/k1.py, k2.py) over their device time, phase B included."""

from gpbench import readings


def read(reading):
    return readings.roofline(reading, "train", ("k1", "k2"))
