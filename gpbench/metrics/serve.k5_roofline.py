"""Percent: the bounds of kernel #5's launches in the traced block (gpbench/counts/k5.py) over its device time."""

from gpbench import readings


def read(reading):
    return readings.roofline(reading, "serve", ("k5",))
