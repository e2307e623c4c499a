"""Percent: the bounds of kernel #1's launches in the traced block (gpbench/counts/k1.py) over its device time."""

from gpbench import readings


def read(reading):
    return readings.roofline(reading, "serve", ("k1",))
