"""Percent: the least time of the measured window's requests at the card's peaks (gpbench/counts/dgp.py:request) over the window."""

from gpbench import readings


def read(reading):
    return readings.mfu(reading, "serve")
