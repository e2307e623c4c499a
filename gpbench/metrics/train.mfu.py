"""Percent: the least time of the measured window's training steps at the card's peaks (gpbench/counts/dgp.py:train_step) over the window."""

from gpbench import readings


def read(reading):
    return readings.mfu(reading, "train")
