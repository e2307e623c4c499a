"""Percent of the traced block of training steps in which the device ran nothing (torch.profiler)."""

from gpbench import readings


def read(reading):
    return readings.device_idle(reading, "train")
