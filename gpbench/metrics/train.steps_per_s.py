"""Adam steps per second over the measured window, on the host's clock (the window of the --trace 1 run, which runs with no profiler)."""

from gpbench import readings


def read(reading):
    return readings.rate(reading, "train")
