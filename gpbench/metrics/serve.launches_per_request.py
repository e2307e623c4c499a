"""Device operations per request in the traced block (torch.profiler)."""

from gpbench import readings


def read(reading):
    return readings.launches(reading, "serve")
