"""Device ms per request outside kernels #1-#8, by the operations' names (torch.profiler)."""

from gpbench import readings


def read(reading):
    return readings.eager_ms(reading, "serve")
