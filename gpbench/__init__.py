"""Benchmark of dgp_tpu_torch on one NVIDIA H100: the yardstick (traffic
generation, the plain reference, the counts of operations and bytes, the
reduction of device traces) and the harness that runs one cell
(``run.py``)."""
