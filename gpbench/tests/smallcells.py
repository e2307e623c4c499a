"""Helpers of the benchmark's CPU tests: small copies of the
cells (the configurations' widths kept where the CPU can hold them)."""

import os

import pytest
import torch

from gpbench import registry


@pytest.fixture(scope="module")
def one_thread():
    """Torch on one intra-op thread for the module's tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def cell_named(name):
    """Cell ``name`` of ``BENCHMARK.json``, or one whose files are there
    (``<config-prefix>.<traffic>``: ``nonwhite_rbf.train`` is
    ``dgp2_nonwhite_rbf`` under ``train``) and has no entry yet."""
    try:
        return registry.load(name)
    except KeyError:
        prefix, traffic = name.rsplit(".", 1)
        bench = registry._json(os.path.join(registry.ROOT, "BENCHMARK.json"))
        return registry.assemble(bench, {"name": name, "config": "dgp2_" + prefix,
                                         "traffic": traffic, "chips": 1})


def small(name, **config):
    """Cell ``name`` at a size the CPU holds: fewer rows, inducing points
    and samples, small requests; ``config`` overrides more keys."""
    cell = cell_named(name)
    cfg = dict(cell.config, num_data=300, num_inducing=24, num_samples=3)
    cfg.update(config)
    traffic = dict(cell.traffic)
    if traffic["kind"] == "serve":
        traffic.update(rows_min=200, rows_max=800, chunk_size=500,
                       sizes_per_block=4, check_span=4, check_requests=2,
                       reference_block=300)
    else:
        traffic.update(steps_per_block=4)
    return cell._replace(config=cfg, traffic=traffic)
