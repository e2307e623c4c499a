"""Where the harness finds a cell's parts, by the names in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py`` under the
benchmark's folder. A new configuration, traffic mix, cell or per-layer
metric is a new file and a new entry; no file that is there changes."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # the cell's end-to-end metrics (entries)
    per_layer: list      # (entry, reader) of the cell's per-layer metrics


def _json(path):
    with open(path) as f:
        return json.load(f)


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def reader(here, name):
    """The ``read(reading)`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load(name, root=ROOT, here=HERE):
    """Cell ``name`` of ``BENCHMARK.json``, with its parts."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return assemble(bench, workloads[name], here)


def assemble(bench, workload, here=HERE):
    """The cell of a ``workloads`` entry: its configuration, traffic mix
    and limits by name, and the metrics of ``bench`` that apply to it."""
    name = workload["name"]
    config = _json(os.path.join(here, "configs", workload["config"] + ".json"))
    traffic = _json(os.path.join(here, "traffic", workload["traffic"] + ".json"))
    limits = _json(os.path.join(here, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    layers = [(m, reader(here, m["name"])) for m in bench["per_layer"]
              if applies(m, name)]
    return Cell(name, workload, config, traffic, limits, e2e, layers)
