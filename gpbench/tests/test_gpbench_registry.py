"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and entries in BENCHMARK.json) are found by name, and the new
metric reaches the result line, with no file that was there edited."""

import json
import os
import shutil

import torch

from gpbench.tests.smallcells import one_thread  # noqa: F401
from gpbench import harness, registry

NEW_METRIC = '''"""Requests answered in the measured window (a count)."""


def read(reading):
    return reading.units if reading.kind == "serve" else None
'''


def test_new_files_are_found_by_name(tmp_path, one_thread):
    here = tmp_path / "gpbench"
    for part in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(registry.HERE, part), here / part)
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(here / "configs" / "dgp2_white_rbf.json") as f:
        config = json.load(f)
    config.update(name="dgp1_white_rbf", hidden_dims=[], mean_functions=["zero"],
                  num_data=200, num_inducing=16, num_samples=2)
    (here / "configs" / "dgp1_white_rbf.json").write_text(json.dumps(config))
    with open(here / "traffic" / "serve.json") as f:
        traffic = json.load(f)
    traffic.update(name="serve_small", rows_min=100, rows_max=400, chunk_size=250,
                   sizes_per_block=4, check_span=4, check_requests=2,
                   reference_block=200)
    (here / "traffic" / "serve_small.json").write_text(json.dumps(traffic))
    (here / "limits" / "dgp1.serve_small.json").write_text(json.dumps(
        {"mean_gap": {"limit": 1e-3}, "var_gap": {"limit": 1e-3}}))
    (here / "metrics" / "serve.requests.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "dgp1_white_rbf", "source": "x",
                             "file": "gpbench/configs/dgp1_white_rbf.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dgp1.serve_small", "config": "dgp1_white_rbf",
                               "traffic": "serve_small", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "serve_p95_ms" == m["name"] or "serve_points_per_s" == m["name"]:
            m["workloads"].append("dgp1.serve_small")
    bench["per_layer"].append({"name": "serve.requests", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "Entry", "moves": "serve_points_per_s",
                               "workloads": ["dgp1.serve_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.load("dgp1.serve_small", root=str(tmp_path), here=str(here))
    assert cell.config["name"] == "dgp1_white_rbf"
    assert cell.traffic["rows_max"] == 400
    assert [m["name"] for m, _ in cell.per_layer] == ["serve.requests"]
    assert {m["name"] for m in cell.end_to_end} == {
        "serve_points_per_s", "serve_p95_ms", "setup_s"}

    cpu = torch.device("cpu")
    plain = harness.run(cell, 11, 0.2, False, cpu, 0.0)
    assert set(plain["metrics"]) == {"serve_points_per_s", "serve_p95_ms", "setup_s"}
    assert plain["correct"]
    traced = harness.run(cell, 11, 0.2, True, cpu, 0.0)
    assert traced["metrics"]["serve.requests"]["value"] >= 1
    assert list(traced)[-1] == "check"
