"""Where a run's set-up goes, step by step, on the card: the imports, the
card's start, the check of the port's built libraries and their loads, the
inputs, the model and the warm-up of each cell. One JSON line per step on
standard output.

    python3 gpbench/startup.py --workload <name> --seed <n>
"""

import os
import sys
import time

STARTED = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    last = [STARTED]

    def step(name):
        now = time.perf_counter()
        print(json.dumps({"step": name, "seconds": now - last[0]}), flush=True)
        last[0] = now

    import torch
    step("import torch")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    step("start the card")
    import dgp_tpu_torch.models.dgp  # noqa: F401
    import dgp_tpu_torch.parallel.serving  # noqa: F401
    step("import dgp_tpu_torch's model and serving modules")
    from dgp_tpu_torch import _build
    _build.build()
    step("check the four built libraries (hash the sources)")
    from dgp_tpu_torch.ops import cholesky, conditional_fused, conditional_fused_rbf, quadform
    for module in (conditional_fused_rbf, conditional_fused, quadform, cholesky):
        module._library()
        step(f"load {module.__name__.rsplit('.', 1)[1]}'s library")
    from gpbench import harness, inputs, registry, system
    cell = registry.load(args.workload)
    step("import the harness")
    device = torch.device("cuda", 0)
    X, Y, values = inputs.model_values(cell.config, args.seed, device)
    torch.cuda.synchronize()
    step("make the inputs")
    model = system.model(cell.config, X, Y, values, args.seed, device)
    torch.cuda.synchronize()
    step("build the model")
    if cell.traffic["kind"] == "train":
        system.train_block(cell.traffic, model, cell.traffic["steps_per_block"])
        step("first block of steps")
        system.train_block(cell.traffic, model, cell.traffic["steps_per_block"])
        step("second block of steps")
    else:
        t = cell.traffic
        for rows in (t["chunk_size"], t["rows_max"], t["chunk_size"], t["rows_max"]):
            system.serve(cell.config, t, model,
                         inputs.make_request(cell.config, args.seed, -1, rows, device),
                         device)
            step(f"request of {rows} rows")
    print(json.dumps({"step": "total", "seconds": time.perf_counter() - STARTED}))
    return 0 if harness.foreign_modules() == [] else 3


if __name__ == "__main__":
    sys.exit(main())
