"""The multi-fidelity BO oracle through the PyTorch port: the AR(1) cell of
``benchmarks/mf_bo_bakeoff.py`` re-run by ``dgp_tpu_torch.bo.MF_BO``, on the
card in float32 unless ``--cpu`` is given.

    python3 compat_torch/validate_mf_bo.py [--park] [--fast] [--cpu]

The Forrester pair (d = 1, DoE 8 + 4, f* = -6.020740) at seeds 0, 1 and 2,
10 infills each, with the bake-off's budget: MF_BO's default surrogate
(exact AR(1) co-kriging, 8 starts x 2,000 Adam steps), DE 300 x 400 and
500 samples. Band: simple regret <= 1e-3 on every seed. ``--park`` adds
the Park pair (d = 4, DoE 24 + 8; band: best <= 1e-3 on every seed).
``--fast`` runs the bake-off's own ``--fast`` budget (3 starts x 100
steps, DE 15 x 15, 15 samples, 2 infills) and asserts only that the traces
are finite and never rise.

Prints each seed's best trace, fidelity choices, cost and seconds per
infill, and the card's name and power limit.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgp_tpu_torch.bo.mf_bo import DEFAULT_MODEL_DIC, MF_BO  # noqa: E402
from dgp_tpu_torch.utils import test_functions as tf  # noqa: E402

# benchmarks/mf_bo_bakeoff.py's PROBLEMS (fidelities, d, DoE sizes, infills)
# and their bands: the Forrester pair's simple regret against f*, the Park
# pair's best value
PROBLEMS = {
    "forrester": ((tf.forrester_low, tf.forrester_high), 1, (8, 4), 10,
                  -6.020740),
    "park": ((tf.park_low, tf.park_high), 4, (24, 8), 10, 0.0),
}
BAND = 1e-3
SEEDS = (0, 1, 2)
RUN = dict(popsize_DE=300, iterations_DE=400, num_samples=500,
           verbose=False)
FAST_SPEC = {"type": "ar1", "n_starts": 3, "iterations": 100}
FAST_RUN = dict(popsize_DE=15, iterations_DE=15, num_samples=15,
                verbose=False)


def device_line(device):
    if device.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_seed(name, seed, fast, device):
    """One (problem, seed) cell: (best trace, the loop, seconds per
    infill)."""
    fns, d, doe, infills, _ = PROBLEMS[name]
    bo = MF_BO(fidelities=list(fns), DoE_sizes=doe, d=d,
               model_dic=FAST_SPEC if fast else DEFAULT_MODEL_DIC, seed=seed,
               device=device)
    seconds = []
    for _ in range(2 if fast else infills):
        t0 = time.perf_counter()
        bo.run(1, **(FAST_RUN if fast else RUN))
        if bo.device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return np.asarray(bo.best_trace), bo, seconds


def main(argv):
    fast, device = "--fast" in argv, "cpu" if "--cpu" in argv else None
    names = ["forrester"] + (["park"] if "--park" in argv else [])
    missed = []
    for name in names:
        fns, d, doe, infills, target = PROBLEMS[name]
        for seed in SEEDS:
            trace, bo, seconds = run_seed(name, seed, fast, device)
            score = trace[-1] - target
            print(f"{name} (d {d}, DoE {doe}) seed {seed}: best trace "
                  f"{np.array2string(trace, precision=6)}; fidelities "
                  f"{bo.fidelity_choices}; cost {bo.cost_spent:.2f}; "
                  f"{'simple regret' if name == 'forrester' else 'best'} "
                  f"{score:.3e}; s per infill "
                  f"{', '.join(f'{s:.2f}' for s in seconds)} (mean "
                  f"{np.mean(seconds):.2f}); x_best {bo.x_best}", flush=True)
            if not (np.all(np.isfinite(trace))
                    and np.all(np.diff(trace) <= 0)):
                raise AssertionError(f"{name} seed {seed}: trace {trace}")
            if not fast and not score <= BAND:
                missed.append(f"{name} seed {seed}: {score:.3e}")
    print(f"on {bo.device} in {bo.dtype} ({device_line(bo.device)})")
    if fast:
        print("--fast: traces finite and never rising: OK")
        return
    if missed:
        raise AssertionError(f"band {BAND} missed: {'; '.join(missed)}")
    print(f"band (Forrester simple regret"
          + (", Park best" if "park" in names else "")
          + f" <= {BAND} on seeds {SEEDS}): OK")


if __name__ == "__main__":
    main(sys.argv[1:])
