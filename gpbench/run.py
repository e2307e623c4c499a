"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. With
``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. The compared numbers and their limits
are the last lines of standard error and the line's last key, ``check``.
Without a card, or with fewer cards than the cell asks for, or where JAX or
the JAX package was loaded, it prints no result and exits with a code other
than 0.
"""

import os
import sys
import time


def _process_age():
    """Seconds since this process started (its start time in
    /proc/self/stat), or 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0
    return age if 0.0 <= age < 600.0 else 0.0


STARTED = time.perf_counter() - _process_age()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from gpbench import registry

    cell = registry.load(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: the cell needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from gpbench import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), STARTED)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"gpbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(foreign)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
