"""Readings that the limits of ``limits/<cell>.json`` are set from, in one
process: the program's compared numbers on many seeds (each a run with a
short window), the lower-precision control's (the reference in TF32 in the
program's place) and, with ``--fault``, the program's with a fault planted
(``faults.py``). One JSON line per reading on standard output, and in
``--out``.

    python3 gpbench/calibrate.py --workload <name> --seeds 1,2,3
        [--control 4,5,6] [--fault half_batch --fault-seeds 7,8,9]
        [--seconds 2] [--out calibrate.jsonl]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    import argparse
    import json

    import torch

    from gpbench import faults, harness, loops, registry

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control", default="")
    parser.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    cell = registry.load(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else None
    if device is None:
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(**line):
        text = json.dumps(dict(workload=args.workload, **line))
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    harness.system.build_kernels(device)

    def program(seed):
        drive = harness.KINDS[cell.traffic["kind"]](cell, seed, device)
        loops.closed_loop(drive.prepare, drive.send, args.seconds)
        drive.release()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        numbers = drive.numbers()
        seconds = time.perf_counter() - start
        gaps = drive.gaps() if hasattr(drive, "gaps") else None
        return numbers, seconds, gaps

    for seed in _seeds(args.seeds):
        numbers, ref_s, gaps = program(seed)
        emit(kind="program", seed=seed, numbers=numbers, reference_s=ref_s,
             gaps=gaps)
    for seed in _seeds(args.control):
        train = cell.traffic["kind"] == "train"
        emit(kind="control", seed=seed,
             numbers=harness.control_numbers(cell, seed, device),
             gaps=harness.control_numbers(cell, seed, device, gaps=True)
             if train else None)
    for seed in _seeds(args.fault_seeds):
        with faults.FAULTS[args.fault]():
            numbers, _, gaps = program(seed)
        emit(kind="fault", fault=args.fault, seed=seed, numbers=numbers,
             gaps=gaps)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
