"""The spread of each metric over the runs of a cell's sets: per set the
median and the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median, and five
times the wider spread (the bound it suggests). Each input line is one run:
``{"cell", "set", "trace", "result"}``, ``result`` being the run's last
line.

    python3 gpbench/spread.py runs.jsonl [...]
"""

import json
import statistics
import sys
from collections import defaultdict


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths):
    runs = [json.loads(line) for path in paths for line in open(path)]
    table = defaultdict(lambda: defaultdict(list))
    for r in runs:
        res = r.get("result") or {}
        if r.get("trace"):
            tag = "traced"
        else:
            tag = r["set"]
        for name, m in res.get("metrics", {}).items():
            table[(r["cell"], name)][tag].append(m["value"])
        table[(r["cell"], "correct")][tag].append(res.get("correct"))
    for (cell, name), sets in sorted(table.items()):
        if name == "correct":
            print(cell, "correct", {k: v.count(True) for k, v in sets.items()},
                  "of", {k: len(v) for k, v in sets.items()})
            continue
        parts = []
        widest = 0.0
        for tag, values in sorted(sets.items()):
            if len(values) >= 2 and tag != "traced":
                s = spread(values)
                widest = max(widest, s)
                parts.append(f"{tag}: median {statistics.median(values)!r} "
                             f"spread {s:.4f} n={len(values)}")
            else:
                parts.append(f"{tag}: {values}")
        print(cell, name, "; ".join(parts), f"-> 5x widest {5 * widest:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
