"""The spreads of a cell's two sets of runs (`benchmark/sets.sh`):

    python3 -m benchmark.harness.spreads <out dir>

For each end-to-end metric: each set's median and spread (the distance
between the first and third quartiles of `statistics.quantiles(n=4)`, over
the median), the spread of all twelve runs, and the mean of the two sets'
spreads with each set's run farthest from its median left out; then each
traced run's per-layer metrics.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import sys


def last_line(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def runs(out_dir: str, prefix: str):
    paths = glob.glob(os.path.join(out_dir, f"{prefix}.*.out"))
    return [last_line(p) for p in sorted(
        paths, key=lambda p: int(p.rsplit(".", 2)[-2]))]


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed_spread(values) -> float:
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda x: abs(x - med)))
    return spread(rest)


def main(argv=None) -> int:
    out_dir = (sys.argv[1:] if argv is None else argv)[0]
    sets = [runs(out_dir, "s1"), runs(out_dir, "s2")]
    print("correct in every run:", all(r["correct"] for s in sets for r in s))
    for name in sets[0][0]["metrics"]:
        vals = [[r["metrics"][name]["value"] for r in s] for s in sets]
        print(f"{name}: medians {statistics.median(vals[0]):.6g} "
              f"{statistics.median(vals[1]):.6g}; spreads "
              f"{spread(vals[0]):.4f} {spread(vals[1]):.4f}; all "
              f"{spread(vals[0] + vals[1]):.4f}; trimmed mean "
              f"{statistics.mean(trimmed_spread(v) for v in vals):.4f}")
        print("   ", " ".join(f"{x:.6g}" for x in vals[0]), "|",
              " ".join(f"{x:.6g}" for x in vals[1]))
    for r in runs(out_dir, "t"):
        print("traced:", r["correct"],
              {k: v["value"] for k, v in r["metrics"].items()},
              "busy_s", r["device"]["busy_s"],
              "window_s", r["device"]["window_s"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
