"""Summarize a training run's metrics.jsonl.

    python3 -m nonrigid_nerf_torch.cli.summarize <logs/metrics.jsonl> \
        [--window 1550 2000 --window 3550 4000]

Prints one JSON object: for each window, the mean of the training `psnr`
readings at the steps inside it (both ends included) and their count;
steps/s over every `i_print` window after the first (all their time, as
the sum of the windows' times); the validation PSNRs by step; and the peak
device memory, where the run wrote them.
"""

from __future__ import annotations

import argparse
import json
import sys


def summarize(path: str, windows=()) -> dict:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "psnr" in r]
    out = {"steps": train[-1]["step"] if train else 0, "windows": []}
    for lo, hi in windows:
        vals = [r["psnr"] for r in train if lo <= r["step"] <= hi]
        out["windows"].append({"from": lo, "to": hi, "readings": len(vals),
                               "mean_psnr": (sum(vals) / len(vals)
                                             if vals else None)})
    if len(train) > 1:
        spans = [b["step"] - a["step"] for a, b in zip(train, train[1:])]
        seconds = sum(n / r["it_per_sec"] for n, r in zip(spans, train[1:]))
        out["steps_per_s"] = sum(spans) / seconds
        out["steps_per_s_from"] = train[0]["step"] + 1
    out["val_psnr"] = {r["step"]: r["val_psnr"] for r in rows
                       if "val_psnr" in r}
    peak = [r["peak_device_bytes"] for r in rows if "peak_device_bytes" in r]
    out["peak_device_bytes"] = peak[-1] if peak else None
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("metrics", help="a run's logs/metrics.jsonl")
    parser.add_argument("--window", nargs=2, type=int, action="append",
                        default=[], metavar=("FROM", "TO"),
                        help="steps whose psnr readings to average")
    ns = parser.parse_args(argv)
    print(json.dumps(summarize(ns.metrics, ns.window)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
