"""The command line of a run: read the cell by name, check the chips, run
it, and print the result line.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device` (with `--trace 1` also
`busy_s` and `window_s`), with `--trace 1` `breakdown`, and last `checks`,
each compared number beside its limit. The same numbers close standard
error. A run exits 1 without a result where the chips are missing, where a
module of JAX or of the JAX package is loaded after the window, or where a
metric the cell lists reads nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.harness import cells, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "nonrigid_nerf_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run, cell, trace: bool, chips: int) -> dict:
    metrics = spec.read_metrics(cell["per_layer" if trace else "end_to_end"],
                                run, cell["bench_dir"])
    device = {"platform": "gpu", "kind": run.device_name, "count": chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(run.correct), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": run.limits.get(k)}
                      for k, v in run.checks.items()}
    return line


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    trace = bool(args.trace)
    run = cells.run_cell(cell, args.seed, args.seconds, trace, "cuda", t0)
    line = result_line(run, cell, trace, chips)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 1
    wanted = cell["per_layer" if trace else "end_to_end"]
    silent = [m["name"] for m in wanted if m["name"] not in line["metrics"]]
    if silent:
        print(f"metrics that read nothing in {args.workload}: "
              f"{', '.join(silent)}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0
