"""The compared numbers of a cell over many seeds, for the program, its
control and its planted faults, in one process (the kernels build once),
on the card:

    python3 -m benchmark.harness.readings --workload <cell> \
        --seeds 11,12,13 --variants program,control,half_batch [--seconds 2]

Prints one JSON line a run: the card's name, variant, seed, correct, the
numbers and the window's units. The variants are `cells.run_cell`'s:
"program", "control" and the faults of the cell's driver. The readings are
what a cell's limits are set from (PERF.md gives them). Exits 1 without a
CUDA device: limits are set from the card's readings alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.harness import cells, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 1
    cell = spec.cell(args.workload)
    name = torch.cuda.get_device_name()
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.time()
            run = cells.run_cell(cell, seed, args.seconds, False, "cuda",
                                 variant=variant)
            print(json.dumps({"device_name": name,
                              "workload": args.workload, "variant": variant,
                              "seed": seed, "correct": run.correct,
                              "checks": run.checks, "units": run.units,
                              "setup_s": run.setup_s, "detail": run.detail,
                              "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
