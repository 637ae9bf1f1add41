"""What every comparison that decides `correct` shares. A driver
(`benchmark/drivers/`) holds what its timed path produced against the
plain reference that the configuration names, run on the same inputs after
the window has closed and the program's state is freed, and hands the
numbers to `finish`.

A cell's limits file (`limits/<cell>.json`) names the numbers it holds; a
run is correct when each of them is finite and under its limit. The
others stay in the run's detail.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch


def worst(values) -> float:
    """The largest value, or NaN where any is NaN."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def finish(run, numbers: Dict[str, float], limits: Dict[str, float]):
    """Hold the numbers that the cell's limits name; keep the others in
    the run's detail."""
    run.detail["numbers"] = numbers
    run.checks = {k: v for k, v in numbers.items() if k in limits}
    run.limits = {k: limits[k] for k in run.checks}
    bad = [k for k, v in run.checks.items()
           if not math.isfinite(v) or v > limits[k]]
    missing = [k for k in limits if k not in numbers]
    run.failed = run.attempted if (bad or missing) else 0
    run.correct = not bad and not missing


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves) -> Dict[str, float]:
    """Each leaf's |‖a‖ - ‖b‖| / max(‖b‖, median leaf ‖b‖)."""
    norms = {k: (float(torch.linalg.norm(prog[k].float())),
                 float(torch.linalg.norm(ref[k].float()))) for k in leaves}
    med = statistics.median(b for _, b in norms.values())
    return {k: abs(a - b) / max(b, med) for k, (a, b) in norms.items()}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """Each leaf's ‖a - b‖ / max(‖b‖, median leaf ‖b‖)."""
    norms = {k: float(torch.linalg.norm(ref[k].float())) for k in ref}
    med = statistics.median(norms.values())
    return {k: float(torch.linalg.norm(prog[k].float() - ref[k].float()))
            / max(norms[k], med) for k in ref}
