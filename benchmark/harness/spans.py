"""The program's spans in a traced run: the host ranges that the program
opens under the profiler (`nonrigid_nerf_torch/utils/spans.py`), named
`nrnerf/<stage>`, read back from `Trace.host_ops`.

The trace keeps no thread of a host op, so spans nest by time: a span that
autograd's device thread opens during a backward lies inside the calling
thread's `backward` span. Where two spans overlap without one holding the
other, the later-started one is the inner one.

    python3 -m benchmark.harness.spans --workload <cell> --seed <n> \
        [--seconds <s>]

runs the cell with its trace and prints one JSON line: the device's idle
ms a unit split by the innermost program span open on the host (`null`: no
span open), each span's host ms a unit and its count a unit.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict, List, Optional, Tuple

PREFIX = "nrnerf/"

Span = Tuple[str, float, float]          # (stage, start s, end s)


def program_spans(trace) -> List[Span]:
    return [(n[len(PREFIX):], s, e) for n, s, e in trace.host_ops
            if n.startswith(PREFIX)]


def seconds_by_name(trace) -> Dict[str, float]:
    """Host seconds of the program's spans, summed by stage."""
    out: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in program_spans(trace):
        out[n] += e - s
    return dict(out)


def count_by_name(trace) -> Dict[str, int]:
    return dict(collections.Counter(n for n, _, _ in program_spans(trace)))


def innermost(spans: List[Span]) -> List[Tuple[float, float, Optional[str]]]:
    """The innermost open span along the time the spans cover: consecutive
    (start, end, stage) pieces, stage None where no span is open."""
    bounds = sorted({t for _, s, e in spans for t in (s, e)})
    opens = sorted(spans, key=lambda sp: sp[1])
    pieces, active, i = [], [], 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while i < len(opens) and opens[i][1] <= t0:
            active.append(opens[i])
            i += 1
        active = [sp for sp in active if sp[2] > t0]
        inner = max(active, key=lambda sp: (sp[1], -sp[2]), default=None)
        pieces.append((t0, t1, inner[0] if inner else None))
    return pieces


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The stretches of the traced window in which nothing ran on the
    device: before, between and after its busy intervals, within the
    extent of the host's operations and the device's work."""
    busy = trace.intervals()
    times = [t for _, s, e in trace.host_ops for t in (s, e)] \
        + [t for iv in busy for t in iv]
    if not times:
        return []
    cur, hi = min(times), max(times)
    out = []
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_by_span(trace) -> Dict[Optional[str], float]:
    """Device-idle seconds by the innermost program span open on the host,
    each idle stretch split over the spans along it by exact overlap; None
    holds the idle time in which no span was open."""
    pieces = innermost(program_spans(trace))
    out: Dict[Optional[str], float] = collections.defaultdict(float)
    j = 0
    for a, b in idle_intervals(trace):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[name] += overlap
                covered += overlap
            k += 1
        if b - a > covered:
            out[None] += b - a - covered
    return dict(out)


def summary(run) -> dict:
    """Idle ms, span host ms and span counts a unit of a traced run."""
    units = run.trace_units
    return {"units": units,
            "idle_ms": {k: 1e3 * v / units
                        for k, v in sorted(idle_by_span(run.trace).items(),
                                           key=lambda kv: -kv[1])},
            "host_ms": {k: 1e3 * v / units
                        for k, v in seconds_by_name(run.trace).items()},
            "count": {k: v / units
                      for k, v in count_by_name(run.trace).items()}}


def main(argv=None) -> int:
    from benchmark.harness import cells, spec
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    run = cells.run_cell(spec.cell(args.workload), args.seed, args.seconds,
                         True, "cuda", time.time())
    print(json.dumps(dict(summary(run), workload=args.workload,
                          correct=run.correct, device=run.device_name,
                          idle_share=1.0 - run.trace.busy_s
                          / run.trace.window_s)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
