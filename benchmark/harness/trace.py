"""The device trace of a traced window: torch.profiler around the window's
work, read back as kernel intervals and host operations.

`busy_s` is the union of the intervals in which a kernel, a copy or a set
ran on the device; `window_s` the window's host time, which ends in a
synchronisation. Idle gaps are the stretches between device intervals,
each named by the innermost host operation running at its middle ("host:
python" where the profiler recorded none).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, float, float]]      # (name, start s, end s)
    copies: List[Tuple[str, float, float]]       # memcpy / memset
    host_ops: List[Tuple[str, float, float]]

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n))

    def kernel_count(self, match: Callable[[str], bool] = lambda n: True) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's busy intervals, in time order."""
        spans = sorted((s, e) for _, s, e in self.kernels + self.copies)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def device_ops(self, top: int = 10) -> List[list]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, s, e in self.kernels + self.copies:
            by_name[n[:160]] += e - s
        return [[n, t] for n, t in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time between device intervals, summed by the host operation
        that ran at each gap's middle; the largest `top`."""
        spans = self.intervals()
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by_name: Dict[str, float] = collections.defaultdict(float)
        for (_, end), (start, _) in zip(spans, spans[1:]):
            mid = 0.5 * (end + start)
            # the innermost op holding mid is the latest-starting one
            name = "python"
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4000),
                           -1):
                if ops[i][2] >= mid:
                    name = ops[i][0]
                    break
            by_name["host: " + name[:120]] += start - end
        return [[n, t] for n, t in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:top]]


def traced(run: Callable[[], None], device) -> Trace:
    """Run `run()` under torch.profiler (host and device activity), then
    synchronise, and read the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    kernels, copies, host = [], [], []
    for ev in prof.events():
        span = (ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if ev.device_type == DeviceType.CUDA:
            low = ev.name.lower()
            (copies if low.startswith(("memcpy", "memset")) else kernels
             ).append(span)
        elif ev.device_type == DeviceType.CPU:
            host.append(span)
    return Trace(window_s=window_s, kernels=kernels, copies=copies,
                 host_ops=host)
