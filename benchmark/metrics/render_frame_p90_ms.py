"""The 90th percentile of the window's per-frame latency, ms: from the
frame's call until its rgb and disparity are on the host (host clock;
linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if run.kind != "render" or run.trace is not None or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 90)) * 1e3
