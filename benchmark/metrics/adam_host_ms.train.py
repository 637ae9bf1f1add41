"""Host ms a training step in Adam's update, under the profiler: the
program's `adam` spans (`nrnerf/adam`, torch.profiler's clock) over the
traced steps. The profiler's cost per op is in it (Adam issues 11 small
ops a leaf), so it reads above the untraced update's host time. 0.0 where
the program opens no such span."""

from benchmark.harness import spans


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace_units:
        return None
    return 1e3 * spans.seconds_by_name(run.trace).get("adam", 0.0) \
        / run.trace_units
