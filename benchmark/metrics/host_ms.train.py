"""Host ms a training step in the traced window, under the profiler: the
program's `step` spans (`nrnerf/step`, torch.profiler's clock) over the
traced steps. The span opens before the step's first launch and closes
after its last host work, so this is the traced step's wall time, not the
host's cost of issuing it alone, and the profiler's cost per op is in it:
a change that only cuts ops moves it more than the untraced step time
(`train_rays_per_s`). Read it beside `device_busy_ms.train`, the device's
work a step. 0.0 where the program opens no such span."""

from benchmark.harness import spans


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace_units:
        return None
    return 1e3 * spans.seconds_by_name(run.trace).get("step", 0.0) \
        / run.trace_units
