"""Device ms a frame in the traced window: the time in which a kernel, a
copy or a set ran (torch.profiler), over the traced frames. The profiler
slows the host, not the device, so this reads the frame's device work
where `idle_share.render` also reads the profiler's cost."""


def read(run):
    if run.kind != "render" or run.trace is None or not run.trace_units:
        return None
    return 1e3 * run.trace.busy_s / run.trace_units
