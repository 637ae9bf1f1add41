"""Device kernels a frame in the traced window (torch.profiler; copies and
sets not counted)."""


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    return run.trace.kernel_count() / run.trace_units
