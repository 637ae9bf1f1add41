"""Share of the traced train window in which nothing ran on the device
(torch.profiler), %. The profiler slows the host, so where the host
paces part of a step this reads above the untraced run's idle share;
`device_busy_ms.train` reads the device's work alone."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
