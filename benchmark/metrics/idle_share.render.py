"""Share of the traced render window in which nothing ran on the device
(torch.profiler), %. The profiler slows the host, so where the host
paces part of a frame this reads above the untraced run's idle share;
`device_busy_ms.render` reads the device's work alone."""


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
