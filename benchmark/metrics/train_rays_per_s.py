"""Training rays a second: every ray of every step issued in the window,
over the window's wall time, which ends when the device has finished them
(host clock)."""


def read(run):
    if run.kind != "train" or run.trace is not None or not run.window_s:
        return None
    return run.units * run.rays_per_unit / run.window_s
