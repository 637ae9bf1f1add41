"""Frames a second of one viewer: every frame delivered to the host in the
window, over the window's wall time (host clock)."""


def read(run):
    if run.kind != "render" or run.trace is not None or not run.window_s:
        return None
    return run.units / run.window_s
