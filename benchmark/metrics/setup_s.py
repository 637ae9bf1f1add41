"""Set-up, s: process start to the window's start (imports, CUDA start,
kernel build or load, inputs and weights, the checked steps or warm-up
frames) (host clock)."""


def read(run):
    return run.setup_s
