"""The device memory the training window held at its peak, GiB
(torch.cuda.max_memory_allocated, reset at the window's start)."""


def read(run):
    if run.kind != "train" or not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
