"""Seconds the run's process spent building (nvcc) and loading (ctypes) the
program's kernel libraries, all at first use during set-up: the program's
counter `ops/kernels/build.py:KERNEL_LOAD`. 0.0 where the program keeps no
such counter, as the span readers read 0.0 where it opens no span: a None
in a cell that lists the metric would end a `--trace 1` run with exit 1."""

import importlib


def read(run):
    build = importlib.import_module("nonrigid_nerf_torch.ops.kernels.build")
    return float(getattr(build, "KERNEL_LOAD", {"seconds": 0.0})["seconds"])
