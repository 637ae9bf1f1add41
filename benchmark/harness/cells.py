"""A run of a cell: what every kind of traffic shares.

The cell's traffic file names its driver (`"driver"`, a file under
`benchmark/drivers/`) and its configuration file names its reference
(`"reference"`, a file under `benchmark/reference/`); `run_cell` loads both
by path, so a new kind of traffic or a new reference arrives as files of
its own. A driver module gives
- `run(cell, seed, seconds, trace, device, t0, ref) -> Run`: set-up, the
  window (`window`) and the comparison with the reference module `ref`;
- `control(cell, seed, device, t0, ref) -> Run`: the reference in the
  program's place one precision below what the configuration states,
  judged by the same comparison;
- `FAULTS`: {name: context manager factory}, faults planted in the program.

`Run` is what the metric readers and the comparison read. The program is
everything imported from `nonrigid_nerf_torch`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import spec
from benchmark.harness.trace import Trace, traced


@dataclasses.dataclass
class Run:
    kind: str
    config: dict
    traffic: dict
    device_name: str
    setup_s: float = 0.0
    units: int = 0                      # steps or frames in the window
    window_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    rays_per_unit: int = 0
    trace: Optional[Trace] = None
    trace_units: int = 0                # steps or frames under the profiler
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_window_bytes: int = 0
    memory_peak_bytes: int = 0
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    detail: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    correct: bool = False


@contextlib.contextmanager
def program_precision():
    """The program's f32 products as the configuration states them: TF32
    off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def program_config(config: dict):
    from nonrigid_nerf_torch.config import ModelConfig
    return ModelConfig(**dict(config["model"],
                              skips=tuple(config["model"]["skips"])))


def program_model(cfg, weights: dict, num_timesteps: int, device):
    """The program's model holding the benchmark's weights."""
    from nonrigid_nerf_torch.models.model import NRNeRF
    model = NRNeRF(cfg, num_timesteps, device="meta").to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def launch_counts() -> Dict[str, int]:
    from nonrigid_nerf_torch.ops.kernels import mlp_bwd, mlp_fwd
    return {"mlp_fwd": mlp_fwd.mlp_fwd.launches,
            "mlp_bwd": mlp_bwd.mlp_bwd.launches}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0


def window(run: Run, unit, seconds: float, trace: bool, trace_units: int,
           device):
    """The measured window: `unit()` until `seconds` have passed, all of it
    on the host's clock (units, window_s). With `trace`, then
    `trace_units` more under the profiler (trace, trace_units), so that
    the profiler's cost on the host, which lasts past its end, stays out
    of the window. The launch counters cover the traced units, or without
    a trace the window. Records the peak memory of both."""
    sync(device)
    reset_peak(device)
    before = launch_counts()
    t0 = time.perf_counter()
    n = 0
    while True:
        unit()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    run.units, run.window_s = n, time.perf_counter() - t0
    if trace:
        def loop():
            for _ in range(trace_units):
                unit()
        before = launch_counts()
        run.trace = traced(loop, device)
        run.trace_units = trace_units
    after = launch_counts()
    run.counters = {k: after[k] - before[k] for k in after}
    run.peak_window_bytes = peak(device)


def free_program(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None, variant: str = "program") -> Run:
    """One run of a cell by the driver its traffic names, judged against
    the reference its configuration names. `variant`: "program" as the
    configuration states it; "control" (the driver's `control`); or a
    fault of the driver's `FAULTS` planted in the program."""
    t0 = time.time() if t0 is None else t0
    device = torch.device(device)
    driver = spec.module(cell["traffic"]["driver"], cell["root"])
    ref = spec.module(cell["config"]["reference"], cell["root"])
    if variant == "control":
        return driver.control(cell, seed, device, t0, ref)
    fault = driver.FAULTS[variant]() if variant != "program" \
        else contextlib.nullcontext()
    with fault, program_precision():
        return driver.run(cell, seed, seconds, trace, device, t0, ref)
