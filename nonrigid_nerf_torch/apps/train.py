"""The training loop
(counterpart of the loop in the JAX package's train.py:231-243,408-434,
512-546; the command line around it is `cli/train.py`).

`train` starts from the state it is given, or creates the train state or
resumes it from the newest checkpoint of `logdir` (`initial_state`, which
also takes the CLI's `ft_path`), steps to `tc.N_iters`, prints the `[TRAIN]` line
and appends to `<logdir>/metrics.jsonl` every `i_print` steps, saves
`latest.npz` every `i_weights` steps (a numbered archive every 50,000) and
at its last step, and calls `on_step(i, state)` after each step's save (the
CLI's validation images, videos and test-set renders). `die_at_step` kills
the process after that step's save in a fresh run (fault injection);
`profile_steps` traces that many steps after the first 50 with
torch.profiler into `<logdir>/profile/`; the trace carries the step's
named spans (`nrnerf/step`, `nrnerf/adam`, ...: `utils/spans.py`). On a
GPU the run ends with its peak device memory, `peak_device_bytes` in
metrics.jsonl.

Under a process group of more than one rank (`parallel/multihost.py`) the
loop runs the data-parallel step (`parallel/mesh.py`) on every rank, from
rank 0's weights (`replicate`). Rank 0 alone prints the `[TRAIN]` line,
appends to metrics.jsonl, saves and records its own peak device memory;
every rank writes its own profile trace (`..._rank<r>.json` beside rank
0's), and every rank calls `on_step`, whose renders are collective. After
a save the ranks meet at a barrier, and `die_at_step` kills each rank only
after it, so that no rank runs past the saved step.

Resume is exact: the random numbers of step k come from a generator seeded
with (tc.seed, k), never from state that a restart would lose, so a run
that is stopped after a save and started again ends bit-equal to one that
was never stopped.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import time
from typing import Callable, Optional

import torch

from nonrigid_nerf_torch.checkpoints import (latest_checkpoint,
                                             load_train_state,
                                             save_checkpoint)
from nonrigid_nerf_torch.config import ModelConfig, RenderSettings, TrainConfig
from nonrigid_nerf_torch.data.dataset import RayDataset
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.engine.train_state import (TrainState,
                                                    create_train_state)
from nonrigid_nerf_torch.engine.train_step import (make_prefetch_train_step,
                                                   make_train_step,
                                                   step_generator)
from nonrigid_nerf_torch.parallel import multihost
from nonrigid_nerf_torch.parallel.mesh import make_parallel_train_step

ARCHIVE_EVERY = 50000
PROFILE_AFTER = 50      # steps of warm-up before a profile window


def resolve_sampling_prefetch(n_prefetch: int) -> int:
    """The batches a presampled window holds: N > 1 as given; 0, 1 and -1
    run the plain step. The JAX CLI's -1 presamples 64 steps a window on
    an image stack of 256 MB or more (train.py:268-273); the presampled
    step is bit-equal to the plain one and was slower on an H100 on such a
    stack (PERF.md section 6), so here -1 keeps the plain step."""
    return n_prefetch if n_prefetch > 1 else 0


def initial_state(cfg: ModelConfig, tc: TrainConfig, num_timesteps: int,
                  logdir: str, device: DeviceLike = None,
                  no_reload: bool = False,
                  ft_path: Optional[str] = None) -> TrainState:
    """The state a run starts from: `ft_path`, else the newest checkpoint of
    `logdir`, else a fresh state from tc.seed; `no_reload` always starts
    afresh (reference auto-resume: train.py:666-694)."""
    device = resolve_device(device)
    ckpt_path = None if no_reload else (ft_path or latest_checkpoint(logdir))
    if ckpt_path is not None and os.path.exists(ckpt_path):
        print("Reloading from", ckpt_path, flush=True)
        return load_train_state(ckpt_path, cfg, device=device)[0]
    return create_train_state(cfg, tc, num_timesteps, device=device)


def _append_row(path: Optional[str], row: dict) -> None:
    if path is not None:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")


def train(cfg: ModelConfig, tc: TrainConfig, rs: RenderSettings,
          ds: RayDataset, logdir: str, device: DeviceLike = None,
          i_print: int = 100, i_weights: int = 1000, no_reload: bool = False,
          extras: Optional[dict] = None, debug_metrics: bool = False,
          max_steps: Optional[int] = None,
          state: Optional[TrainState] = None, die_at_step: int = 0,
          on_step: Optional[Callable[[int, TrainState], None]] = None,
          profile_steps: int = 0, metrics_file: bool = True,
          sampling_prefetch: int = 0) -> TrainState:
    """Train on `ds` to step `tc.N_iters` (or for at most `max_steps` steps
    of this call) on `device` (cuda unless asked otherwise) and return the
    state. `state` is the state to start from (else `initial_state`).
    `extras` goes into every checkpoint beside near and far.
    `sampling_prefetch` > 1 runs the presampled step on a single process
    (`make_prefetch_train_step`): a window of that many steps' pixels is
    drawn whenever state.step leaves the last window; the data-parallel step
    keeps the plain sampling, as the JAX CLI's does."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "training needs full-f32 matrix products outside the kernels "
            "(the bending network, the f32 reference path); set "
            "torch.backends.cuda.matmul.allow_tf32 = False (PyTorch's default)")
    if ds.images.device.type != device.type:
        raise ValueError(f"the dataset is on {ds.images.device}, training on "
                         f"{device}")
    os.makedirs(logdir, exist_ok=True)
    ckpt_extras = {"near": ds.near, "far": ds.far, **(extras or {})}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    if state is None:
        state = initial_state(cfg, tc, ds.num_timesteps, logdir, device,
                              no_reload=no_reload)
    world = multihost.world_size()
    main = multihost.is_main()
    if world > 1:
        multihost.replicate(state.model)
        step_fn = make_parallel_train_step(
            cfg, tc, rs, has_test_split=ds.has_test_split,
            debug_metrics=debug_metrics)
    elif sampling_prefetch > 1:
        presample_fn, batch_step_fn = make_prefetch_train_step(
            cfg, tc, rs, has_test_split=ds.has_test_split,
            n_prefetch=sampling_prefetch, debug_metrics=debug_metrics)
        print(f"presampled training: {sampling_prefetch} batches per stack "
              "pass", flush=True)
        window = {"step0": None, "batches": None}

        def step_fn(state, ds, generator):
            # the presampled batches carry their own generators; the window
            # follows the state's own step count
            s = state.step
            if window["step0"] is None or not (
                    window["step0"] <= s < window["step0"] + sampling_prefetch):
                window["step0"] = s
                window["batches"] = presample_fn(ds, tc.seed, s)
            return batch_step_fn(state, window["batches"], s - window["step0"])
    else:
        step_fn = make_train_step(cfg, tc, rs,
                                  has_test_split=ds.has_test_split,
                                  debug_metrics=debug_metrics)

    start = state.step
    stop = tc.N_iters if max_steps is None else min(tc.N_iters,
                                                    start + max_steps)
    print(f"Begin training at step {start} -> {stop}", flush=True)
    metrics_path = os.path.join(logdir, "metrics.jsonl") \
        if metrics_file and main else None
    latest = os.path.join(logdir, "latest.npz")
    profiler = None
    metrics = None
    t0 = time.time()
    for i in range(start + 1, stop + 1):
        if profile_steps and i == start + PROFILE_AFTER:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        metrics = step_fn(state, ds, step_generator(tc.seed, i - 1, device))
        if profiler is not None and i == start + PROFILE_AFTER + profile_steps:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
            profile_dir = os.path.join(logdir, "profile")
            os.makedirs(profile_dir, exist_ok=True)
            suffix = "" if main else f"_rank{multihost.rank()}"
            trace = os.path.join(profile_dir, f"steps_{start + PROFILE_AFTER}"
                                 f"_{i}{suffix}.json")
            profiler.export_chrome_trace(trace)
            print("wrote torch.profiler trace to", trace, flush=True)
            profiler = None

        if i % i_print == 0 and main:
            m = {k: float(v) for k, v in metrics.items()}   # waits for the device
            dt = time.time() - t0
            t0 = time.time()
            parts = [f"[TRAIN] Iter: {i}", f"Loss: {m['loss']:.5f}",
                     f"PSNR: {m['psnr']:.2f}"]
            for key, label, fmt in (("img_loss0", "coarse", ".5f"),
                                    ("offsets_loss", "offsets", ".6f"),
                                    ("divergence_loss", "div", ".6f"),
                                    ("grad_norm", "|grad|", ".5f")):
                if key in m:
                    parts.append(f"{label}: {m[key]:{fmt}}")
            parts.append(f"({i_print / dt:.1f} it/s)")
            print(" ".join(parts), flush=True)
            _append_row(metrics_path, {"step": i, "it_per_sec": i_print / dt,
                                       **{k: round(v, 8) for k, v in m.items()}})

        if (i % i_weights == 0 or i == stop) and main:
            save_checkpoint(latest, i, state.model, (state.mu, state.nu),
                            ckpt_extras)
            if i % ARCHIVE_EVERY == 0:
                shutil.copyfile(latest, os.path.join(logdir, f"{i:06d}.npz"))
            print("Saved checkpoint at", latest, flush=True)
        if i % i_weights == 0 or i == stop:
            multihost.barrier()     # no rank passes a save unfinished

        if on_step is not None:
            on_step(i, state)

        if die_at_step and i == die_at_step and start == 0:
            # fault injection: die without any cleanup, as a preemption
            # would. Only a fresh run fires: a resumed run passing the step
            # again must not die again, or it could never finish. Every
            # rank dies, after the barrier that follows a save.
            multihost.barrier()
            print(f"[FAULT-INJECTION] SIGKILL at step {i}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    if metrics is not None and main:
        print(f"training done at step {state.step}; final loss "
              f"{float(metrics['loss']):.5f}", flush=True)
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            print(f"peak device memory: {peak / 2**30:.2f} GiB (allocated now: "
                  f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB)",
                  flush=True)
            _append_row(metrics_path, {"step": state.step,
                                       "peak_device_bytes": int(peak)})
    return state
