"""The training loop
(counterpart of the loop in the JAX package's train.py:231-243,332-434,
without the data loader, the command line, the volume probe, validation
images, videos and multi-device training).

`train` creates the train state or resumes it from the newest checkpoint of
`logdir`, steps to `tc.N_iters`, prints the `[TRAIN]` line and appends to
`<logdir>/metrics.jsonl` every `i_print` steps, and saves `latest.npz`
every `i_weights` steps (a numbered archive every 50,000).

Resume is exact: the random numbers of step k come from a generator seeded
with (tc.seed, k), never from state that a restart would lose, so a run
that is stopped after a save and started again ends bit-equal to one that
was never stopped.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import torch

from nonrigid_nerf_torch.checkpoints import (latest_checkpoint,
                                             load_train_state,
                                             save_checkpoint)
from nonrigid_nerf_torch.config import ModelConfig, RenderSettings, TrainConfig
from nonrigid_nerf_torch.data.dataset import RayDataset
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.engine.train_state import (TrainState,
                                                    create_train_state)
from nonrigid_nerf_torch.engine.train_step import make_train_step

ARCHIVE_EVERY = 50000


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws (pixels, jitter, noise, probe): a
    function of (seed, step) only."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def train(cfg: ModelConfig, tc: TrainConfig, rs: RenderSettings,
          ds: RayDataset, logdir: str, device: DeviceLike = None,
          i_print: int = 100, i_weights: int = 1000, no_reload: bool = False,
          extras: Optional[dict] = None, debug_metrics: bool = False,
          max_steps: Optional[int] = None) -> TrainState:
    """Train on `ds` to step `tc.N_iters` (or for at most `max_steps` steps
    of this call) on `device` (cuda unless asked otherwise) and return the
    state. `extras` goes into every checkpoint beside near and far."""
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

    ckpt_path = None if no_reload else latest_checkpoint(logdir)
    if ckpt_path is not None:
        state, _ = load_train_state(ckpt_path, cfg, device=device)
        print("Reloading from", ckpt_path, flush=True)
    else:
        state = create_train_state(cfg, tc, ds.num_timesteps, device=device)
    step_fn = make_train_step(cfg, tc, rs, has_test_split=ds.has_test_split,
                              debug_metrics=debug_metrics)

    start = state.step
    stop = tc.N_iters if max_steps is None else min(tc.N_iters,
                                                    start + max_steps)
    print(f"Begin training at step {start} -> {stop}", flush=True)
    metrics_path = os.path.join(logdir, "metrics.jsonl")
    t0 = time.time()
    for i in range(start + 1, stop + 1):
        metrics = step_fn(state, ds, step_generator(tc.seed, i - 1, device))

        if i % i_print == 0:
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
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps(
                    {"step": i, "it_per_sec": i_print / dt,
                     **{k: round(v, 8) for k, v in m.items()}}) + "\n")

        if i % i_weights == 0:
            latest = os.path.join(logdir, "latest.npz")
            save_checkpoint(latest, i, state.model, (state.mu, state.nu),
                            ckpt_extras)
            if i % ARCHIVE_EVERY == 0:
                shutil.copyfile(latest, os.path.join(logdir, f"{i:06d}.npz"))
            print("Saved checkpoint at", latest, flush=True)
    return state
