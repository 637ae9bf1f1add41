"""The training step's rate against the size of the image stack
(counterpart of the JAX package's tools/scale_bisect.py).

    python3 -m nonrigid_nerf_torch.cli.scale_bisect [--iters 200]
        [--device cuda]

Times the port's train step against synthetic device-resident stacks of
86 x 384 x 512 (the bench's) and 900 x 720 x 1280 (data_r5/scale300's,
2.49 GB), the model, losses, optimizer and N_rand identical in every cell;
only the stack's shape and the pixel gather vary. The gather is swapped
inside this tool only (`data/dataset.py` is not touched): the port's flat
row gather with the int64 `linear_pixel_index` (what `sample_ray_batch`
does) against 4-D advanced indexing `images[ids, y, x]`. Cells per stack:

- `sample[flat_rows]`, `sample[4d]`: the pixel draw and ray batch alone;
- `step[flat_rows]`: the port's step (`make_train_step`);
- `step[4d]`: the same step body (`train_step_from_batch`) on a batch
  gathered with 4-D indexing;
- `batch_only[stack resident]`: the step body on one fixed batch with the
  stack still on the device, then `batch_only[stack freed]` with it freed.

Each cell is ms a call, timed with CUDA events over `--iters` calls after a
warm-up (host clock on the CPU, and it says so). Prints a line a cell and
last one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nonrigid_nerf_torch.device import resolve_device

STACKS = ((86, 384, 512), (900, 720, 1280))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def make_ds(n: int, h: int, w: int, device):
    """A stack of random bytes (one random block of up to 8 frames tiled
    across the stack, as the JAX tool builds it: real bytes, not zeros),
    cameras stepping along z, one timestep per frame."""
    from nonrigid_nerf_torch.data import (build_ray_dataset,
                                          get_multi_view_mappings)
    rng = np.random.RandomState(0)
    block = rng.randint(0, 256, (min(n, 8), h, w, 3)).astype(np.uint8)
    reps = -(-n // block.shape[0])
    images = np.tile(block, (reps, 1, 1, 1))[:n]
    poses = np.tile(np.eye(4)[:3][None], (n, 1, 1)).astype(np.float32)
    poses[:, 2, 3] = np.linspace(0.0, 0.5, n)
    extras = get_multi_view_mappings(n, "/nonexistent")
    intrinsics = {i: {"height": h, "width": w, "focal_x": w * 0.9,
                      "focal_y": w * 0.9, "center_x": w / 2,
                      "center_y": h / 2, "ray_bending_latent_size": 32}
                  for i in range(n)}
    return build_ray_dataset(images, poses, intrinsics, extras,
                             i_train=np.arange(n),
                             i_test=np.array([], dtype=np.int64),
                             near=1.0, far=6.0, device=device)


def sample_4d(ds, n_rand: int, generator):
    """`sample_ray_batch`'s batch with the pixels gathered by 4-D advanced
    indexing in place of the flat row gather (the same draws, the same
    rays)."""
    from nonrigid_nerf_torch.data.dataset import draw_pixels, sample_ray_batch
    image_ids, x, y = draw_pixels(ds, n_rand, generator)
    batch = sample_ray_batch(ds, n_rand, image_ids=image_ids, x=x, y=y)
    batch["target_rgb"] = ds.images[image_ids, y, x].to(torch.float32) / 255.0
    return batch


def run_scale_bisect(iters: int, device=None, stacks=STACKS, cfg=None,
                     tc=None) -> dict:
    from nonrigid_nerf_torch.cli.bench import (card_name_and_power_limit,
                                               flagship_train_config)
    from nonrigid_nerf_torch.cli.gather_microbench import time_ms
    from nonrigid_nerf_torch.config import ModelConfig, RenderSettings
    from nonrigid_nerf_torch.data.dataset import sample_ray_batch
    from nonrigid_nerf_torch.engine.train_state import create_train_state
    from nonrigid_nerf_torch.engine.train_step import (make_train_step,
                                                       step_generator,
                                                       train_step_from_batch)

    device = resolve_device(device)
    name, power_limit = card_name_and_power_limit(device)
    log(f"device: {name}, {power_limit} W; timed with "
        + ("CUDA events" if device.type == "cuda" else "the host clock (CPU)"))
    cfg = cfg or ModelConfig()
    # the JAX tool's weights for this bisection
    tc = tc or dataclasses.replace(
        flagship_train_config(), offsets_loss_weight=3.0,
        divergence_loss_weight=0.3, N_iters=100000)
    rs = RenderSettings(N_samples=cfg.N_samples, N_importance=cfg.N_importance,
                        near=1.0, far=6.0, raw_noise_std=1.0)
    step_fn = make_train_step(cfg, tc, rs, has_test_split=False)
    kw = dict(cfg=cfg, tc=tc, rs=rs, has_test_split=False, n_rand=tc.N_rand)
    out = {"device": name, "power_limit_w": power_limit, "cells": {}}

    for (n, h, w) in stacks:
        label = f"{n}x{h}x{w}"
        log(f"building the {label} stack on the device...")
        ds = make_ds(n, h, w, device)
        cells = out["cells"][label] = {
            "stack_bytes": ds.images.numel() * ds.images.element_size()}
        state = create_train_state(cfg, tc, ds.num_timesteps, device=device)

        def gen():
            return step_generator(1, state.step, device)

        def cell(key, fn):
            cells[key] = time_ms(fn, device, iters)
            log(f"  {key}: {cells[key]:.3f} ms ({1000.0 / cells[key]:.1f} "
                "a second)")

        cell("sample[flat_rows]",
             lambda: sample_ray_batch(ds, tc.N_rand, generator=gen()))
        cell("sample[4d]", lambda: sample_4d(ds, tc.N_rand, gen()))
        cell("step[flat_rows]", lambda: step_fn(state, ds, gen()))

        def step_4d():
            g = gen()
            return train_step_from_batch(state, sample_4d(ds, tc.N_rand, g),
                                         generator=g, **kw)

        cell("step[4d]", step_4d)
        fixed = sample_ray_batch(ds, tc.N_rand, generator=gen())
        cell("batch_only[stack resident]",
             lambda: train_step_from_batch(state, fixed, generator=gen(), **kw))
        del ds
        if device.type == "cuda":
            torch.cuda.empty_cache()
        cell("batch_only[stack freed]",
             lambda: train_step_from_batch(state, fixed, generator=gen(), **kw))
        del state, fixed
    log("done")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--device", default=None,
                   help="where to run: cuda (the default) or cpu")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run_scale_bisect(args.iters, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
