"""Training throughput and MFU against the ray batch size (N_rand)
(counterpart of the JAX package's tools/batch_scaling.py).

    python3 -m nonrigid_nerf_torch.cli.batch_scaling \\
        [--batches 1024,2048,4096,8192,16384] [--steps 200] [--out FILE] \\
        [--datadir DIR] [--device cuda]

The flagship step (8 x 256 coarse + fine, bending + rigidity, the full
NR-NeRF losses) at each batch size, on the bench's data
(`cli/bench.py:build_dataset`), with the bench's windows protocol (value =
fastest window, steadiness = best / second-best) and FLOP count. Batches of
8192 rays and more take half the steps a window. Past 2^18 points a
backward runs in pieces (`ops/kernels/pieces.py`): N_rand 16384 is 2^21
fine points, 8 pieces. Prints one JSON row per batch as it is measured,
with the peak device memory on a line of its own before it, then the
result; `--out` also writes the result to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import torch

from nonrigid_nerf_torch.device import DeviceLike, resolve_device

BATCHES = "1024,2048,4096,8192,16384"
CONFIG = ("flagship (8x256 coarse+fine, bending+rigidity, full NR-NeRF "
          "losses, %s)")


def run_batch_scaling(cfg, ds, batches: Sequence[int], steps: int, *,
                      device: DeviceLike = None,
                      windows: Sequence[int] = (2, 6), warmup: int = 5,
                      data: str = "synthetic 86x384x512 stack") -> dict:
    """One row per batch size (the JAX tool's keys), and the result."""
    from nonrigid_nerf_torch.cli.bench import (STEP_SEED,
                                               card_name_and_power_limit,
                                               flagship_train_config,
                                               steady_windows)
    from nonrigid_nerf_torch.config import RenderSettings
    from nonrigid_nerf_torch.engine.train_state import create_train_state
    from nonrigid_nerf_torch.engine.train_step import (make_train_step,
                                                       step_generator)
    from nonrigid_nerf_torch.utils.flops import (device_bf16_peak_tflops,
                                                 train_flops_per_ray)

    device = resolve_device(device)
    name, power_limit = card_name_and_power_limit(device)
    rs = RenderSettings(N_samples=cfg.N_samples, N_importance=cfg.N_importance,
                        near=ds.near, far=ds.far, raw_noise_std=1.0)
    peak = device_bf16_peak_tflops(device)
    flops_per_ray = train_flops_per_ray(cfg, divergence_weight=3.0)

    rows = []
    for n_rand in batches:
        tc = dataclasses.replace(flagship_train_config(), N_rand=n_rand)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        state = create_train_state(cfg, tc, ds.num_timesteps, device=device)
        step_fn = make_train_step(cfg, tc, rs, has_test_split=False)

        def step():
            return step_fn(state, ds,
                           step_generator(STEP_SEED, state.step, device))

        float(step()["loss"])
        for _ in range(warmup):
            metrics = step()
        if warmup:
            float(metrics["loss"])
        n_steps = steps if n_rand < 8192 else steps // 2

        def run_window():
            t0 = time.perf_counter()
            for _ in range(n_steps):
                metrics = step()
            float(metrics["loss"])
            return n_rand * n_steps / (time.perf_counter() - t0)

        rays_per_sec, steadiness, win = steady_windows(run_window, *windows)
        tflops = rays_per_sec * flops_per_ray / 1e12
        if device.type == "cuda":
            print(f"N_rand {n_rand}: peak device memory "
                  f"{torch.cuda.max_memory_allocated(device)} B; {name}, "
                  f"{power_limit} W", flush=True)
        row = {
            "N_rand": n_rand,
            "train_rays_per_sec": rays_per_sec,
            "steps_per_sec": rays_per_sec / n_rand,
            "model_tflops_per_sec": tflops,
            "mfu_vs_bf16_peak": tflops / peak if peak else None,
            "steadiness": steadiness,
            "windows": win,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        del state, step_fn

    return {"device": name, "power_limit_w": power_limit,
            "bf16_peak_tflops": peak,
            "model_flops_per_train_ray": flops_per_ray,
            "config": CONFIG % data, "rows": rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from nonrigid_nerf_torch.cli.bench import build_dataset
    from nonrigid_nerf_torch.config import ModelConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default=BATCHES)
    ap.add_argument("--steps", type=int, default=200,
                    help="steps per timed window (halved for batches >= "
                         "8192 to keep windows comparable)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--datadir", default=None,
                    help="an LLFF scene (default: the bench's synthetic "
                         "86 x 384 x 512 stack)")
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = build_dataset(args.datadir, device)
    result = run_batch_scaling(
        ModelConfig(), ds, [int(b) for b in args.batches.split(",")],
        args.steps, device=device,
        data=args.datadir or "synthetic 86x384x512 stack")
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
