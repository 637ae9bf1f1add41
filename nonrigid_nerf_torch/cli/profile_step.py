"""Decompose the training step's time into its stages
(counterpart of the JAX package's tools/profile_step.py).

    python3 -m nonrigid_nerf_torch.cli.profile_step [--iters 50]
        [--warmup 5] [--rays 1024] [--device cuda]

Times, on the reference step's workload (1024 rays x (64 + 128) samples,
196,608 points), for `fused_kernel` "auto" (the CUDA kernels) and "off"
(the plain f32 MLP): the forward-only point query of both networks
(`query_fwd`), its forward and backward (`query_fwdbwd`), the renderer's
forward (`render_fwd`), and the full train step (`train_step`) on the
8 x 48 x 64 synthetic stack; then the kernel pieces at 196,608 points:
`mlp_fwd` (`mlp_kernel_fwd`), `MLPCore` forward and backward
(`mlp_kernel_fwdbwd`), the f32 `NeRF` module forward and backward
(`mlp_xla_fwd`, `mlp_xla_fwdbwd`: the plain path, under the JAX tool's
names so that the two tools' lines compare) and stage 1 alone
(`bend_encode_stage`, `bend_encode_xla`).

Each stage is timed per iteration after `--warmup` iterations: with CUDA
events on a GPU, on the host clock on the CPU (and then says so). It prints
the mean and the median of each, the device ms of a full step under
torch.profiler (CUDA kernels only) beside its time so that the host's share
shows, and last one JSON line of everything.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nonrigid_nerf_torch.device import resolve_device

S_COARSE, S_FINE = 64, 128
MODES = ("auto", "off")


def time_iters(fn, device: torch.device, iters: int, warmup: int):
    """Milliseconds of each of `iters` calls of fn() after `warmup` calls:
    CUDA events around each call on a GPU, the host clock around each call
    on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(device)
        times = [start.elapsed_time(end) for start, end in events]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def profiled_device_ms(fn, device: torch.device, iters: int):
    """(wall ms, device ms) a call of fn() over `iters` calls under
    torch.profiler, the device time summed over CUDA kernels only (a CPU
    op's entry repeats its kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return wall_ms, busy_us / 1e3 / iters


def run_profile(rays: int = 1024, iters: int = 50, warmup: int = 5,
                device=None) -> dict:
    """Every stage's per-iteration milliseconds (mean, median) and the full
    step's device ms by mode; see the module docstring."""
    from nonrigid_nerf_torch.cli.bench import (STEP_SEED,
                                               card_name_and_power_limit,
                                               flagship_train_config,
                                               synthetic_dataset)
    from nonrigid_nerf_torch.config import ModelConfig, RenderSettings
    from nonrigid_nerf_torch.engine.query import (bend_encode_stage,
                                                  query_points)
    from nonrigid_nerf_torch.engine.render import render_rays
    from nonrigid_nerf_torch.engine.train_state import create_train_state
    from nonrigid_nerf_torch.engine.train_step import (make_train_step,
                                                       step_generator)
    from nonrigid_nerf_torch.ops.embedding import fourier_embed
    from nonrigid_nerf_torch.ops.kernels.mlp_bwd import MLPCore
    from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (cast_mlp_weights,
                                                         mlp_fwd,
                                                         pack_mlp_weights)

    device = resolve_device(device)
    name, power_limit = card_name_and_power_limit(device)
    R = rays
    cfg = ModelConfig()
    tc = dataclasses.replace(flagship_train_config(), N_rand=R)
    rs = RenderSettings(near=1.0, far=6.0, raw_noise_std=1.0)
    state = create_train_state(cfg, tc, 8, device=device)
    model = state.model
    rng = np.random.RandomState(0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    rays_o = dev(rng.randn(R, 3))
    rays_d = dev(rng.randn(R, 3) * 0.05 + np.array([0, 0, -1.0]))
    latents = torch.zeros((R, cfg.ray_bending_latent_size), device=device)
    pts_c = dev(rng.randn(R, S_COARSE, 3))
    pts_f = dev(rng.randn(R, S_FINE, 3))
    params = [p for p in model.parameters()]
    ds = synthetic_dataset(8, 48, 64, device=device)
    results = {}
    clock = "CUDA events" if device.type == "cuda" else "host clock (CPU)"

    def record(key, fn, n=iters):
        times = time_iters(fn, device, n, warmup)
        results[key] = {"mean_ms": statistics.fmean(times),
                        "median_ms": statistics.median(times)}

    step_device = {}
    for mode in MODES:
        c = dataclasses.replace(cfg, fused_kernel=mode)

        def fwd_query(c=c):
            raw_c = query_points(model, c, pts_c, None, latents,
                                 network="coarse")
            raw_f = query_points(model, c, pts_f, None, latents,
                                 network="fine")
            return raw_c, raw_f

        def query_fwd():
            with torch.no_grad():
                return fwd_query()

        def query_fwdbwd():
            raw_c, raw_f = fwd_query()
            loss = torch.sum(raw_c ** 2) + torch.sum(raw_f ** 2)
            return torch.autograd.grad(loss, params, allow_unused=True)

        gen = torch.Generator(device=device).manual_seed(STEP_SEED)

        def render_fwd(c=c, gen=gen):
            with torch.no_grad():
                return render_rays(model, c, rs, rays_o, rays_d, latents,
                                   generator=gen, detailed=True)["rgb_map"]

        record(f"query_fwd[{mode}]", query_fwd)
        record(f"query_fwdbwd[{mode}]", query_fwdbwd)
        record(f"render_fwd[{mode}]", render_fwd)

        st = create_train_state(c, tc, ds.num_timesteps, device=device)
        step_fn = make_train_step(c, tc, rs, has_test_split=False)

        def run_step(st=st, step_fn=step_fn):
            return step_fn(st, ds, step_generator(STEP_SEED, st.step, device))

        record(f"train_step[{mode}]", run_step, 2 * iters)
        if device.type == "cuda":
            wall_ms, dev_ms = profiled_device_ms(run_step, device,
                                                 max(1, min(iters, 10)))
            step_device[mode] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                                 "host_share": 1.0 - dev_ms / wall_ms}

    # the stage pieces at R x (64 + 128) points
    n = R * (S_COARSE + S_FINE)
    emb = dev(rng.randn(n, 64))
    packed = tuple(w.detach() for w in pack_mlp_weights(model.coarse))
    mw = cast_mlp_weights(packed)
    emb_b = emb.to(torch.bfloat16)

    def kernel_fwdbwd():
        e = emb.clone().requires_grad_(True)
        ws = [w.clone().requires_grad_(True) for w in packed]
        out = MLPCore.apply(e, *ws)
        return torch.autograd.grad(out.sum(), [e] + ws)

    record("mlp_kernel_fwd(196k)", lambda: mlp_fwd(emb_b, mw))
    record("mlp_kernel_fwdbwd(196k)", kernel_fwdbwd)

    emb63 = emb[:, :63].reshape(R, S_COARSE + S_FINE, 63)
    coarse_params = list(model.coarse.parameters())

    def xla_fwd():
        with torch.no_grad():
            return model.coarse(emb63)

    def xla_fwdbwd():
        return torch.autograd.grad(model.coarse(emb63).sum(), coarse_params)

    record("mlp_xla_fwd(196k)", xla_fwd)
    record("mlp_xla_fwdbwd(196k)", xla_fwdbwd)

    pts_all = dev(rng.randn(R, S_COARSE + S_FINE, 3))

    def bend_encode():
        with torch.no_grad():
            st1 = bend_encode_stage(model, cfg, pts_all, latents, embed=False,
                                    detailed=True)
            return (fourier_embed(st1["bent_pts"], cfg.multires),
                    st1["details"]["unmasked_offsets"])

    record("bend_encode_xla(196k)", bend_encode)
    return {"device": name, "power_limit_w": power_limit, "clock": clock,
            "points": n, "stages": results, "train_step_profile": step_device}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run_profile(args.rays, args.iters, args.warmup, args.device)
    print(f"device: {out['device']}, {out['power_limit_w']} W; "
          f"{out['points']} points; timed with {out['clock']}")
    for k, v in sorted(out["stages"].items()):
        print(f"{k:32s} {v['mean_ms']:8.3f} ms (median {v['median_ms']:.3f})")
    for mode, p in out["train_step_profile"].items():
        print(f"train_step[{mode}] under torch.profiler: {p['wall_ms']:.3f} "
              f"ms a step, device {p['device_ms']:.3f} ms, host share "
              f"{p['host_share']:.3f}")
    if not out["train_step_profile"]:
        print("train_step device ms: not measured (no CUDA device)")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
